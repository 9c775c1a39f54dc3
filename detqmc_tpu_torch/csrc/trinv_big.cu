// K9: blocked upper-triangular inverse applied to a right-hand side,
// X <- R^{-1} X for batched n x n R and X in global memory.
//
// Replaces the TPU kernel detqmc_tpu/linalg/pallas_trinv_common.py
// (call_batched, kernel body _kernel), which the JAX package reaches
// through pallas_ctrinv.py (ctrinv_big, complex) and pallas_trinv.py
// (trinv_big, real). There X starts as the identity, so X ends as R^{-1};
// K8 (green_solve_big.cu) hands it Q^H diag(r1) instead, so the inner
// solve's back-substitution is this kernel. Same blocked schedule as the
// TPU kernel (pallas_trinv_common.py:13-24), per panel of b columns
// [j0, j0 + jb), descending:
//   1. in-panel column steps, j descending:
//          X[j, :] *= 1 / R_jj;   X[j0:j, :] -= R[j0:j, j] X[j, :]
//   2. the panel's effect on every row above it, one product:
//          X[0:j0, :] -= R[0:j0, panel] X[panel, :]
// The columns of X are independent, so one CTA takes one tile of tc
// columns of one matrix (grid = batch x ceil(n / tc)): the tile (n x tc)
// and R's panel (rows 0..j0+jb, b columns, restaged per panel from L2)
// sit in shared memory. Step 1 goes one warp per column, lane r holding
// row j0 + r in a register, the solved value broadcast by __shfl_sync
// (so b <= 32), with the panel's b reciprocals formed beforehand, off the
// dependent chain; step 2 one thread per element of X[0:j0, tile], a
// b-term dot product over the staged panel. Only R's upper triangle
// (diagonal included) is read; an exactly zero R_jj takes the TPU
// kernel's guarded reciprocal (_recip: 1 in the real, 0 in the complex
// case). What bounds it on the H100: the dependent steps of step 1 and
// the shared-memory loads of step 2 (two operands per multiply-add), at
// one CTA per SM.
#include "common.cuh"

namespace dq {

__device__ __forceinline__ float shfl(float x, int src) {
    return __shfl_sync(0xffffffffu, x, src);
}
__device__ __forceinline__ double shfl(double x, int src) {
    return __shfl_sync(0xffffffffu, x, src);
}
template <typename T>
__device__ __forceinline__ cplx<T> shfl(cplx<T> x, int src) {
    return mk(shfl(x.re, src), shfl(x.im, src));
}

// 1 / a with a == 0 guarded as pallas_trinv_common.py _recip guards it
__device__ __forceinline__ float recip_guarded(float a) {
    return 1.0f / (a + (a == 0.0f ? 1.0f : 0.0f));
}
__device__ __forceinline__ double recip_guarded(double a) {
    return 1.0 / (a + (a == 0.0 ? 1.0 : 0.0));
}
template <typename T>
__device__ __forceinline__ cplx<T> recip_guarded(cplx<T> a) {
    const T a2 = abs2(a);
    const T ia2 = T(1) / (a2 + (a2 == T(0) ? T(1) : T(0)));
    return mk(a.re * ia2, -a.im * ia2);
}

template <typename S>
__global__ void __launch_bounds__(kThreads)
trinv_big_kernel(const S* __restrict__ Rm, S* Xm, int n, int b, int tc) {
    using Rl = typename real_of<S>::type;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int ntile = (n + tc - 1) / tc;
    const int mat = blockIdx.x / ntile;
    const int c0 = (blockIdx.x - mat * ntile) * tc, tw = min(tc, n - c0);
    const int ldp = b + 1, ldx = tc + 1;
    const S zero = from_real<S>(Rl(0));
    S* P = reinterpret_cast<S*>(smem_raw);      // R[0:j0+jb, j0:j0+jb]
    S* X = P + size_t(n) * ldp;                 // X[:, c0:c0+tw]
    S* inv = X + size_t(n) * ldx;               // 1 / R_jj of the panel
    const S* R = Rm + size_t(mat) * n * n;
    S* Xg = Xm + size_t(mat) * n * n;
    for (int idx = tid; idx < n * tw; idx += kThreads) {
        const int r = idx / tw, c = idx - r * tw;
        X[r * ldx + c] = Xg[size_t(r) * n + c0 + c];
    }
    for (int j0 = ((n - 1) / b) * b; j0 >= 0; j0 -= b) {
        const int jb = min(b, n - j0), top = j0 + jb;
        __syncthreads();   // the previous panel's reads of P are done
        for (int idx = tid; idx < top * jb; idx += kThreads) {
            const int r = idx / jb, k = idx - r * jb;
            P[r * ldp + k] = R[size_t(r) * n + j0 + k];
        }
        if (tid < jb) inv[tid] = recip_guarded(R[size_t(j0 + tid) * n + j0 + tid]);
        __syncthreads();
        // 1. the panel's rows
        for (int c = warp; c < tw; c += kWarps) {
            S x = lane < jb ? X[(j0 + lane) * ldx + c] : zero;
            for (int j = jb - 1; j >= 0; --j) {
                if (lane == j) x = x * inv[j];
                const S xj = shfl(x, j);
                if (lane < j) x -= P[(j0 + lane) * ldp + j] * xj;
            }
            if (lane < jb) X[(j0 + lane) * ldx + c] = x;
        }
        __syncthreads();
        // 2. every row above the panel
        for (int idx = tid; idx < j0 * tw; idx += kThreads) {
            const int r = idx / tw, c = idx - r * tw;
            S acc = X[r * ldx + c];
            for (int k = 0; k < jb; ++k) acc -= P[r * ldp + k] * X[(j0 + k) * ldx + c];
            X[r * ldx + c] = acc;
        }
    }
    __syncthreads();
    for (int idx = tid; idx < n * tw; idx += kThreads) {
        const int r = idx / tw, c = idx - r * tw;
        Xg[size_t(r) * n + c0 + c] = X[r * ldx + c];
    }
}

template <typename S>
int trinv_big(int device, const void* R, void* X, int batch, int n, int b, int tc,
              void* stream) {
    const size_t smem = sizeof(S) * (size_t(n) * (b + 1) + size_t(n) * (tc + 1) + b);
    return launch_smem(device, trinv_big_kernel<S>, batch * ((n + tc - 1) / tc), smem,
                       stream, static_cast<const S*>(R), static_cast<S*>(X), n, b, tc);
}

}  // namespace dq

extern "C" {

int dq_trinv_big_f32(int device, const void* R, void* X, int batch, int n, int b,
                     int tc, void* stream) {
    return dq::trinv_big<float>(device, R, X, batch, n, b, tc, stream);
}
int dq_trinv_big_f64(int device, const void* R, void* X, int batch, int n, int b,
                     int tc, void* stream) {
    return dq::trinv_big<double>(device, R, X, batch, n, b, tc, stream);
}
int dq_trinv_big_c64(int device, const void* R, void* X, int batch, int n, int b,
                     int tc, void* stream) {
    return dq::trinv_big<dq::cplx<float>>(device, R, X, batch, n, b, tc, stream);
}
int dq_trinv_big_c128(int device, const void* R, void* X, int batch, int n, int b,
                      int tc, void* stream) {
    return dq::trinv_big<dq::cplx<double>>(device, R, X, batch, n, b, tc, stream);
}

}  // extern "C"
