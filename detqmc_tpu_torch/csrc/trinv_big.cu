// K9: blocked upper-triangular inverse applied to a right-hand side,
// X <- R^{-1} X for batched n x n R and X in global memory.
//
// Replaces the TPU kernel detqmc_tpu/linalg/pallas_trinv_common.py
// (call_batched, kernel body _kernel), which the JAX package reaches
// through pallas_ctrinv.py (ctrinv_big, complex) and pallas_trinv.py
// (trinv_big, real). There X starts as the identity, so X ends as R^{-1};
// K8 (green_solve_big.cu) hands it Q^H M instead, so the inner solve's
// back-substitution is this kernel. Same blocked schedule as the TPU
// kernel (pallas_trinv_common.py:13-24), per panel of b columns
// [j0, j0 + jb), descending:
//   1. in-panel column steps, j descending:
//          X[j, :] *= 1 / R_jj;   X[j0:j, :] -= R[j0:j, j] X[j, :]
//   2. the panel's effect on every row above it, one product:
//          X[0:j0, :] -= R[0:j0, panel] X[panel, :]
// The columns of X are independent, so one CTA takes one tile of tc
// columns of one matrix (grid = batch x ceil(n / tc)); the tile (n x tc)
// stays in shared memory from the first panel to the last. Only R's upper
// triangle (diagonal included) is read; an exactly zero R_jj takes the TPU
// kernel's guarded reciprocal (_recip: 1 in the real, 0 in the complex
// case).
//
// What bounds it on the H100 (NVIDIA H100 80GB HBM3, 700 W): n^3 / 2
// multiply-adds per matrix with n right-hand sides, 0.13 ms for 128
// complex128 matrices at n = 256 on the FP64 tensor cores. The first
// design took 2.04 ms there (cuBLAS's trsm 0.99 ms): step 2 was one
// output per thread with two shared-memory loads per multiply-add, and
// every one of the 16 CTAs of a matrix (tc = 16) restaged R's panels from
// L2 synchronously, one 205 KB CTA per SM. This design:
//   - step 2 as a register-tiled product: mma.sync m8n8k4 on the FP64
//     tensor cores for float64 and complex128 (four real products), each
//     warp's output fragments in registers through the k-loop; a 4 x 2
//     block per thread on the CUDA cores for float32 and complex64;
//   - R's next panel copied by cp.async into a second buffer while the
//     current panel is solved (nbuf = 2), when shared memory allows;
//   - tiles up to 32 columns wide (fewer copies of R per matrix);
//   - two CTAs per SM (<= 113 KB each) when the grid has more CTAs than
//     the card has SMs (linalg/trinv.py plan);
//   - step 1 keeps the warp-shuffle chain: one warp per column, lane r
//     holding row j0 + r and 1 / R_rr (read from the staged panel), the
//     warp's tc / 8 columns interleaved, selects instead of branches.
// complex128 at B = 128, n = 256 then takes 1.24-1.29 ms (cuBLAS's trsm
// 0.95-1.01; solve_timing.py). No single phase bounds it: the plans
// (panel and tile widths, one or two panel buffers, one or two CTAs per
// SM) time within 10 % of each other, and taking the diagonal's global
// loads and the branches out of step 1 moved nothing. The work left is
// spread over step 1's chain (n dependent steps per column), step 2's
// short products (k = b, so each fragment is loaded and stored once per
// panel) and R's upper triangle restaged by every CTA (512 KB each).
#include <type_traits>

#include "tc_blocked.cuh"

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

// shared memory: X np x (tc + pad), nbuf panels np x (b + pad); mirrored
// by linalg/trinv.py smem_bytes
template <typename S>
size_t trinv_smem_bytes(int n, int b, int tc, int nbuf) {
    const size_t np = round_up(n, 8), pad = pad_of<S>::value;
    return sizeof(S) * (np * (tc + pad) + nbuf * np * (b + pad));
}

// step 2 on the tensor cores: X[0:j0, :] += (-P[0:j0, 0:kw]) X[j0:j0+kw, :],
// row fragments warp, warp + 8, ...; kw a multiple of 4 (P zero beyond jb)
template <typename S, int TC>
__device__ void panel_above_tc(S* X, const S* P, int ldp, int j0, int kw) {
    constexpr int LDX = TC + pad_of<S>::value, CF = TC / 8;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, q = lane & 3;
    for (int f = warp; f < j0 / 8; f += kWarps) {
        const int r0 = 8 * f;
        Acc<S> acc[CF];
#pragma unroll
        for (int cf = 0; cf < CF; ++cf) {
            acc[cf].c[0] = X[(r0 + g) * LDX + 8 * cf + 2 * q];
            acc[cf].c[1] = X[(r0 + g) * LDX + 8 * cf + 2 * q + 1];
        }
        for (int k = 0; k < kw; k += 4) {
            const S a = -P[(r0 + g) * ldp + k + q];
#pragma unroll
            for (int cf = 0; cf < CF; ++cf)
                mma_acc(acc[cf], a, X[(j0 + k + q) * LDX + 8 * cf + g]);
        }
#pragma unroll
        for (int cf = 0; cf < CF; ++cf) {
            X[(r0 + g) * LDX + 8 * cf + 2 * q] = acc[cf].c[0];
            X[(r0 + g) * LDX + 8 * cf + 2 * q + 1] = acc[cf].c[1];
        }
    }
}

// step 2 on the CUDA cores: a 4 x 2 block of X per thread, its 8
// accumulators in registers through the k-loop
template <typename S, int TC>
__device__ void panel_above_fma(S* X, const S* P, int ldp, int j0, int jb) {
    constexpr int LDX = TC + pad_of<S>::value, NCB = TC / 2;
    const int nblk = (j0 / 4) * NCB;
    for (int blk = threadIdx.x; blk < nblk; blk += kThreads) {
        const int r0 = 4 * (blk / NCB), c = 2 * (blk % NCB);
        S acc[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            acc[i][0] = X[(r0 + i) * LDX + c];
            acc[i][1] = X[(r0 + i) * LDX + c + 1];
        }
        for (int k = 0; k < jb; ++k) {
            const S x0 = X[(j0 + k) * LDX + c], x1 = X[(j0 + k) * LDX + c + 1];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const S p = P[(r0 + i) * ldp + k];
                acc[i][0] -= p * x0;
                acc[i][1] -= p * x1;
            }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            X[(r0 + i) * LDX + c] = acc[i][0];
            X[(r0 + i) * LDX + c + 1] = acc[i][1];
        }
    }
}

template <typename S, int TC>
__global__ void __launch_bounds__(kThreads, 2)
trinv_big_kernel(const S* __restrict__ Rm, S* Xm, int n, int b, int nbuf) {
    using Rl = typename real_of<S>::type;
    constexpr int PAD = pad_of<S>::value, LDX = TC + PAD, CPW = TC / 8;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int np = round_up(n, 8), ldp = b + PAD;
    const int ntile = (n + TC - 1) / TC;
    const int mat = blockIdx.x / ntile;
    const int c0 = (blockIdx.x - mat * ntile) * TC, tw = min(TC, n - c0);
    const S zero = from_real<S>(Rl(0));
    S* X = reinterpret_cast<S*>(smem_raw);     // X[:, c0:c0+tw], zero beyond
    S* P = X + size_t(np) * LDX;               // nbuf x R[0:j0+jb, j0:j0+jb]
    const S* R = Rm + size_t(mat) * n * n;
    S* Xg = Xm + size_t(mat) * n * n;
    for (int idx = tid; idx < np * LDX; idx += kThreads) {
        const int r = idx / LDX, c = idx - r * LDX;
        if (r < n && c < tw) cp_async(X + idx, Xg + size_t(r) * n + c0 + c);
        else X[idx] = zero;
    }
    const int npanel = (n + b - 1) / b;
    // panel p (descending): j0 = (npanel - 1 - p) b; its rows 0..j0+jb of R's
    // columns j0..j0+jb, zero-padded to a multiple of 4 columns
    auto issue = [&](int p, int buf) {
        const int j0 = (npanel - 1 - p) * b, jb = min(b, n - j0);
        const int top = j0 + jb, jb4 = round_up(jb, 4);
        S* Pb = P + size_t(buf) * np * ldp;
        for (int idx = tid; idx < top * jb4; idx += kThreads) {
            const int r = idx / jb4, k = idx - r * jb4;
            if (k < jb) cp_async(Pb + r * ldp + k, R + size_t(r) * n + j0 + k);
            else Pb[r * ldp + k] = zero;
        }
        cp_async_commit();
    };
    issue(0, 0);
    for (int p = 0; p < npanel; ++p) {
        const int j0 = (npanel - 1 - p) * b, jb = min(b, n - j0);
        const int buf = nbuf == 2 ? (p & 1) : 0;
        if (nbuf == 1 && p > 0) {
            __syncthreads();   // every warp is done with panel p - 1
            issue(p, 0);
        }
        cp_async_wait_all();
        __syncthreads();       // panel p (and the tile) landed
        if (nbuf == 2 && p + 1 < npanel) issue(p + 1, (p + 1) & 1);
        const S* Pb = P + size_t(buf) * np * ldp;
        // 1. the panel's rows: warp w takes columns w, w + 8, ... together;
        //    lane r holds row j0 + r and 1 / R_rr, read from the staged
        //    panel; selects, not branches, so the chain has no divergence
        const int rr = min(lane, jb - 1);
        const S myinv = recip_guarded(Pb[(j0 + rr) * ldp + rr]);
        S x[CPW];
#pragma unroll
        for (int u = 0; u < CPW; ++u)
            x[u] = lane < jb ? X[(j0 + lane) * LDX + warp + 8 * u] : zero;
        for (int j = jb - 1; j >= 0; --j) {
            const S pj = Pb[(j0 + rr) * ldp + j];
#pragma unroll
            for (int u = 0; u < CPW; ++u) {
                x[u] = lane == j ? x[u] * myinv : x[u];
                const S xj = shfl(x[u], j);
                x[u] = lane < j ? x[u] - pj * xj : x[u];
            }
        }
        if (lane < jb) {
#pragma unroll
            for (int u = 0; u < CPW; ++u) X[(j0 + lane) * LDX + warp + 8 * u] = x[u];
        }
        __syncthreads();
        // 2. every row above the panel
        if constexpr (on_tensor_cores<S>())
            panel_above_tc<S, TC>(X, Pb, ldp, j0, round_up(jb, 4));
        else
            panel_above_fma<S, TC>(X, Pb, ldp, j0, jb);
    }
    __syncthreads();
    for (int idx = tid; idx < n * tw; idx += kThreads) {
        const int r = idx / tw, c = idx - r * tw;
        Xg[size_t(r) * n + c0 + c] = X[r * LDX + c];
    }
}

// the compiled tile widths: tc = 8, 16 or 32; b a multiple of 8 up to 32
template <typename S, typename F>
int with_trinv_kernel(int tc, F f) {
    if (tc == 8) return f(trinv_big_kernel<S, 8>);
    if (tc == 16) return f(trinv_big_kernel<S, 16>);
    return f(trinv_big_kernel<S, 32>);
}

inline bool trinv_plan_ok(int b, int tc, int nbuf) {
    return (tc == 8 || tc == 16 || tc == 32) && b >= 8 && b <= 32 && b % 8 == 0 &&
           (nbuf == 1 || nbuf == 2);
}

template <typename S>
int trinv_big(int device, const void* R, void* X, int batch, int n, int b, int tc,
              int nbuf, void* stream) {
    if (!trinv_plan_ok(b, tc, nbuf)) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = trinv_smem_bytes<S>(n, b, tc, nbuf);
    const int grid = batch * ((n + tc - 1) / tc);
    return with_trinv_kernel<S>(tc, [&](auto kernel) {
        return launch_tc(device, kernel, grid, smem, stream, static_cast<const S*>(R),
                         static_cast<S*>(X), n, b, nbuf);
    });
}

template <typename S>
int trinv_big_blocks(int device, int n, int b, int tc, int nbuf) {
    if (!trinv_plan_ok(b, tc, nbuf)) return -static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = trinv_smem_bytes<S>(n, b, tc, nbuf);
    return with_trinv_kernel<S>(
        tc, [&](auto kernel) { return blocks_per_sm(device, kernel, smem); });
}

}  // namespace dq

extern "C" {

int dq_trinv_big_f32(int device, const void* R, void* X, int batch, int n, int b,
                     int tc, int nbuf, void* stream) {
    return dq::trinv_big<float>(device, R, X, batch, n, b, tc, nbuf, stream);
}
int dq_trinv_big_f64(int device, const void* R, void* X, int batch, int n, int b,
                     int tc, int nbuf, void* stream) {
    return dq::trinv_big<double>(device, R, X, batch, n, b, tc, nbuf, stream);
}
int dq_trinv_big_c64(int device, const void* R, void* X, int batch, int n, int b,
                     int tc, int nbuf, void* stream) {
    return dq::trinv_big<dq::cplx<float>>(device, R, X, batch, n, b, tc, nbuf, stream);
}
int dq_trinv_big_c128(int device, const void* R, void* X, int batch, int n, int b,
                      int tc, int nbuf, void* stream) {
    return dq::trinv_big<dq::cplx<double>>(device, R, X, batch, n, b, tc, nbuf, stream);
}

// CTAs of K9 per SM at this plan (dtype: 0 float32, 1 float64, 2 complex64,
// 3 complex128), or -(cudaError)
int dq_trinv_big_blocks_per_sm(int device, int dtype, int n, int b, int tc, int nbuf) {
    switch (dtype) {
        case 0: return dq::trinv_big_blocks<float>(device, n, b, tc, nbuf);
        case 1: return dq::trinv_big_blocks<double>(device, n, b, tc, nbuf);
        case 2: return dq::trinv_big_blocks<dq::cplx<float>>(device, n, b, tc, nbuf);
        default: return dq::trinv_big_blocks<dq::cplx<double>>(device, n, b, tc, nbuf);
    }
}

}  // extern "C"
