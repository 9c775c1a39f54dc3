// K3 / K3c: stabilized inner solve mid = inner^{-1} M, one CTA per matrix,
// in float64 (K3) or complex128 (K3c), with M = diag(r1) (the equal-time
// G) or a dense right-hand side (the _rhs entries, the unequal-time
// G(tau, 0) with M = d1min V1).
//
// Replaces the TPU kernels detqmc_tpu/linalg/pallas_green.py (solve_inner,
// the dispatcher) -> pallas_green_lanes.py (solve_inner_lanes, kernel body
// _kernel) for the real chain, and pallas_cgreen_lanes.py
// (solve_inner_complex, kernel body _kernel) for the complex SDW chain;
// the _rhs entries replace their dense-RHS twins, pallas_green_lanes.py
// (solve_inner_lanes_rhs) and pallas_cgreen_lanes.py
// (solve_inner_complex_rhs), the same kernel bodies with has_rhs.
// On the TPU the range-split inner matrix (condition ~1e6 at beta=8) is
// factored in df32 (hi, lo) f32 pairs, the complex one as four such
// planes, because the chip has no f64; the H100 has native f64 and
// complex128, so the inputs are plain f64 / complex128 and every
// intermediate stays in that type. Same algorithm (pallas_green.py:16-25,
// pallas_cgreen_lanes.py:19-23):
//   1. Householder QR of inner, each reflector also applied to M, so M
//      ends as Q^H M (householder_apply);
//   2. back-substitution X = R^{-1} M with R_jj = alpha_j, in place in M:
//      one thread per column of M walks j = n-1 .. 0, so no CTA barrier is
//      needed (each thread reads only the rows of its own column that it
//      has already solved). The complex division is M conj(a) / |a|^2.
// r1 is real in both cases; a dense RHS has inner's type. Shared memory:
// 2 n (n+1) values (66 KB at n=64 in f64, 133 KB in complex128). What
// bounds it: the n dependent reflector steps, then the n-deep
// back-substitution chain per column; a dense M costs the same as the
// diagonal one (the reflectors touch all n columns of M either way), and
// the design answers the latency chain with many matrices in flight (one
// CTA each) rather than with a faster single solve.
#include "common.cuh"

namespace dq {

// Steps 1 and 2 on A and M resident in shared memory, then M -> out.
template <typename S>
__device__ void solve_resident(S* A, S* M, S* v, S* s, S* __restrict__ out,
                               int n, int ld) {
    const int tid = threadIdx.x;
    householder_apply(A, M, v, s, n, ld);
    for (int c = tid; c < n; c += kThreads) {
        for (int j = n - 1; j >= 0; --j) {
            S acc = M[j * ld + c];
            for (int k = j + 1; k < n; ++k) acc -= A[j * ld + k] * M[k * ld + c];
            M[j * ld + c] = div_s(acc, A[j * ld + j]);
        }
    }
    __syncthreads();
    for (int idx = tid; idx < n * n; idx += kThreads) {
        const int r = idx / n, c = idx - r * n;
        out[idx] = M[r * ld + c];
    }
}

// Shared-memory layout: A and M (n x ld each), then v (n) and s (2n).
template <typename S>
struct SolveSmem {
    S *A, *M, *v, *s;
    __device__ SolveSmem(unsigned char* raw, int n) {
        A = reinterpret_cast<S*>(raw);
        M = A + n * (n + 1);
        v = M + n * (n + 1);
        s = v + n;
    }
};

template <typename S>
__global__ void __launch_bounds__(kThreads)
solve_inner_kernel(const S* __restrict__ inner, const double* __restrict__ r1,
                   S* __restrict__ mid, int n) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int ld = n + 1;
    SolveSmem<S> sm(smem_raw, n);
    const size_t off = size_t(blockIdx.x) * n * n;
    const double* r1b = r1 + size_t(blockIdx.x) * n;
    for (int idx = threadIdx.x; idx < n * n; idx += kThreads) {
        const int r = idx / n, c = idx - r * n;
        sm.A[r * ld + c] = inner[off + idx];
        sm.M[r * ld + c] = from_real<S>(r == c ? r1b[c] : 0.0);
    }
    __syncthreads();
    solve_resident(sm.A, sm.M, sm.v, sm.s, mid + off, n, ld);
}

template <typename S>
__global__ void __launch_bounds__(kThreads)
solve_inner_rhs_kernel(const S* __restrict__ inner, const S* __restrict__ rhs,
                       S* __restrict__ out, int n) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int ld = n + 1;
    SolveSmem<S> sm(smem_raw, n);
    const size_t off = size_t(blockIdx.x) * n * n;
    for (int idx = threadIdx.x; idx < n * n; idx += kThreads) {
        const int r = idx / n, c = idx - r * n;
        sm.A[r * ld + c] = inner[off + idx];
        sm.M[r * ld + c] = rhs[off + idx];
    }
    __syncthreads();
    solve_resident(sm.A, sm.M, sm.v, sm.s, out + off, n, ld);
}

// mirrored by linalg/green_solve.py smem_bytes
template <typename S>
size_t solve_smem_bytes(int n) {
    return sizeof(S) * (2 * size_t(n) * (n + 1) + 3 * size_t(n));
}

template <typename S>
int solve_inner(int device, const void* inner, const void* r1, void* mid,
                int batch, int n, void* stream) {
    return launch_smem(device, solve_inner_kernel<S>, batch,
                       solve_smem_bytes<S>(n), stream,
                       static_cast<const S*>(inner),
                       static_cast<const double*>(r1),
                       static_cast<S*>(mid), n);
}

template <typename S>
int solve_inner_rhs(int device, const void* inner, const void* rhs, void* out,
                    int batch, int n, void* stream) {
    return launch_smem(device, solve_inner_rhs_kernel<S>, batch,
                       solve_smem_bytes<S>(n), stream,
                       static_cast<const S*>(inner), static_cast<const S*>(rhs),
                       static_cast<S*>(out), n);
}

}  // namespace dq

extern "C" {

int dq_solve_inner_f64(int device, const void* inner, const void* r1,
                       void* mid, int batch, int n, void* stream) {
    return dq::solve_inner<double>(device, inner, r1, mid, batch, n, stream);
}

int dq_solve_inner_c128(int device, const void* inner, const void* r1,
                        void* mid, int batch, int n, void* stream) {
    return dq::solve_inner<dq::cplx<double>>(device, inner, r1, mid, batch, n,
                                             stream);
}

int dq_solve_inner_rhs_f64(int device, const void* inner, const void* rhs,
                           void* out, int batch, int n, void* stream) {
    return dq::solve_inner_rhs<double>(device, inner, rhs, out, batch, n,
                                       stream);
}

int dq_solve_inner_rhs_c128(int device, const void* inner, const void* rhs,
                            void* out, int batch, int n, void* stream) {
    return dq::solve_inner_rhs<dq::cplx<double>>(device, inner, rhs, out,
                                                 batch, n, stream);
}

}  // extern "C"
