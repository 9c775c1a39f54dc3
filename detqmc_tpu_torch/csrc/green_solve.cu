// K3 / K3c: stabilized inner solve mid = inner^{-1} diag(r1), one CTA per
// matrix, in float64 (K3) or complex128 (K3c).
//
// Replaces the TPU kernels detqmc_tpu/linalg/pallas_green.py (solve_inner,
// the dispatcher) -> pallas_green_lanes.py (solve_inner_lanes, kernel body
// _kernel) for the real chain, and pallas_cgreen_lanes.py
// (solve_inner_complex, kernel body _kernel) for the complex SDW chain.
// On the TPU the range-split inner matrix (condition ~1e6 at beta=8) is
// factored in df32 (hi, lo) f32 pairs, the complex one as four such
// planes, because the chip has no f64; the H100 has native f64 and
// complex128, so the inputs are plain f64 / complex128 and every
// intermediate stays in that type. Same algorithm (pallas_green.py:16-25,
// pallas_cgreen_lanes.py:19-23):
//   1. Householder QR of inner, each reflector also applied to
//      M = diag(r1), so M ends as Q^H diag(r1) (householder_apply);
//   2. back-substitution X = R^{-1} M with R_jj = alpha_j, in place in M:
//      one thread per column of M walks j = n-1 .. 0, so no CTA barrier is
//      needed (each thread reads only the rows of its own column that it
//      has already solved). The complex division is M conj(a) / |a|^2.
// r1 is real in both cases. Shared memory: 2 n (n+1) values (66 KB at
// n=64 in f64, 133 KB in complex128). What bounds it: the n dependent
// reflector steps, then the n-deep back-substitution chain per column.
#include "common.cuh"

namespace dq {

template <typename S>
__global__ void __launch_bounds__(kThreads)
solve_inner_kernel(const S* __restrict__ inner, const double* __restrict__ r1,
                   S* __restrict__ mid, int n) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int ld = n + 1;
    S* A = reinterpret_cast<S*>(smem_raw);   // n x ld
    S* M = A + n * ld;                       // n x ld
    S* v = M + n * ld;                       // n
    S* s = v + n;                            // 2n
    const int tid = threadIdx.x;
    const size_t off = size_t(blockIdx.x) * n * n;
    const double* r1b = r1 + size_t(blockIdx.x) * n;
    for (int idx = tid; idx < n * n; idx += kThreads) {
        const int r = idx / n, c = idx - r * n;
        A[r * ld + c] = inner[off + idx];
        M[r * ld + c] = from_real<S>(r == c ? r1b[c] : 0.0);
    }
    __syncthreads();
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
        mid[off + idx] = M[r * ld + c];
    }
}

template <typename S>
int solve_inner(int device, const void* inner, const void* r1, void* mid,
                int batch, int n, void* stream) {
    const size_t smem = sizeof(S) * (2 * size_t(n) * (n + 1) + 3 * size_t(n));
    return launch_smem(device, solve_inner_kernel<S>, batch, smem, stream,
                       static_cast<const S*>(inner),
                       static_cast<const double*>(r1),
                       static_cast<S*>(mid), n);
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

}  // extern "C"
