// K8: stabilized inner solve mid = inner^{-1} M for n beyond the one-CTA
// kernels K3 / K3c (green_solve.cu), float64 or complex128, with M =
// diag(r1) (the equal-time G) or a dense right-hand side (the _rhs entry,
// the unequal-time G(tau, 0) with M = d1min V1): the factorization, one
// CTA per matrix.
//
// Replaces the TPU kernels detqmc_tpu/linalg/pallas_cgreen.py
// (solve_inner_complex_big, kernel body _kernel), the column-lane df32
// solve of the SDW chain at L = 8 (n = 256), with its dense-RHS twin
// solve_inner_complex_big_rhs, and the real column-lane df32 solve of
// pallas_green.py (solve_inner's n > 128 branch, _make_solve_inner, kernel
// body _kernel), the Hubbard chain at N > 128 (L = 16: n = 256). The
// reflectors already touch every column of M, so a dense M costs what
// diag(r1) costs; the real dense-RHS entry has no Pallas twin (the JAX
// package runs XLA there, udv.green_tau_zero) and is the same body. As
// in K3 / K3c, the H100 has native f64 and complex128, so df32 is not
// ported and every intermediate stays in the input's type. Same algorithm
// (pallas_cgreen.py:18-26, pallas_green.py), in two launches:
//   1. this kernel: blocked Householder QR of inner (householder_blocked,
//      common.cuh, the device code of K7) with the reflectors applied to
//      M, so M ends as Q^H M in mid and R in work;
//   2. K9 (trinv_big.cu), the blocked triangular inverse of
//      pallas_trinv_common.py applied to M: mid = R^{-1} Q^H M, in place
//      (linalg/green_solve.py launches both).
// A 256 x 256 matrix is 512 KB in f64 (1 MB in complex128), so inner's
// working copy (work) and M stay in global memory. What bounds it on the
// H100: the FP64 pipe on the trailing updates (~(4/3 + 2) n^3 / 2
// products per matrix) and the n dependent column steps of one CTA per
// matrix.
#include "common.cuh"

namespace dq {

template <typename S>
__global__ void __launch_bounds__(kThreads)
solve_inner_big_kernel(const S* __restrict__ inner, const double* __restrict__ r1,
                       S* mid, S* work, int n, int b, int tc) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const BlockedSmem<S> sm = blocked_smem<S>(smem_raw, n, b, tc);
    const int tid = threadIdx.x;
    const size_t off = size_t(blockIdx.x) * n * n;
    const double* r1b = r1 + size_t(blockIdx.x) * n;
    S* A = work + off;
    S* M = mid + off;
    for (int idx = tid; idx < n * n; idx += kThreads) {
        const int r = idx / n, c = idx - r * n;
        A[idx] = inner[off + idx];
        M[idx] = from_real<S>(r == c ? r1b[c] : 0.0);
    }
    __syncthreads();
    householder_blocked(A, M, n, b, tc, sm);
}

template <typename S>
__global__ void __launch_bounds__(kThreads)
solve_inner_big_rhs_kernel(const S* __restrict__ inner, const S* __restrict__ rhs,
                           S* out, S* work, int n, int b, int tc) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const BlockedSmem<S> sm = blocked_smem<S>(smem_raw, n, b, tc);
    const size_t off = size_t(blockIdx.x) * n * n;
    S* A = work + off;
    S* M = out + off;
    for (int idx = threadIdx.x; idx < n * n; idx += kThreads) {
        A[idx] = inner[off + idx];
        M[idx] = rhs[off + idx];
    }
    __syncthreads();
    householder_blocked(A, M, n, b, tc, sm);
}

template <typename S>
int solve_inner_big(int device, const void* inner, const void* r1, void* mid,
                    void* work, int batch, int n, int b, int tc, void* stream) {
    return launch_smem(device, solve_inner_big_kernel<S>, batch,
                       blocked_smem_bytes<S>(n, b, tc), stream,
                       static_cast<const S*>(inner), static_cast<const double*>(r1),
                       static_cast<S*>(mid), static_cast<S*>(work), n, b, tc);
}

template <typename S>
int solve_inner_big_rhs(int device, const void* inner, const void* rhs, void* out,
                        void* work, int batch, int n, int b, int tc, void* stream) {
    return launch_smem(device, solve_inner_big_rhs_kernel<S>, batch,
                       blocked_smem_bytes<S>(n, b, tc), stream,
                       static_cast<const S*>(inner), static_cast<const S*>(rhs),
                       static_cast<S*>(out), static_cast<S*>(work), n, b, tc);
}

}  // namespace dq

extern "C" {

int dq_solve_inner_big_f64(int device, const void* inner, const void* r1, void* mid,
                           void* work, int batch, int n, int b, int tc, void* stream) {
    return dq::solve_inner_big<double>(device, inner, r1, mid, work, batch, n, b, tc,
                                       stream);
}

int dq_solve_inner_big_rhs_f64(int device, const void* inner, const void* rhs,
                               void* out, void* work, int batch, int n, int b, int tc,
                               void* stream) {
    return dq::solve_inner_big_rhs<double>(device, inner, rhs, out, work, batch, n, b,
                                           tc, stream);
}

int dq_solve_inner_big_c128(int device, const void* inner, const void* r1, void* mid,
                            void* work, int batch, int n, int b, int tc,
                            void* stream) {
    return dq::solve_inner_big<dq::cplx<double>>(device, inner, r1, mid, work, batch,
                                                 n, b, tc, stream);
}

int dq_solve_inner_big_rhs_c128(int device, const void* inner, const void* rhs,
                                void* out, void* work, int batch, int n, int b,
                                int tc, void* stream) {
    return dq::solve_inner_big_rhs<dq::cplx<double>>(device, inner, rhs, out, work,
                                                     batch, n, b, tc, stream);
}

}  // extern "C"
