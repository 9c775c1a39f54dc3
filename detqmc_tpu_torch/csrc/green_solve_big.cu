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
//   1. this kernel: blocked Householder QR of inner (householder_tc,
//      tc_blocked.cuh) with the reflectors applied to M, so M ends as
//      Q^H M in mid and R in work;
//   2. K9 (trinv_big.cu), the blocked triangular inverse of
//      pallas_trinv_common.py applied to M: mid = R^{-1} Q^H M, in place
//      (linalg/green_solve.py launches both).
// A 256 x 256 matrix is 512 KB in f64 (1 MB in complex128), so inner's
// working copy (work) and M stay in global memory; the first panel reads
// inner and the dense RHS where they lie.
//
// What bounds it on the H100 (NVIDIA H100 80GB HBM3, 700 W): the work is
// (4/3 + 2 + 1) n^3 real operations per matrix (x4 in complex), 0.12 ms
// for 128 real matrices at n = 256 on the FP64 tensor cores' 67 TFLOP/s.
// The first design (K7's householder_blocked, common.cuh) took 6.4 ms
// there, latency-bound: one output per thread with two shared-memory
// loads per multiply-add, 16-column tiles loaded synchronously, warp 0
// alone on each column's norm (three barriers a column), and 125-156 KB of
// shared memory, one CTA per SM, so B = 5376 ran 41 waves of that latency.
// This design:
//   - the trailing update X <- X - V T^H V^H X and Q^H M as tensor-core
//     products (mma.sync m8n8k4 f64; complex128 as four real products)
//     with each warp's output fragments in registers through the k-loop;
//   - the next column tile copied by cp.async while the current one is
//     computed (nbuf = 2), when shared memory allows;
//   - the panel at two barriers a column, every warp forming the norm;
//   - in float64, a layout that fits twice on an SM (b = tc = 16, one
//     tile buffer, 92 KB at n = 256) when the batch has more matrices than
//     the card has SMs, so that one matrix's panel latency hides behind
//     the other's products; otherwise one CTA of up to 195 KB with wider
//     panels and two tile buffers (linalg/green_solve.py big_plan).
//     complex128 stays at one CTA per SM: at n = 256 only b = tc = 8 fits
//     twice, and it lost to one (16, 8, 2) CTA.
// K8 + K9 then take 1.9 ms at f64 B = 128 (torch.linalg.solve 4.6-4.9)
// and 65.5 ms at f64 B = 5376 (96-114): 3.4x and 3.9x faster than the
// first design (solve_timing.py). K7's redesign on the same factorization
// (a warp's panel dot products interleaved, a division-free rank-1
// update, Y = -T^H W on the tensor cores) took them to 1.6 and 59 ms. What holds it now is the panel's chain (two
// barriers and a warp reduction per column, n columns per matrix) and, at
// B = 5376, the tiles' traffic (each panel reads and writes the trailing
// matrix and all of M: 14 MiB per f64 matrix at b = 16, 23 ms of HBM
// time for the batch, a third of the call).

#include <type_traits>

#include "tc_blocked.cuh"

namespace dq {

template <typename S, int BP, int TC>
__global__ void __launch_bounds__(kThreads, 2)
solve_inner_big_kernel(const S* __restrict__ inner, const double* __restrict__ r1,
                       S* mid, S* work, int n, int nbuf) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const TcSmem<S> sm = tc_smem<S>(smem_raw, n, BP, TC, nbuf);
    const size_t off = size_t(blockIdx.x) * n * n;
    const double* r1b = r1 + size_t(blockIdx.x) * n;
    S* M = mid + off;
    for (int idx = threadIdx.x; idx < n * n; idx += kThreads) {
        const int r = idx / n, c = idx - r * n;
        M[idx] = from_real<S>(r == c ? r1b[c] : 0.0);
    }
    __syncthreads();
    householder_tc<S, BP, TC>(inner + off, work + off, M, M, n, nbuf, sm);
}

template <typename S, int BP, int TC>
__global__ void __launch_bounds__(kThreads, 2)
solve_inner_big_rhs_kernel(const S* __restrict__ inner, const S* __restrict__ rhs,
                           S* out, S* work, int n, int nbuf) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const TcSmem<S> sm = tc_smem<S>(smem_raw, n, BP, TC, nbuf);
    const size_t off = size_t(blockIdx.x) * n * n;
    householder_tc<S, BP, TC>(inner + off, work + off, rhs + off, out + off, n, nbuf,
                              sm);
}

// the compiled (b, tc) plans: float64 (32, 16) and (16, 16), complex128
// (16, 8) and (8, 8) (linalg/green_solve.py _BIG_PLANS); nbuf is 1 or 2
template <typename S>
bool plan_ok(int b, int tc, int nbuf) {
    const bool shape = std::is_same<S, double>::value
                           ? (tc == 16 && (b == 32 || b == 16))
                           : (tc == 8 && (b == 16 || b == 8));
    return shape && (nbuf == 1 || nbuf == 2) && nbuf * (tc + pad_of<S>::value) >= b + 1;
}

template <typename S, bool RHS, int BP, int TC>
auto k8_kernel() {
    if constexpr (RHS) return solve_inner_big_rhs_kernel<S, BP, TC>;
    else return solve_inner_big_kernel<S, BP, TC>;
}

// calls f(kernel pointer) for the instance of (b, tc) and M's kind
template <typename S, bool RHS, typename F>
int with_kernel(int b, F f) {
    if constexpr (std::is_same<S, double>::value)
        return b == 32 ? f(k8_kernel<S, RHS, 32, 16>()) : f(k8_kernel<S, RHS, 16, 16>());
    else
        return b == 16 ? f(k8_kernel<S, RHS, 16, 8>()) : f(k8_kernel<S, RHS, 8, 8>());
}

template <typename S>
int solve_inner_big(int device, const void* inner, const void* M, void* out, void* work,
                    int batch, int n, int b, int tc, int nbuf, bool rhs, void* stream) {
    if (!plan_ok<S>(b, tc, nbuf)) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = tc_smem_bytes<S>(n, b, tc, nbuf);
    const S* in = static_cast<const S*>(inner);
    S* o = static_cast<S*>(out);
    S* w = static_cast<S*>(work);
    if (rhs)
        return with_kernel<S, true>(b, [&](auto kernel) {
            return launch_tc(device, kernel, batch, smem, stream, in,
                             static_cast<const S*>(M), o, w, n, nbuf);
        });
    return with_kernel<S, false>(b, [&](auto kernel) {
        return launch_tc(device, kernel, batch, smem, stream, in,
                         static_cast<const double*>(M), o, w, n, nbuf);
    });
}

template <typename S>
int solve_inner_big_blocks(int device, int n, int b, int tc, int nbuf, bool rhs) {
    if (!plan_ok<S>(b, tc, nbuf)) return -static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = tc_smem_bytes<S>(n, b, tc, nbuf);
    auto f = [&](auto kernel) { return blocks_per_sm(device, kernel, smem); };
    return rhs ? with_kernel<S, true>(b, f) : with_kernel<S, false>(b, f);
}

}  // namespace dq

extern "C" {

int dq_solve_inner_big_f64(int device, const void* inner, const void* r1, void* mid,
                           void* work, int batch, int n, int b, int tc, int nbuf,
                           void* stream) {
    return dq::solve_inner_big<double>(device, inner, r1, mid, work, batch, n, b, tc,
                                       nbuf, false, stream);
}

int dq_solve_inner_big_rhs_f64(int device, const void* inner, const void* rhs,
                               void* out, void* work, int batch, int n, int b, int tc,
                               int nbuf, void* stream) {
    return dq::solve_inner_big<double>(device, inner, rhs, out, work, batch, n, b, tc,
                                       nbuf, true, stream);
}

int dq_solve_inner_big_c128(int device, const void* inner, const void* r1, void* mid,
                            void* work, int batch, int n, int b, int tc, int nbuf,
                            void* stream) {
    return dq::solve_inner_big<dq::cplx<double>>(device, inner, r1, mid, work, batch,
                                                 n, b, tc, nbuf, false, stream);
}

int dq_solve_inner_big_rhs_c128(int device, const void* inner, const void* rhs,
                                void* out, void* work, int batch, int n, int b,
                                int tc, int nbuf, void* stream) {
    return dq::solve_inner_big<dq::cplx<double>>(device, inner, rhs, out, work, batch,
                                                 n, b, tc, nbuf, true, stream);
}

// CTAs of K8 per SM at this plan (complex: complex128, else float64; rhs:
// the dense-RHS kernel), or -(cudaError)
int dq_solve_inner_big_blocks_per_sm(int device, int complex, int rhs, int n, int b,
                                     int tc, int nbuf) {
    return complex ? dq::solve_inner_big_blocks<dq::cplx<double>>(device, n, b, tc,
                                                                  nbuf, rhs != 0)
                   : dq::solve_inner_big_blocks<double>(device, n, b, tc, nbuf,
                                                        rhs != 0);
}

}  // extern "C"
