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
// pallas_cgreen_lanes.py:19-23): Householder QR of inner, each reflector
// also applied to M, so M ends as Q^H M; then X = R^{-1} Q^H M.
// Two bodies, both on the FP64 tensor cores with M in registers:
//   - complex128 (K3c with M = diag(r1) built in registers, K3c-rhs with a
//     dense M): solve_cplx_tc (cplx_tc.cuh, shared with K2c's complex QR in
//     qr.cu), behind two kernel names.
//     K3c ran the first design until it took this body: A and M in shared
//     memory (133 KB at n = 64, one CTA per SM), one reflector at a time
//     with three barriers each, then a back-substitution with one thread
//     per column of M; K3c-rhs's probe of that design measured 452 us per
//     CTA, 70 % of it the reflectors' application, 15 % warp 0's serial
//     norms, 13 % the back-substitution (NVIDIA H100 80GB HBM3, 700 W);
//   - float64 (K3 with diag(r1), K3r with a dense M): solve_f64_tc
//     (f64_tc.cuh, shared with K2's float64 QR in qr.cu), its panel at one
//     barrier a column, three CTAs per SM up to n = 64.
// r1 is real in every case; a dense RHS has inner's type.
#include <type_traits>

#include "cplx_tc.cuh"

namespace dq {

// ---- K3c and K3c-rhs: the complex128 solves on the tensor cores ---------
// X = inner^{-1} M for complex128 n <= 83 (the one-CTA route of
// kernel_for), one CTA per matrix, M = diag(r1) (K3c, built in registers:
// no dense M in global memory) or dense (K3c-rhs): solve_cplx_tc
// (cplx_tc.cuh, shared with K2c in qr.cu). The first design held A and M in
// shared memory, 133 KB at n = 64, one CTA per SM: 11 waves of 452 us at
// B = 1408, 70 % of it the reflectors' application to A and M with both
// operands of every multiply-add read from shared memory, 15 % warp 0's
// serial norms behind three barriers a column, 13 % a back-substitution
// that kept 64 of 256 threads busy (the phase probe, solve_timing.py,
// NVIDIA H100 80GB HBM3, 700 W). This one: 77 KB of shared memory at
// n = 64, two CTAs per SM (B = 128, sdw_l4's sweep, is one wave; B = 1408,
// its unequal-time anchors, six).

// distinct names, so a profile tells K3c from K3c-rhs (K3c takes K3c-rhs's
// arguments, its probe pointer unused, so one launch serves both)
template <int RF, int CFW>
__global__ void __launch_bounds__(kThreads, CFW == 1 ? 2 : 1)
solve_inner_c128_tc_kernel(const cplx<double>* __restrict__ inner,
                           const double* __restrict__ r1,
                           cplx<double>* __restrict__ mid, int n, long long*) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    solve_cplx_tc<cplx<double>, RF, CFW, kDiagM, false>(smem_raw, inner, r1, mid, nullptr, n,
                                                         nullptr);
}

template <int RF, int CFW, bool PROBE>
__global__ void __launch_bounds__(kThreads, CFW == 1 ? 2 : 1)
solve_inner_rhs_tc_kernel(const cplx<double>* __restrict__ inner,
                          const cplx<double>* __restrict__ rhs,
                          cplx<double>* __restrict__ out, int n, long long* probe_out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    solve_cplx_tc<cplx<double>, RF, CFW, kDenseM, PROBE>(smem_raw, inner, rhs, out, nullptr, n,
                                                          probe_out);
}

// f(kernel) for the K3c (rhs = 0) or K3c-rhs instance of np = 8 rf, rf =
// 1..11 (kernel_for sends n <= 83 here; with the probe: K3c-rhs at rf = 8
// only, the sdw_l4 shape), `missing` if there is none
template <bool PROBE, typename F>
int with_c128_tc(int rf, bool rhs, int missing, F f) {
    if constexpr (PROBE) {
        return rhs && rf == 8 ? f(solve_inner_rhs_tc_kernel<8, 1, true>) : missing;
    } else {
        return with_rf(rf, missing, [&](auto R) {
            constexpr int r = decltype(R)::value, cfw = r > 8 ? 2 : 1;
            if constexpr (r > 11)
                return missing;
            else
                return rhs ? f(solve_inner_rhs_tc_kernel<r, cfw, false>)
                           : f(solve_inner_c128_tc_kernel<r, cfw>);
        });
    }
}

template <bool PROBE>
int solve_c128(int device, const void* inner, const void* M, void* out, int batch,
               int n, bool rhs, void* stream, long long* probe) {
    return with_c128_tc<PROBE>(
        round_up(n, 8) / 8, rhs, static_cast<int>(cudaErrorInvalidValue), [&](auto kernel) {
            // M goes as raw pointer bytes: r1 (double) for K3c, complex128 for K3c-rhs
            return launch_tc(device, kernel, batch, ctc_smem_bytes<cplx<double>>(n), stream,
                             static_cast<const cplx<double>*>(inner), M,
                             static_cast<cplx<double>*>(out), n, probe);
        });
}

// ---- K3 / K3r: the float64 solves on the tensor cores ---------------------
// X = inner^{-1} M for float64 n <= 119 (the one-CTA route of kernel_for),
// M = diag(r1) (K3, solve_inner_f64_tc_kernel: M is built in registers, no
// dense M in global memory) or dense (K3r, solve_inner_rhs_f64_tc_kernel),
// one CTA per matrix: solve_f64_tc (f64_tc.cuh), K3c-rhs's design in
// float64, where each complex product (four real mma.sync m8n8k4) is one
// real one and A takes half the bytes. Per CTA at n = 64 it takes 71-82
// us, 69 % of it the panel (NVIDIA H100 80GB HBM3, 700 W).

// distinct names, so a profile tells K3 from K3r and both from K3c-rhs
// (K3 takes K3r's arguments, its probe pointer unused, so one launch
// serves both)
template <int RF>
__global__ void __launch_bounds__(kThreads, RF <= 8 ? 3 : 1)
solve_inner_f64_tc_kernel(const double* __restrict__ inner, const double* __restrict__ r1,
                          double* __restrict__ mid, int n, long long*) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    solve_f64_tc<RF, kDiagM, false>(smem_raw, inner, r1, mid, nullptr, n, nullptr);
}

template <int RF, bool PROBE>
__global__ void __launch_bounds__(kThreads, RF <= 8 ? 3 : 1)
solve_inner_rhs_f64_tc_kernel(const double* __restrict__ inner, const double* __restrict__ rhs,
                              double* __restrict__ out, int n, long long* probe_out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    solve_f64_tc<RF, kDenseM, PROBE>(smem_raw, inner, rhs, out, nullptr, n, probe_out);
}

// the K3 (rhs = 0) or K3r instance of this n, then f(kernel); the probe
// instance (K3r only) is compiled at np = 64, the Hubbard L = 8 shape
template <bool PROBE, typename F>
int with_f64_tc(int n, bool rhs, int missing, F f) {
    if constexpr (PROBE) {
        return rhs && round_up(n, 8) == 64 ? f(solve_inner_rhs_f64_tc_kernel<8, true>)
                                           : missing;
    } else {
        return with_rf(round_up(n, 8) / 8, missing, [&](auto R) {
            constexpr int rf = decltype(R)::value;
            return rhs ? f(solve_inner_rhs_f64_tc_kernel<rf, false>)
                       : f(solve_inner_f64_tc_kernel<rf>);
        });
    }
}

template <bool PROBE>
int solve_f64(int device, const void* inner, const void* M, void* out, int batch,
              int n, bool rhs, void* stream, long long* probe) {
    return with_f64_tc<PROBE>(n, rhs, static_cast<int>(cudaErrorInvalidValue),
                              [&](auto kernel) {
        return launch_tc(device, kernel, batch, f64_tc_smem_bytes(n), stream,
                         static_cast<const double*>(inner),
                         static_cast<const double*>(M), static_cast<double*>(out),
                         n, probe);
    });
}

}  // namespace dq

extern "C" {

int dq_solve_inner_f64(int device, const void* inner, const void* r1,
                       void* mid, int batch, int n, void* stream) {
    return dq::solve_f64<false>(device, inner, r1, mid, batch, n, false, stream,
                                nullptr);
}

int dq_solve_inner_c128(int device, const void* inner, const void* r1,
                        void* mid, int batch, int n, void* stream) {
    return dq::solve_c128<false>(device, inner, r1, mid, batch, n, false, stream,
                                 nullptr);
}

int dq_solve_inner_rhs_f64(int device, const void* inner, const void* rhs,
                           void* out, int batch, int n, void* stream) {
    return dq::solve_f64<false>(device, inner, rhs, out, batch, n, true, stream,
                                nullptr);
}

int dq_solve_inner_rhs_c128(int device, const void* inner, const void* rhs,
                            void* out, int batch, int n, void* stream) {
    return dq::solve_c128<false>(device, inner, rhs, out, batch, n, true, stream,
                                 nullptr);
}

// the float64 dense-RHS solve with the phase probe on (n = 57..64 only):
// probe (batch x 8 int64) gets each CTA's cycles per phase (panel,
// application to A, to M, back-substitution, barriers, loads and stores),
// total cycles and ns
int dq_solve_inner_rhs_probe_f64(int device, const void* inner, const void* rhs,
                                 void* out, int batch, int n, void* probe,
                                 void* stream) {
    return dq::solve_f64<true>(device, inner, rhs, out, batch, n, true, stream,
                               static_cast<long long*>(probe));
}

// the same for complex128 (n = 57..64 only), with the same phases
int dq_solve_inner_rhs_probe_c128(int device, const void* inner, const void* rhs,
                                  void* out, int batch, int n, void* probe,
                                  void* stream) {
    return dq::solve_c128<true>(device, inner, rhs, out, batch, n, true, stream,
                                static_cast<long long*>(probe));
}

// CTAs of the complex128 kernel, K3c (rhs = 0) or K3c-rhs, one SM holds at
// this n (the occupancy calculator, after launch_tc's attributes), or
// -(cudaError)
int dq_solve_inner_c128_blocks_per_sm(int device, int n, int rhs) {
    return dq::with_c128_tc<false>(
        dq::round_up(n, 8) / 8, rhs != 0, -static_cast<int>(cudaErrorInvalidValue),
        [&](auto kernel) {
            return dq::blocks_per_sm(device, kernel, dq::ctc_smem_bytes<dq::cplx<double>>(n));
        });
}

// the same for the float64 kernels: K3 (rhs = 0) or K3r
int dq_solve_inner_f64_blocks_per_sm(int device, int n, int rhs) {
    return dq::with_f64_tc<false>(n, rhs != 0, -static_cast<int>(cudaErrorInvalidValue),
                                  [&](auto kernel) {
        return dq::blocks_per_sm(device, kernel, dq::f64_tc_smem_bytes(n));
    });
}

}  // extern "C"
