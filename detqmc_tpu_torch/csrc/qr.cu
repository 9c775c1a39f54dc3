// K2 / K2c: batched Householder QR with Q formed explicitly, one CTA per
// matrix, real (K2) or complex (K2c).
//
// Replaces the TPU kernels detqmc_tpu/linalg/pallas_qr_lanes.py (qr_lanes,
// kernel body _kernel), the refactor QR of udv_decompose, and
// pallas_cqr_lanes.py (cqr_lanes, the complex refactor QR of the SDW
// chain, cudv.py:54-67). There 128 matrices ride the vector lanes in VMEM,
// the complex ones as (re, im) f32 planes. Here three designs:
//   - float64 (K2 on the Hubbard chains, whose stack is float64 in every
//     model dtype): qr_f64_tc_kernel, the float64 tensor-core body that K3
//     and K3r run (f64_tc.cuh solve_f64_tc) with the companion M = I built
//     in registers, so it ends as Q^T; no back-substitution. Panels of 8
//     columns at one barrier a column, the compact-WY application to A's
//     strips and Q^T's on the FP64 tensor cores (mma.sync m8n8k4), 40 KB of
//     shared memory at n = 64 and three CTAs per SM up to n = 64: B = 256
//     (the Hubbard L = 8 refactor) is one wave. It replaced qr_kernel in
//     float64, which took ~378 us per CTA at n = 64 (0.378 ms at B = 256,
//     NVIDIA H100 80GB HBM3, 700 W): n dependent reflector steps of three
//     barriers each, warp 0 alone forming each norm, and both operands of
//     every multiply-add of the rank-1 updates read from shared memory;
//     the same algorithm inside K3's parent spent 74-75 % of its CTA
//     applying the reflectors (its clock64() probe);
//   - complex64 and complex128 (K2c, the SDW refactor QR; the sdw_l4 path
//     runs complex64): qr_c64_tc_kernel and qr_c128_tc_kernel, the identity
//     companion instances (M = I, so it ends as Q^H) of the complex body of
//     K3c and K3c-rhs (cplx_tc.cuh solve_cplx_tc): panels of 8 columns at
//     one barrier a column, Q^H in registers, the compact-WY products on
//     the FP64 tensor cores (complex128) or register-held on the FP32 pipe
//     (complex64, no TF32); 39 KB of shared memory at n = 64 in complex64,
//     77 KB in complex128. They replaced qr_kernel, which took 350 us a
//     CTA at complex64 n = 64 (0.32 ms of device time at B = 128), 84 %
//     of it applying the reflectors with both operands of every rank-1
//     update in shared memory; this design takes 93 us, 63 % of it the
//     panel (the probes, solve_timing.py, NVIDIA H100 80GB HBM3, 700 W);
//   - float32 (K2 on the opdim-1 SDW chains, whose matrices are real:
//     the refactor QR of sdw_o1_l4 at n = 32, sdw_o1_full_l4 at n = 64 and
//     sdw_o1_l8 at n = 128, and the opdim-1 log-det's QR): qr_f32_tc_kernel,
//     K2c's complex64 body on real floats (cplx_tc.cuh, its products on the
//     FP32 pipe, no TF32), A at stride np + 4, Q^T in registers (at n =
//     128, RF = 16: two strips a warp, 64 registers a thread), 71 KB of
//     shared memory at n = 128. It replaced qr_kernel, the design the
//     float64 and complex instances had left: A and Q^H in shared memory
//     (133,632 B at n = 128, one CTA per SM), n dependent reflector steps
//     of three barriers each, warp 0 alone forming each norm and both
//     operands of every multiply-add of the rank-1 updates read from
//     shared memory: 1.297 ms of device time at B = 128, n = 128 (21.5 %
//     of sdw_o1_l8's device time in chip_smoke.py's profile), 0.271 at
//     n = 64, 0.074 at n = 32.
//     This one takes 0.220, 0.067 and 0.026 ms there; what bounds it is
//     the panel's chain, as in K2c: 105 of a CTA's 217 us at n = 128, the
//     WY products 50 (A) and 46 (Q^T), loads and stores 15 (the probe,
//     solve_timing.py --rows k2f32, NVIDIA H100 80GB HBM3, 700 W).
// On exit R = triu(A) with its strict lower triangle exactly zero, and
// Q = (Q^H)^H. R's diagonal is -sign(x_j)||x|| (real) or -(x_j/|x_j|)||x||
// (complex, not real, unlike LAPACK's); udv_decompose folds the phase into
// U. A zero column (v = 0) leaves everything unchanged in every design.
#include "cplx_tc.cuh"

namespace dq {

// K2c: names of their own, so a profile tells them from K2 in float32 and
// float64 and from K3c / K3c-rhs
template <int RF, int CFW, bool PROBE>
__global__ void __launch_bounds__(kThreads, CFW == 1 ? 2 : 1)
qr_c64_tc_kernel(const cplx<float>* __restrict__ A, cplx<float>* __restrict__ Q,
                 cplx<float>* __restrict__ R, int n, long long* probe_out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    solve_cplx_tc<cplx<float>, RF, CFW, kIdentityM, PROBE>(smem_raw, A, nullptr, Q, R, n,
                                                            probe_out);
}

template <int RF, int CFW>
__global__ void __launch_bounds__(kThreads, CFW == 1 ? 2 : 1)
qr_c128_tc_kernel(const cplx<double>* __restrict__ A, cplx<double>* __restrict__ Q,
                  cplx<double>* __restrict__ R, int n, long long*) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    solve_cplx_tc<cplx<double>, RF, CFW, kIdentityM, false>(smem_raw, A, nullptr, Q, R, n,
                                                             nullptr);
}

// f(kernel) for K2c's instance of this n and complex type (np = 8 rf up to
// 120 in complex64, 88 in complex128: kernel_for sends n <= 119 and
// n <= 83 here), `missing` if there is none; the probe instance is
// complex64 at np = 64, the sdw_l4 shape
template <typename S, bool PROBE, typename F>
int with_qr_complex(int n, int missing, F f) {
    constexpr bool c64 = std::is_same<S, cplx<float>>::value;
    if constexpr (PROBE) {
        if constexpr (c64)
            return round_up(n, 8) == 64 ? f(qr_c64_tc_kernel<8, 1, true>) : missing;
        else
            return missing;
    } else {
        return with_rf(round_up(n, 8) / 8, missing, [&](auto R) {
            constexpr int rf = decltype(R)::value, cfw = rf > 8 ? 2 : 1;
            if constexpr (c64)
                return f(qr_c64_tc_kernel<rf, cfw, false>);
            else if constexpr (rf > 11)
                return missing;
            else
                return f(qr_c128_tc_kernel<rf, cfw>);
        });
    }
}

template <typename S, bool PROBE>
int qr_complex(int device, const void* A, void* Q, void* R, int batch, int n, void* stream,
               long long* probe) {
    return with_qr_complex<S, PROBE>(n, static_cast<int>(cudaErrorInvalidValue),
                                     [&](auto kernel) {
        return launch_tc(device, kernel, batch, ctc_smem_bytes<S>(n), stream,
                         static_cast<const S*>(A), static_cast<S*>(Q), static_cast<S*>(R), n,
                         probe);
    });
}

// its own name, so a profile tells K2 in float64 from K2 in float32, K2c
// and K3 / K3r
template <int RF, bool PROBE>
__global__ void __launch_bounds__(kThreads, RF <= 8 ? 3 : 1)
qr_f64_tc_kernel(const double* __restrict__ A, double* __restrict__ Q,
                 double* __restrict__ R, int n, long long* probe_out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    solve_f64_tc<RF, kIdentityM, PROBE>(smem_raw, A, nullptr, Q, R, n, probe_out);
}

// the instance of this n, then f(kernel); the probe instance is compiled
// at np = 64, the Hubbard L = 8 shape
template <bool PROBE, typename F>
int with_qr_f64(int n, int missing, F f) {
    if constexpr (PROBE) {
        return round_up(n, 8) == 64 ? f(qr_f64_tc_kernel<8, true>) : missing;
    } else {
        return with_rf(round_up(n, 8) / 8, missing, [&](auto R) {
            constexpr int rf = decltype(R)::value;
            return f(qr_f64_tc_kernel<rf, false>);
        });
    }
}

template <bool PROBE>
int qr_f64(int device, const void* A, void* Q, void* R, int batch, int n, void* stream,
           long long* probe) {
    return with_qr_f64<PROBE>(n, static_cast<int>(cudaErrorInvalidValue), [&](auto kernel) {
        return launch_tc(device, kernel, batch, f64_tc_smem_bytes(n), stream,
                         static_cast<const double*>(A), static_cast<double*>(Q),
                         static_cast<double*>(R), n, probe);
    });
}

// K2 in float32: K2c's complex64 body on real floats, its own name
template <int RF, bool PROBE>
__global__ void __launch_bounds__(kThreads, RF <= 8 ? 2 : 1)
qr_f32_tc_kernel(const float* __restrict__ A, float* __restrict__ Q, float* __restrict__ R,
                 int n, long long* probe_out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    solve_cplx_tc<float, RF, (RF + 7) / 8, kIdentityM, PROBE>(smem_raw, A, nullptr, Q, R, n,
                                                              probe_out);
}

// the instance of this n (np = 8 rf up to 128: kernel_for sends float32
// n <= 128 here), then f(kernel); the probe instance is compiled at np =
// 128, the sdw_o1_l8 shape
template <bool PROBE, typename F>
int with_qr_f32(int n, int missing, F f) {
    if constexpr (PROBE) {
        return round_up(n, 8) == 128 ? f(qr_f32_tc_kernel<16, true>) : missing;
    } else {
        return with_rf<16>(round_up(n, 8) / 8, missing, [&](auto R) {
            return f(qr_f32_tc_kernel<decltype(R)::value, false>);
        });
    }
}

template <bool PROBE>
int qr_f32(int device, const void* A, void* Q, void* R, int batch, int n, void* stream,
           long long* probe) {
    return with_qr_f32<PROBE>(n, static_cast<int>(cudaErrorInvalidValue), [&](auto kernel) {
        return launch_tc(device, kernel, batch, ctc_smem_bytes<float>(n), stream,
                         static_cast<const float*>(A), static_cast<float*>(Q),
                         static_cast<float*>(R), n, probe);
    });
}

}  // namespace dq

extern "C" {

int dq_qr_f32(int device, const void* A, void* Q, void* R, int batch, int n,
              void* stream) {
    return dq::qr_f32<false>(device, A, Q, R, batch, n, stream, nullptr);
}

int dq_qr_f64(int device, const void* A, void* Q, void* R, int batch, int n,
              void* stream) {
    return dq::qr_f64<false>(device, A, Q, R, batch, n, stream, nullptr);
}

int dq_qr_c64(int device, const void* A, void* Q, void* R, int batch, int n,
              void* stream) {
    return dq::qr_complex<dq::cplx<float>, false>(device, A, Q, R, batch, n, stream, nullptr);
}

int dq_qr_c128(int device, const void* A, void* Q, void* R, int batch, int n,
               void* stream) {
    return dq::qr_complex<dq::cplx<double>, false>(device, A, Q, R, batch, n, stream, nullptr);
}

// the float64 QR with the phase probe on (n = 57..64 only): probe (batch x
// 8 int64) gets each CTA's cycles per phase (panel, application to A, to
// Q^T, back-substitution (none), barriers, loads and stores), total cycles
// and ns
int dq_qr_probe_f64(int device, const void* A, void* Q, void* R, int batch, int n,
                    void* probe, void* stream) {
    return dq::qr_f64<true>(device, A, Q, R, batch, n, stream,
                            static_cast<long long*>(probe));
}

// K2 in float32 with the phase probe on (n = 121..128 only), with the
// float64 probe's phases
int dq_qr_probe_f32(int device, const void* A, void* Q, void* R, int batch, int n,
                    void* probe, void* stream) {
    return dq::qr_f32<true>(device, A, Q, R, batch, n, stream, static_cast<long long*>(probe));
}

// K2c in complex64 with the phase probe on (n = 57..64 only), with the
// float64 probe's phases
int dq_qr_probe_c64(int device, const void* A, void* Q, void* R, int batch, int n,
                    void* probe, void* stream) {
    return dq::qr_complex<dq::cplx<float>, true>(device, A, Q, R, batch, n, stream,
                                                 static_cast<long long*>(probe));
}

// CTAs of the one-CTA QR one SM holds at this n, dtype code 0..3 (float32,
// float64, complex64, complex128; the occupancy calculator), or
// -(cudaError)
int dq_qr_blocks_per_sm(int device, int dtype, int n) {
    switch (dtype) {
        case 0:
            return dq::with_qr_f32<false>(
                n, -static_cast<int>(cudaErrorInvalidValue), [&](auto kernel) {
                    return dq::blocks_per_sm(device, kernel, dq::ctc_smem_bytes<float>(n));
                });
        case 1:
            return dq::with_qr_f64<false>(
                n, -static_cast<int>(cudaErrorInvalidValue), [&](auto kernel) {
                    return dq::blocks_per_sm(device, kernel, dq::f64_tc_smem_bytes(n));
                });
        case 2:
            return dq::with_qr_complex<dq::cplx<float>, false>(
                n, -static_cast<int>(cudaErrorInvalidValue), [&](auto kernel) {
                    return dq::blocks_per_sm(device, kernel,
                                             dq::ctc_smem_bytes<dq::cplx<float>>(n));
                });
        case 3:
            return dq::with_qr_complex<dq::cplx<double>, false>(
                n, -static_cast<int>(cudaErrorInvalidValue), [&](auto kernel) {
                    return dq::blocks_per_sm(device, kernel,
                                             dq::ctc_smem_bytes<dq::cplx<double>>(n));
                });
        default: return -static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // extern "C"
