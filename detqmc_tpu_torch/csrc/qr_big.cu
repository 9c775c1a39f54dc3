// K7: batched Householder QR with Q formed explicitly, for n beyond the
// one-CTA kernels K2 / K2c (qr.cu), one CTA per matrix; real (float32,
// float64) and complex (complex64, complex128).
//
// Replaces the TPU kernels detqmc_tpu/linalg/pallas_cqr_wy.py (cqr_wy, the
// compact-WY layout, kernel body _kernel) and pallas_cqr.py (cqr_big, the
// rank-1 column-lane layout of the same factorization), which cudv.py
// sends every complex refactor QR with n > 128 to (cudv.py:38-67): the SDW
// chain at L = 8 (n = 256); and their real twins pallas_qr_wy.py (qr_wy)
// and pallas_qr_big.py (qr_big), the refactor QR of the Hubbard chain at
// N > 128 (udv._big_qr_impl, udv.py:80-104): L = 16, n = 256. One Hopper
// kernel, one template, replaces all four layouts.
// A complex64 256 x 256 matrix is 512 KB (1 MB in complex128), beyond a
// block's 227 KB, so A and the Q^H accumulator stay in global memory (the
// output buffers R and Q serve as the work arrays). The factorization is
// K8's (householder_tc, tc_blocked.cuh) without a companion, each panel's
// V and T left in Q's buffer; then Q = H_0 H_1 ... H_{K-1} is formed
// backward (LAPACK's orgqr order, form_q_backward): panel k touches only
// Q's rows and columns from j0, so Q costs 4/3 n^3 instead of the
// forward 2 n^3, comes out as Q (not Q^H: no transposition), and its
// identity parts are formed in shared memory, never stored.
// Contract as K2 / K2c: A = Q R, Q orthogonal / unitary, R's strict lower
// triangle exactly zero, R_jj = -sign(x_j)||x|| (real, sign(0) = +1, as
// pallas_qr_big.py:22-23) or -(x_j/|x_j|)||x|| (complex; not normalized:
// udv._sign_fix folds the sign or phase). No atomics: two calls are
// bitwise equal.
//
// What bounds it on the H100 (NVIDIA H100 80GB HBM3, 700 W): the work is
// 8/3 n^3 real operations per matrix for R and Q (x4 in complex), 0.09 ms
// for 128 float64 matrices at n = 256 on the FP64 tensor cores. The first
// design (householder_blocked, one output per thread with two shared-memory
// loads per multiply-add, tiles loaded synchronously, warp 0 alone on each
// column, SV one warp per pair) took 5.09 ms there; its clock64() probe
// (solve_timing.py) put 64 % of a CTA's time in the tile products (A's
// trailing columns 23 %, Q's 41 %), 18 % in the synchronous tile loads,
// 10 % in the panel and 7 % in SV and T. This design:
//   - the products on the FP64 tensor cores (float64, complex128: mma.sync
//     m8n8k4) or register-tiled on the FP32 pipe (float32, complex64: 4 x 2
//     blocks of V^H X and 4 x 4 blocks of X + V Y per thread, operands
//     streamed from shared memory; no TF32, which loses the float32
//     tolerance);
//   - the next tile copied by cp.async while the current one is computed;
//   - the panel at two barriers a column, every warp forming the norm, a
//     warp's dot products interleaved, the rank-1 update division-free;
//   - SV = V^H V and Y = -T^H (V^H X) as products too;
//   - float64 at two CTAs per SM (b = tc = 16, one tile buffer) when the
//     batch has more matrices than the card has SMs (linalg/qr.py
//     big_plan);
//   - Q formed backward (above).
// It takes 1.17 ms at float64 and 1.80 ms at complex64 there
// (solve_timing.py; torch.linalg.qr 80 and 103 ms). What holds it now, by
// the probe (float64 / complex64, share of a CTA's time): the panel's
// chain of n dependent columns (36 % / 26 %: two barriers, a norm and the
// warp reductions a column), the tile products (33 % / 53 %; the FP32
// pipe at about a third of its peak), the tiles' loads and the panel's
// copies (22 % / 14 %: each panel reads and writes the trailing matrix),
// SV and T (9 % / 7 %). Not taken: a cluster of two CTAs per matrix for
// the panel.
#include <type_traits>

#include "tc_blocked.cuh"

namespace dq {

// Q = H_0 H_1 ... H_{K-1} (H_k = I - V_k T_k V_k^H) from the V and T that
// householder_tc left in Q, formed backward (LAPACK's orgqr order):
// panel k, last first, applies H_k to Q's rows and columns j0 .. n, whose
// rows or columns below j0 + bw are still the identity's (formed in the
// tile buffers, so the V and T stored there are read once and then
// overwritten). Panel k costs mp^2 instead of the forward mp n.
template <typename S, int BP, int TC, typename PR>
__device__ void form_q_backward(S* Q, int n, int nbuf, const TcSmem<S>& sm, PR& probe) {
    using R = typename real_of<S>::type;
    constexpr int LDV = BP + pad_of<S>::value;
    const int np = round_up(n, 8);
    const S zero = from_real<S>(R(0));
    for (int j0 = (n - 1) / BP * BP; j0 >= 0; j0 -= BP) {
        const int bw = min(BP, n - j0), mp = n - j0;
        for (int idx = threadIdx.x; idx < np * LDV; idx += kThreads) {
            const int r = idx / LDV, c = idx - r * LDV;
            sm.V[idx] = r < mp && c < bw && r >= c ? Q[size_t(j0 + r) * n + j0 + c] : zero;
        }
        for (int idx = threadIdx.x; idx < BP * BP; idx += kThreads) {
            const int r = idx / BP, i = idx % BP;
            sm.T[idx] = r < bw && i < bw && i >= r ? Q[vt_t_index(n, j0, bw, r, i)] : zero;
        }
        __syncthreads();
        probe.lap(kQrLoadStore);
        const int nt = (mp + TC - 1) / TC;
        apply_reflectors<S, BP, TC, false>(sm, n, j0, mp, nbuf, nt, 0, [&](int t) {
            const int c0 = j0 + t * TC;
            return TileRef<S>{Q, Q, c0, min(TC, n - c0), j0 + bw};
        }, probe);
    }
}

// two CTAs per SM only in float64 (the FP32 products need more registers
// than half an SM's)
template <typename S, int BP, int TC, bool PROBE>
__global__ void __launch_bounds__(kThreads, on_tensor_cores<S>() ? 2 : 1)
qr_big_kernel(const S* __restrict__ A_in, S* Q_out, S* R_out, int n, int nbuf,
              long long* probe_out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const TcSmem<S> sm = tc_smem<S>(smem_raw, n, BP, TC, nbuf);
    Probe<PROBE, kQrPhases> probe;
    probe.start();
    const size_t off = size_t(blockIdx.x) * n * n;
    householder_tc<S, BP, TC>(A_in + off, R_out + off, nullptr, nullptr, n, nbuf, sm, probe,
                              Q_out + off);
    form_q_backward<S, BP, TC>(Q_out + off, n, nbuf, sm, probe);
    probe.store(probe_out);
}

// the compiled (b, tc) plans (linalg/qr.py _BIG_PLANS): complex128 (16, 8)
// and (8, 8), the others (32, 16) and (16, 16); nbuf is 1 or 2. The probe
// instances: float64 and complex64 at (32, 16), the main paths' plans.
template <typename S>
bool qr_plan_ok(int b, int tc, int nbuf) {
    const bool shape = std::is_same<S, cplx<double>>::value
                           ? (tc == 8 && (b == 16 || b == 8))
                           : (tc == 16 && (b == 32 || b == 16));
    return shape && (nbuf == 1 || nbuf == 2) && nbuf * (tc + pad_of<S>::value) >= b + 1;
}

template <typename S>
constexpr bool has_qr_probe() {
    return std::is_same<S, double>::value || std::is_same<S, cplx<float>>::value;
}

// calls f(kernel pointer) for the instance of (b, probe)
template <typename S, typename F>
int with_qr_kernel(int b, bool probe, F f) {
    if constexpr (std::is_same<S, cplx<double>>::value) {
        return b == 16 ? f(qr_big_kernel<S, 16, 8, false>) : f(qr_big_kernel<S, 8, 8, false>);
    } else {
        if constexpr (has_qr_probe<S>())
            if (probe) return f(qr_big_kernel<S, 32, 16, true>);
        return b == 32 ? f(qr_big_kernel<S, 32, 16, false>) : f(qr_big_kernel<S, 16, 16, false>);
    }
}

template <typename S>
int qr_big(int device, const void* A, void* Q, void* R, int batch, int n, int b, int tc,
           int nbuf, void* stream, long long* probe = nullptr) {
    if (!qr_plan_ok<S>(b, tc, nbuf) || (probe && (!has_qr_probe<S>() || b != 32)))
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = tc_smem_bytes<S>(n, b, tc, nbuf);
    return with_qr_kernel<S>(b, probe != nullptr, [&](auto kernel) {
        return launch_tc(device, kernel, batch, smem, stream, static_cast<const S*>(A),
                         static_cast<S*>(Q), static_cast<S*>(R), n, nbuf, probe);
    });
}

template <typename S>
int qr_big_blocks(int device, int n, int b, int tc, int nbuf) {
    if (!qr_plan_ok<S>(b, tc, nbuf)) return -static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = tc_smem_bytes<S>(n, b, tc, nbuf);
    return with_qr_kernel<S>(
        b, false, [&](auto kernel) { return blocks_per_sm(device, kernel, smem); });
}

}  // namespace dq

extern "C" {

int dq_qr_big_f32(int device, const void* A, void* Q, void* R, int batch, int n,
                  int b, int tc, int nbuf, void* stream) {
    return dq::qr_big<float>(device, A, Q, R, batch, n, b, tc, nbuf, stream);
}

int dq_qr_big_f64(int device, const void* A, void* Q, void* R, int batch, int n,
                  int b, int tc, int nbuf, void* stream) {
    return dq::qr_big<double>(device, A, Q, R, batch, n, b, tc, nbuf, stream);
}

int dq_qr_big_c64(int device, const void* A, void* Q, void* R, int batch, int n,
                  int b, int tc, int nbuf, void* stream) {
    return dq::qr_big<dq::cplx<float>>(device, A, Q, R, batch, n, b, tc, nbuf, stream);
}

int dq_qr_big_c128(int device, const void* A, void* Q, void* R, int batch, int n,
                   int b, int tc, int nbuf, void* stream) {
    return dq::qr_big<dq::cplx<double>>(device, A, Q, R, batch, n, b, tc, nbuf, stream);
}

// the same with the phase probe on (float64 and complex64 at b = 32, tc =
// 16): probe (batch x 8 int64) gets each CTA's cycles per phase, total
// cycles and total ns
int dq_qr_big_probe_f64(int device, const void* A, void* Q, void* R, int batch, int n,
                        int b, int tc, int nbuf, void* probe, void* stream) {
    return dq::qr_big<double>(device, A, Q, R, batch, n, b, tc, nbuf, stream,
                              static_cast<long long*>(probe));
}

int dq_qr_big_probe_c64(int device, const void* A, void* Q, void* R, int batch, int n,
                        int b, int tc, int nbuf, void* probe, void* stream) {
    return dq::qr_big<dq::cplx<float>>(device, A, Q, R, batch, n, b, tc, nbuf, stream,
                                       static_cast<long long*>(probe));
}

// CTAs of K7 per SM at this plan (dtype: 0 float32, 1 float64, 2 complex64,
// 3 complex128), or -(cudaError)
int dq_qr_big_blocks_per_sm(int device, int dtype, int n, int b, int tc, int nbuf) {
    switch (dtype) {
        case 0: return dq::qr_big_blocks<float>(device, n, b, tc, nbuf);
        case 1: return dq::qr_big_blocks<double>(device, n, b, tc, nbuf);
        case 2: return dq::qr_big_blocks<dq::cplx<float>>(device, n, b, tc, nbuf);
        default: return dq::qr_big_blocks<dq::cplx<double>>(device, n, b, tc, nbuf);
    }
}

}  // extern "C"
