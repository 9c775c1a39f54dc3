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
//     dense M): solve_c128_tc below (its note), behind two kernel names.
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

#include "f64_tc.cuh"

namespace dq {

// ---- K3c and K3c-rhs: the complex128 solves on the tensor cores ---------
// X = inner^{-1} M for complex128 n <= 83 (the one-CTA route of
// kernel_for), one CTA per matrix, M = diag(r1) (K3c, built in registers:
// no dense M in global memory) or dense (K3c-rhs). The first design held A
// and M in shared memory, 133 KB at n = 64, one CTA per SM: 11 waves of
// 452 us at B = 1408, 70 % of it the reflectors' application to A and M
// with both operands of every multiply-add read from shared memory, 15 %
// warp 0's serial norms behind three barriers a column, 13 % a
// back-substitution that kept 64 of 256 threads busy (the phase probe,
// solve_timing.py, NVIDIA H100 80GB HBM3, 700 W). This design (np = n
// rounded up to 8; inner is padded with the identity and M with zeros,
// which changes no entry of X):
//   - A in shared memory at an odd row stride (np + 1: every fragment
//     pattern below is free of bank conflicts for 16-byte elements), M in
//     registers: warp w owns M's column fragments w, w + 8, ... and holds
//     them transposed as mma accumulators, lane (g, q) the entries
//     M[8 rf + 2q + j][8 cf + g]. With the row index of a k-slice taken
//     in the order 2q + s (any order of the k sum is the same sum), a
//     transposed accumulator is also an A operand, so Q^H M and the
//     back-substitution chain through registers with no shuffle and no
//     CTA barrier;
//   - panels of 8 columns factored in a side buffer V (stride 9) at ONE
//     barrier a column, as the float64 body (f64_tc.cuh): warp w owns
//     panel column 7 - w, forms the norm, v^H v = 2 ||x|| (||x|| + |x_0|)
//     and its dot product with its column in one butterfly and updates
//     its column itself; T of the compact-WY form from V^H V (one warp per
//     pair). The first panel (two barriers a column, one warp per dot
//     product) took 121 of K3c-rhs's 165 us a CTA; this one 95 of 141
//     (K3c: 76 of 114; the probe, solve_timing.py, NVIDIA H100 80GB HBM3,
//     700 W). Warp 0 alone, with no CTA barrier in the panel, measured
//     slower (218 against 120 us of panel per CTA): the seven dot products
//     serialize in one warp;
//   - per panel, each warp applies I - V T^H V^H to its M strip and to
//     one trailing column strip of A as mma.sync m8n8k4 products
//     (complex128 as four real ones): W^T = X^T conj(V), Y^T = W^T
//     conj(T), X^T -= Y^T V^T;
//   - the back-substitution by 8-row blocks, descending: R's diagonal
//     blocks inverted once into shared memory (the side buffer), then per
//     block X_b^T = Z_b^T Dinv_b^T and Z_c^T -= X_b^T R_cb^T, all in
//     registers;
//   - 77 KB of shared memory at n = 64: two CTAs per SM (B = 128, sdw_l4's
//     sweep, is one wave; B = 1408, its unequal-time anchors, six).
// Reflectors, alpha and beta are householder_tc's, up to rounding.
__host__ __device__ constexpr size_t rhs_tc_smem_bytes(int n) {
    // A np x (np + 1), the side buffer np x 9, T and V^H V 8 x 9 each,
    // alpha and vhead (8 each) and beta (8 doubles)
    return sizeof(cplx<double>) * (size_t(round_up(n, 8)) * (round_up(n, 8) + 1)
                                   + size_t(round_up(n, 8)) * kLdV + 2 * 8 * kLdV + 2 * 8)
           + sizeof(double) * 8;
}

// DIAG: M holds r1 (B x n doubles), out = inner^{-1} diag(r1); else M is
// B x n x n complex128, out = inner^{-1} M
template <int RF, int CFW, bool DIAG, bool PROBE>
__device__ __forceinline__ void solve_c128_tc(unsigned char* smem_raw,
                                              const cplx<double>* __restrict__ inner,
                                              const void* __restrict__ M_in,
                                              cplx<double>* __restrict__ out, int n,
                                              long long* probe_out) {
    using S = cplx<double>;
    constexpr int NP = 8 * RF, LDA = NP + 1;
    S* A = reinterpret_cast<S*>(smem_raw);          // NP x LDA
    S* V = A + NP * LDA;                            // NP x kLdV
    S* T = V + NP * kLdV;                           // 8 x kLdV
    S* SV = T + 8 * kLdV;                           // 8 x kLdV
    S* alpha_s = SV + 8 * kLdV;                     // 8
    S* vhead_s = alpha_s + 8;                       // 8
    double* beta_s = reinterpret_cast<double*>(vhead_s + 8);   // 8
    Probe<PROBE, kTcPhases> probe;
    probe.start();
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, q = lane & 3;
    const S zero = mk(0.0, 0.0);
    const size_t off = size_t(blockIdx.x) * n * n;

    for (int idx = tid; idx < NP * NP; idx += kThreads) {
        const int r = idx / NP, c = idx - r * NP;
        A[r * LDA + c] = r < n && c < n ? inner[off + size_t(r) * n + c]
                                        : mk(r == c ? 1.0 : 0.0, 0.0);
    }
    // this warp's M strip, transposed: Mt[rf][u].c[j] = M[8 rf + 2q + j][8 cf + g]
    Acc<S> Mt[RF][CFW];
#pragma unroll
    for (int u = 0; u < CFW; ++u) {
        const int c = 8 * (warp + 8 * u) + g;
#pragma unroll
        for (int rf = 0; rf < RF; ++rf)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const int r = 8 * rf + 2 * q + j;
                if constexpr (DIAG)
                    Mt[rf][u].c[j] = r == c && c < n
                        ? mk(static_cast<const double*>(M_in)[size_t(blockIdx.x) * n + c], 0.0)
                        : zero;
                else
                    Mt[rf][u].c[j] = r < n && c < n
                        ? static_cast<const S*>(M_in)[off + size_t(r) * n + c] : zero;
            }
    }
    probe.lap(kTcLoadStore);
    __syncthreads();
    probe.lap(kTcBarrier);

#pragma unroll 1
    for (int p = 0; p < RF; ++p) {
        const int j0 = 8 * p, mp = NP - j0;
        // the panel, rows j0.. of columns j0..j0+7, into V (absolute rows)
        for (int idx = tid; idx < mp * 8; idx += kThreads) {
            const int r = j0 + (idx >> 3), c = idx & 7;
            V[r * kLdV + c] = A[r * LDA + j0 + c];
        }
        probe.lap(kTcPanel);
        __syncthreads();
        probe.lap(kTcBarrier);
        // reflector jj: warp w owns panel column cw = 7 - w; the warps with
        // cw > jj form the norm and their dot product in one butterfly and
        // update their column; warp 0 (column 7, thread 0) records alpha,
        // beta and v's head, also at jj = 7
        const int cw = 7 - warp;
        for (int jj = 0; jj < 8; ++jj) {
            const int jr = j0 + jj;   // the pivot row
            if (cw > jj || warp == 0) {
                double nrm = 0.0;
                S dot = zero;
                for (int k = jr + lane; k < NP; k += 32) {
                    const S x = V[k * kLdV + jj];
                    nrm += abs2(x);
                    if (k > jr) dot += conj_(x) * V[k * kLdV + cw];
                }
                const S x0 = V[jr * kLdV + jj], xc = V[jr * kLdV + cw];
#pragma unroll
                for (int o = 16; o > 0; o >>= 1) {
                    nrm += __shfl_xor_sync(0xffffffffu, nrm, o);
                    dot.re += __shfl_xor_sync(0xffffffffu, dot.re, o);
                    dot.im += __shfl_xor_sync(0xffffffffu, dot.im, o);
                }
                const double norm = sqrt_t(nrm);
                const S alpha = householder_alpha(x0, norm);
                const double vtv = 2.0 * norm * (norm + sqrt_t(abs2(x0)));
                // a zero column (v == 0) leaves everything unchanged
                const double beta = 2.0 / (vtv == 0.0 ? 1.0 : vtv);
                const S vh = x0 - alpha;
                if (cw > jj) {
                    const S sc = beta * (dot + conj_(vh) * xc);
                    __syncwarp();   // every lane has read V[jr][cw]
                    for (int k = jr + lane; k < NP; k += 32)
                        V[k * kLdV + cw] -= (k == jr ? vh : V[k * kLdV + jj]) * sc;
                }
                if (tid == 0) {
                    alpha_s[jj] = alpha;
                    beta_s[jj] = beta;
                    vhead_s[jj] = vh;
                }
            }
            probe.lap(kTcPanel);
            __syncthreads();
            probe.lap(kTcBarrier);
        }
        // R's diagonal block to A (strict lower part 0); V keeps the
        // reflectors: v's head on the diagonal, zero above it. Meanwhile
        // (V^H V)_ki for k < i, one warp per pair: rows from j0 + i, where
        // reflector i starts (its head from vhead_s, as V's diagonal is
        // being written)
        if (tid < 64) {
            const int r = tid >> 3, c = tid & 7;
            const S val = V[(j0 + r) * kLdV + c];
            A[(j0 + r) * LDA + j0 + c] = r < c ? val : r == c ? alpha_s[c] : zero;
            if (r <= c) V[(j0 + r) * kLdV + c] = r < c ? zero : vhead_s[c];
        }
        for (int pr = warp; pr < 28; pr += kWarps) {
            int i = 1, k = pr;
            while (k >= i) k -= i++;
            S d = zero;
            for (int rr = j0 + i + lane; rr < NP; rr += 32)
                d += conj_(V[rr * kLdV + k]) * (rr == j0 + i ? vhead_s[i] : V[rr * kLdV + i]);
            d = warp_sum(d);
            if (lane == 0) SV[k * kLdV + i] = d;
        }
        probe.lap(kTcPanel);
        __syncthreads();
        probe.lap(kTcBarrier);
        // T of the compact-WY form: lane r of warp 0 fills row r,
        // T_rr = beta_r, T_ri = -beta_i sum_{r <= k < i} T_rk (V^H V)_ki
        if (warp == 0 && lane < 8) {
            const int r = lane;
            for (int i = 0; i < 8; ++i) T[r * kLdV + i] = zero;
            T[r * kLdV + r] = mk(beta_s[r], 0.0);
            for (int i = r + 1; i < 8; ++i) {
                S acc = zero;
                for (int k = r; k < i; ++k) acc += T[r * kLdV + k] * SV[k * kLdV + i];
                T[r * kLdV + i] = (-beta_s[i]) * acc;
            }
        }
        probe.lap(kTcPanel);
        __syncthreads();
        probe.lap(kTcBarrier);
        // X <- X - V T^H V^H X on a transposed strip X^T (8 columns of X
        // as fragment rows): W^T = X^T conj(V), Y^T = W^T conj(T),
        // X^T -= Y^T V^T. xt(rf, s) gives this lane's A operand
        // X^T[g][8 rf + 2q + s]
        auto wy = [&](auto xt) {
            Acc<S> w[2] = {acc_zero<S>(), acc_zero<S>()};
#pragma unroll
            for (int rf = 0; rf < RF; ++rf)
                if (rf >= p)
#pragma unroll
                    for (int s = 0; s < 2; ++s)
                        mma_acc(w[s], xt(rf, s), conj_(V[(8 * rf + 2 * q + s) * kLdV + g]));
            Acc<S> y = acc_zero<S>();
#pragma unroll
            for (int s = 0; s < 2; ++s) {
                mma_acc(y, w[0].c[s] + w[1].c[s], conj_(T[(2 * q + s) * kLdV + g]));
            }
            return y;
        };
        // A's trailing column strips, one per warp
        for (int cf = p + 1 + warp; cf < RF; cf += kWarps) {
            const int c = 8 * cf + g;
            const Acc<S> y = wy([&](int rf, int s) { return A[(8 * rf + 2 * q + s) * LDA + c]; });
#pragma unroll
            for (int rf = 0; rf < RF; ++rf)
                if (rf >= p) {
                    Acc<S> x;
                    x.c[0] = A[(8 * rf + 2 * q) * LDA + c];
                    x.c[1] = A[(8 * rf + 2 * q + 1) * LDA + c];
#pragma unroll
                    for (int s = 0; s < 2; ++s)
                        mma_acc(x, -y.c[s], V[(8 * rf + g) * kLdV + 2 * q + s]);
                    A[(8 * rf + 2 * q) * LDA + c] = x.c[0];
                    A[(8 * rf + 2 * q + 1) * LDA + c] = x.c[1];
                }
        }
        probe.lap(kTcApplyA);
        // this warp's M strip, in registers
#pragma unroll
        for (int u = 0; u < CFW; ++u) {
            if (warp + 8 * u >= RF) continue;
            const Acc<S> y = wy([&](int rf, int s) { return Mt[rf][u].c[s]; });
#pragma unroll
            for (int rf = 0; rf < RF; ++rf)
                if (rf >= p)
#pragma unroll
                    for (int s = 0; s < 2; ++s)
                        mma_acc(Mt[rf][u], -y.c[s], V[(8 * rf + g) * kLdV + 2 * q + s]);
        }
        probe.lap(kTcApplyM);
        __syncthreads();   // A's strips and V are free for the next panel
        probe.lap(kTcBarrier);
    }

    // R's diagonal blocks inverted into the side buffer: warp w, lane
    // c < 8 solves column c of block w, w + 8, ...
    for (int rb = warp; rb < RF; rb += kWarps) {
        if (lane < 8) {
            const int c = lane, b0 = 8 * rb;
            S x[8];
#pragma unroll
            for (int j = 7; j >= 0; --j) {
                S acc = mk(j == c ? 1.0 : 0.0, 0.0);
#pragma unroll
                for (int k = j + 1; k < 8; ++k) acc -= A[(b0 + j) * LDA + b0 + k] * x[k];
                x[j] = div_s(acc, A[(b0 + j) * LDA + b0 + j]);
            }
#pragma unroll
            for (int j = 0; j < 8; ++j) V[(b0 + j) * kLdV + c] = x[j];
        }
    }
    probe.lap(kTcBacksub);
    __syncthreads();
    probe.lap(kTcBarrier);
    // X = R^{-1} Q^H M by 8-row blocks, descending, in registers
#pragma unroll
    for (int u = 0; u < CFW; ++u) {
        if (warp + 8 * u >= RF) continue;
#pragma unroll
        for (int rb = RF - 1; rb >= 0; --rb) {
            Acc<S> x = acc_zero<S>();
#pragma unroll
            for (int s = 0; s < 2; ++s)
                mma_acc(x, Mt[rb][u].c[s], V[(8 * rb + g) * kLdV + 2 * q + s]);
            Mt[rb][u] = x;
#pragma unroll
            for (int rc = 0; rc < rb; ++rc)
#pragma unroll
                for (int s = 0; s < 2; ++s)
                    mma_acc(Mt[rc][u], -x.c[s], A[(8 * rc + g) * LDA + 8 * rb + 2 * q + s]);
        }
    }
    probe.lap(kTcBacksub);
#pragma unroll
    for (int u = 0; u < CFW; ++u) {
        const int c = 8 * (warp + 8 * u) + g;
        if (c >= n) continue;
#pragma unroll
        for (int rf = 0; rf < RF; ++rf)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const int r = 8 * rf + 2 * q + j;
                if (r < n) out[off + size_t(r) * n + c] = Mt[rf][u].c[j];
            }
    }
    probe.lap(kTcLoadStore);
    probe.store(probe_out);
}

// distinct names, so a profile tells K3c from K3c-rhs (K3c takes K3c-rhs's
// arguments, its probe pointer unused, so one launch serves both)
template <int RF, int CFW>
__global__ void __launch_bounds__(kThreads, CFW == 1 ? 2 : 1)
solve_inner_c128_tc_kernel(const cplx<double>* __restrict__ inner,
                           const double* __restrict__ r1,
                           cplx<double>* __restrict__ mid, int n, long long*) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    solve_c128_tc<RF, CFW, true, false>(smem_raw, inner, r1, mid, n, nullptr);
}

template <int RF, int CFW, bool PROBE>
__global__ void __launch_bounds__(kThreads, CFW == 1 ? 2 : 1)
solve_inner_rhs_tc_kernel(const cplx<double>* __restrict__ inner,
                          const cplx<double>* __restrict__ rhs,
                          cplx<double>* __restrict__ out, int n, long long* probe_out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    solve_c128_tc<RF, CFW, false, PROBE>(smem_raw, inner, rhs, out, n, probe_out);
}

// f(kernel) for the K3c (rhs = 0) or K3c-rhs instance of np = 8 rf, rf =
// 1..11 (kernel_for sends n <= 83 here; with the probe: K3c-rhs at rf = 8
// only, the sdw_l4 shape), `missing` if there is none
template <bool PROBE, typename F>
int with_c128_tc(int rf, bool rhs, int missing, F f) {
    if constexpr (PROBE) {
        return rhs && rf == 8 ? f(solve_inner_rhs_tc_kernel<8, 1, true>) : missing;
    } else {
        return with_f64_rf(rf, missing, [&](auto R) {
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
            return launch_tc(device, kernel, batch, rhs_tc_smem_bytes(n), stream,
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
        return with_f64_rf(round_up(n, 8) / 8, missing, [&](auto R) {
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
            return dq::blocks_per_sm(device, kernel, dq::rhs_tc_smem_bytes(n));
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
