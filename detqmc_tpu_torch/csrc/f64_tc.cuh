// The float64 one-CTA Householder body on the FP64 tensor cores, shared by
// K3 and K3r (green_solve.cu, the inner solves) and K2 in float64 (qr.cu,
// the refactor QR). One CTA per n x n matrix, n <= 119 (np = n rounded up
// to 8; the matrix is padded with the identity, the companion M with
// zeros, which changes no entry of the top-left n x n block):
//   - A in shared memory at row stride np + 4 (= 4 mod 8 doubles:
//     tc_blocked.cuh's rule for 8-byte elements; A's k-slices for W^T are
//     read as rows q + 4 s, which it keeps free of bank conflicts), the
//     companion M in registers: warp w owns M's column strips w, w + 8,
//     held transposed as mma accumulators, lane (g, q) the entries
//     M[8 rf + 2q + j][8 cf + g]. With the row index of a k-slice taken in
//     the order 2q + s, a transposed accumulator is also an A operand, so
//     Q^T M and the back-substitution chain through registers;
//   - panels of 8 columns in the side buffer V (stride 9, odd: the column
//     walks hit distinct banks) at ONE barrier a column: warp w owns panel
//     column 7 - w; at reflector j every warp whose column is beyond j
//     forms the norm and its dot product with its column (summed in the
//     same butterfly as the norm) and then updates its column itself, so
//     no warp waits for another's s_c. K3c-rhs's panel (two barriers a
//     column, one warp per dot product) was 74 % of its CTA (121 of 165
//     us). One warp owning all eight columns (no barrier at all, nine sums
//     in one butterfly) measured twice as slow, two columns a warp no
//     faster: the chain of each reflector (a warp reduction, a square
//     root, a division) is the bound, not the barrier (the phase probe,
//     solve_timing.py, NVIDIA H100 80GB HBM3, 700 W);
//   - V^T V from one warp's mma chain over the panel's rows, T of the
//     compact-WY form from it (lane r of warp 0 holds row r in registers)
//     while the other warps already form W^T = X^T V for their strips of A
//     and M; then Y^T = W^T T and X^T -= Y^T V^T (mma.sync m8n8k4);
//   - the companion and the epilogue by mode:
//       kDiagM (K3): M = diag(r1), built in registers from r1;
//       kDenseM (K3r): M read from global memory;
//       kIdentityM (K2): M = I, so M ends as Q^T; the epilogue writes
//         R = triu(A) (R_jj = alpha_j, the strict lower triangle exactly
//         0) and Q = (Q^T)^T from the fragments, with no back-substitution;
//     the solves then invert R's 8 x 8 diagonal blocks into the side
//     buffer and run the blocked back-substitution in registers (X_b^T =
//     Z_b^T Dinv_b^T, Z_c^T -= X_b^T R_cb^T), as K3c-rhs;
//   - 40 KB of shared memory at n = 64 and at most 80 registers a thread
//     (launch bounds of 3 CTAs per SM up to np = 64): B = 256 (the Hubbard
//     L = 8 sweep's solve and refactor QR) is one wave, B = 2688 (its
//     unequal-time anchors) seven.
// What bounds it: the panel's chain (np dependent reflectors, each a warp
// reduction, a square root, a division and a barrier); the FP64 tensor
// cores run ~1.1 MFLOP a CTA at n = 64, 0.05 ms for B = 2688 at peak.
// Reflectors, alpha and beta are householder_tc's, up to rounding: R_jj =
// -sign(x_j) ||x||, and a zero column (v = 0) leaves everything unchanged.
#pragma once

#include <type_traits>

#include "tc_blocked.cuh"

namespace dq {

constexpr int kLdV = 9;        // side buffer stride: V, then R's block inverses

// the phase probe's phases of the one-CTA bodies (K3r, K2, K3c-rhs, K2c),
// in the order of their per-CTA records
enum { kTcPanel, kTcApplyA, kTcApplyM, kTcBacksub, kTcBarrier, kTcLoadStore, kTcPhases };

// the companion M of the one-CTA bodies (this one and cplx_tc.cuh)
enum Companion { kDiagM, kDenseM, kIdentityM };

// mirrored by linalg/qr.py f64_smem_bytes
__host__ __device__ constexpr size_t f64_tc_smem_bytes(int n) {
    // A np x (np + 4), the side buffer np x 9, T and V^T V 8 x 9 each,
    // alpha, vhead and beta (8 each)
    return sizeof(double) * (size_t(round_up(n, 8)) * (round_up(n, 8) + 4)
                             + size_t(round_up(n, 8)) * kLdV + 2 * 8 * kLdV + 3 * 8);
}

// kDiagM: M holds r1 (B x n), out = inner^{-1} diag(r1); kDenseM: M is
// B x n x n, out = inner^{-1} M; kIdentityM: M is unused, out = Q and
// R_out = R of inner = Q R
template <int RF, Companion MODE, bool PROBE>
__device__ __forceinline__ void solve_f64_tc(unsigned char* smem, const double* __restrict__ inner,
                                             const double* __restrict__ M,
                                             double* __restrict__ out,
                                             double* __restrict__ R_out, int n,
                                             long long* probe_out) {
    constexpr int NP = 8 * RF, LDA = NP + 4;
    constexpr int CFW = (RF + 7) / 8;   // M strips a warp owns
    constexpr int CAW = RF > 9 ? 2 : 1; // A's trailing strips a warp updates
    double* A = reinterpret_cast<double*>(smem);    // NP x LDA
    double* V = A + NP * LDA;                       // NP x kLdV
    double* T = V + NP * kLdV;                      // 8 x kLdV
    double* SV = T + 8 * kLdV;                      // 8 x kLdV
    double* alpha_s = SV + 8 * kLdV;                // 8
    double* vhead_s = alpha_s + 8;                  // 8
    double* beta_s = vhead_s + 8;                   // 8
    Probe<PROBE, kTcPhases> probe;
    probe.start();
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, q = lane & 3;
    const size_t off = size_t(blockIdx.x) * n * n;

    for (int idx = tid; idx < NP * NP; idx += kThreads) {
        const int r = idx / NP, c = idx - r * NP;
        A[r * LDA + c] = r < n && c < n ? inner[off + size_t(r) * n + c]
                                        : (r == c ? 1.0 : 0.0);
    }
    // this warp's M strips, transposed: Mt[rf][u].c[j] = M[8 rf + 2q + j][8 cf + g]
    Acc<double> Mt[RF][CFW];
#pragma unroll
    for (int u = 0; u < CFW; ++u) {
        const int c = 8 * (warp + 8 * u) + g;
#pragma unroll
        for (int rf = 0; rf < RF; ++rf)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const int r = 8 * rf + 2 * q + j;
                if constexpr (MODE == kDiagM)
                    Mt[rf][u].c[j] = r == c && c < n ? M[size_t(blockIdx.x) * n + c] : 0.0;
                else if constexpr (MODE == kDenseM)
                    Mt[rf][u].c[j] = r < n && c < n ? M[off + size_t(r) * n + c] : 0.0;
                else
                    Mt[rf][u].c[j] = r == c ? 1.0 : 0.0;
            }
    }
    probe.lap(kTcLoadStore);
    __syncthreads();
    probe.lap(kTcBarrier);

#pragma unroll 1
    for (int p = 0; p < RF; ++p) {
        const int j0 = 8 * p;
        // the panel, rows j0.. of columns j0..j0+7, into V (absolute rows)
        for (int idx = tid; idx < (NP - j0) * 8; idx += kThreads) {
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
                double nrm = 0.0, dot = 0.0;
                for (int k = jr + lane; k < NP; k += 32) {
                    const double x = V[k * kLdV + jj];
                    nrm += x * x;
                    if (k > jr) dot += x * V[k * kLdV + cw];
                }
                const double x0 = V[jr * kLdV + jj], xc = V[jr * kLdV + cw];
#pragma unroll
                for (int o = 16; o > 0; o >>= 1) {
                    nrm += __shfl_xor_sync(0xffffffffu, nrm, o);
                    dot += __shfl_xor_sync(0xffffffffu, dot, o);
                }
                const double norm = sqrt_t(nrm);
                const double alpha = householder_alpha(x0, norm);
                const double vtv = 2.0 * norm * (norm + abs_t(x0));
                // a zero column (v == 0) leaves everything unchanged
                const double beta = 2.0 / (vtv == 0.0 ? 1.0 : vtv);
                const double vh = x0 - alpha;
                if (cw > jj) {
                    const double sc = beta * (dot + vh * xc);
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
        // reflectors: v's head on the diagonal, zero above it
        if (tid < 64) {
            const int r = tid >> 3, c = tid & 7;
            const double val = V[(j0 + r) * kLdV + c];
            A[(j0 + r) * LDA + j0 + c] = r < c ? val : r == c ? alpha_s[c] : 0.0;
            if (r <= c) V[(j0 + r) * kLdV + c] = r < c ? 0.0 : vhead_s[c];
        }
        probe.lap(kTcPanel);
        __syncthreads();
        probe.lap(kTcBarrier);
        // warp 0: V^T V (rows j0..; lane (g, q) gives V[r0 + q][g] as both
        // operands), then T: T_rr = beta_r, T_ri = -beta_i sum_{k < i}
        // T_rk (V^T V)_ki, row r in lane r's registers
        if (warp == 0) {
            Acc<double> s0 = acc_zero<double>(), s1 = acc_zero<double>();
            for (int r0 = j0; r0 < NP; r0 += 8) {
                const double a0 = V[(r0 + q) * kLdV + g], a1 = V[(r0 + 4 + q) * kLdV + g];
                mma_acc(s0, a0, a0);
                mma_acc(s1, a1, a1);
            }
            SV[g * kLdV + 2 * q] = s0.c[0] + s1.c[0];
            SV[g * kLdV + 2 * q + 1] = s0.c[1] + s1.c[1];
            __syncwarp();
            if (lane < 8) {
                const int r = lane;
                double t[8];
#pragma unroll
                for (int i = 0; i < 8; ++i) t[i] = i == r ? beta_s[i] : 0.0;
#pragma unroll
                for (int i = 1; i < 8; ++i) {   // no branch: lanes i <= r keep t[i]
                    double acc = 0.0;
#pragma unroll
                    for (int k = 0; k < i; ++k) acc += t[k] * SV[k * kLdV + i];
                    const double ti = -beta_s[i] * acc;
                    t[i] = i > r ? ti : t[i];
                }
#pragma unroll
                for (int i = 0; i < 8; ++i) T[r * kLdV + i] = t[i];
            }
        }
        probe.lap(kTcPanel);
        // W^T = X^T V on A's trailing column strips (k-slices rows q + 4s)
        // and on this warp's M strips (rows 2q + s, the accumulators' order)
        Acc<double> wa[CAW], wm[CFW];
#pragma unroll
        for (int u = 0; u < CAW; ++u) {
            wa[u] = acc_zero<double>();
            const int cf = p + 1 + warp + 8 * u;
            if (cf >= RF) continue;
            Acc<double> w1 = acc_zero<double>();
#pragma unroll
            for (int rf = 0; rf < RF; ++rf)
                if (rf >= p) {
                    const int r = 8 * rf + q;
                    mma_acc(wa[u], A[r * LDA + 8 * cf + g], V[r * kLdV + g]);
                    mma_acc(w1, A[(r + 4) * LDA + 8 * cf + g], V[(r + 4) * kLdV + g]);
                }
            wa[u].c[0] += w1.c[0];
            wa[u].c[1] += w1.c[1];
        }
        probe.lap(kTcApplyA);
#pragma unroll
        for (int u = 0; u < CFW; ++u) {
            wm[u] = acc_zero<double>();
            if (warp + 8 * u >= RF) continue;
            Acc<double> w1 = acc_zero<double>();
#pragma unroll
            for (int rf = 0; rf < RF; ++rf)
                if (rf >= p) {
                    mma_acc(wm[u], Mt[rf][u].c[0], V[(8 * rf + 2 * q) * kLdV + g]);
                    mma_acc(w1, Mt[rf][u].c[1], V[(8 * rf + 2 * q + 1) * kLdV + g]);
                }
            wm[u].c[0] += w1.c[0];
            wm[u].c[1] += w1.c[1];
        }
        probe.lap(kTcApplyM);
        __syncthreads();   // T
        probe.lap(kTcBarrier);
        // Y^T = W^T T, then X^T -= Y^T V^T (rows of V as 8 rf + g)
        auto wy_t = [&](const Acc<double>& w) {
            Acc<double> y = acc_zero<double>();
#pragma unroll
            for (int s = 0; s < 2; ++s) mma_acc(y, w.c[s], T[(2 * q + s) * kLdV + g]);
            return y;
        };
#pragma unroll
        for (int u = 0; u < CAW; ++u) {
            const int cf = p + 1 + warp + 8 * u;
            if (cf >= RF) continue;
            const int c = 8 * cf + g;
            const Acc<double> y = wy_t(wa[u]);
#pragma unroll
            for (int rf = 0; rf < RF; ++rf)
                if (rf >= p) {
                    Acc<double> x;
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
#pragma unroll
        for (int u = 0; u < CFW; ++u) {
            if (warp + 8 * u >= RF) continue;
            const Acc<double> y = wy_t(wm[u]);
#pragma unroll
            for (int rf = 0; rf < RF; ++rf)
                if (rf >= p)
#pragma unroll
                    for (int s = 0; s < 2; ++s)
                        mma_acc(Mt[rf][u], -y.c[s], V[(8 * rf + g) * kLdV + 2 * q + s]);
        }
        probe.lap(kTcApplyM);
        __syncthreads();   // A's strips, V and T are free for the next panel
        probe.lap(kTcBarrier);
    }

    if constexpr (MODE == kIdentityM) {
        // R = triu(A); Q[8 cf + g][8 rf + 2q + j] = Mt[rf][u].c[j] (M = Q^T)
        for (int idx = tid; idx < n * n; idx += kThreads) {
            const int r = idx / n, c = idx - r * n;
            R_out[off + idx] = c >= r ? A[r * LDA + c] : 0.0;
        }
#pragma unroll
        for (int u = 0; u < CFW; ++u) {
            const int row = 8 * (warp + 8 * u) + g;
            if (row >= n) continue;
#pragma unroll
            for (int rf = 0; rf < RF; ++rf)
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    const int c = 8 * rf + 2 * q + j;
                    if (c < n) out[off + size_t(row) * n + c] = Mt[rf][u].c[j];
                }
        }
        probe.lap(kTcLoadStore);
        probe.store(probe_out);
        return;
    }

    // R's diagonal blocks inverted into the side buffer: warp w, lane
    // c < 8 solves column c of block w, w + 8, ...
    for (int rb = warp; rb < RF; rb += kWarps) {
        if (lane < 8) {
            const int c = lane, b0 = 8 * rb;
            double x[8];
#pragma unroll
            for (int j = 7; j >= 0; --j) {
                double acc = j == c ? 1.0 : 0.0;
#pragma unroll
                for (int k = j + 1; k < 8; ++k) acc -= A[(b0 + j) * LDA + b0 + k] * x[k];
                x[j] = acc / A[(b0 + j) * LDA + b0 + j];
            }
#pragma unroll
            for (int j = 0; j < 8; ++j) V[(b0 + j) * kLdV + c] = x[j];
        }
    }
    probe.lap(kTcBacksub);
    __syncthreads();
    probe.lap(kTcBarrier);
    // X = R^{-1} Q^T M by 8-row blocks, descending, in registers
#pragma unroll
    for (int u = 0; u < CFW; ++u) {
        if (warp + 8 * u >= RF) continue;
#pragma unroll
        for (int rb = RF - 1; rb >= 0; --rb) {
            Acc<double> x = acc_zero<double>();
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

// f(std::integral_constant<int, rf>) for rf = 1..LAST (np = 8 rf up to
// 120 by default: kernel_for sends float64 n <= 119 to the one-CTA routes;
// K2 in float32 takes LAST = 16, np = 128), `missing` otherwise
template <int LAST = 15, int RF = 1, typename F>
int with_rf(int rf, int missing, F f) {
    if constexpr (RF > LAST) {
        return missing;
    } else {
        return rf == RF ? f(std::integral_constant<int, RF>{})
                        : with_rf<LAST, RF + 1>(rf, missing, f);
    }
}

}  // namespace dq
