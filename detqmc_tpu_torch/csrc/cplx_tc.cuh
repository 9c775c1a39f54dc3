// The complex one-CTA Householder body, shared by K3c and K3c-rhs
// (green_solve.cu, the complex128 inner solves) and K2c (qr.cu, the complex
// refactor QR in complex64 and complex128): the complex twin of f64_tc.cuh.
// Its FP32-pipe instance also runs on real float (K2 in float32, qr.cu: the
// opdim-1 SDW refactor QR), where each complex operation below is the real
// one. One CTA per n x n matrix (np = n rounded up to 8; the matrix is
// padded with the identity and the companion M with zeros, which changes no
// entry of the top-left n x n block):
//   - A in shared memory at row stride np + pad (complex128, 16-byte
//     elements: np + 1, odd, every fragment pattern below free of bank
//     conflicts; complex64, 8-byte elements: np + 2, so that the fragment
//     rows 2q + s of a half-warp fall on distinct banks; float32, 4-byte
//     elements: np + 4, 4 or 12 mod 16, so that the rows 2q + s of a warp
//     start 8 banks apart), M in registers:
//     warp w owns M's column strips w, w + 8, held transposed, lane (g, q)
//     the entries M[8 rf + 2q + j][8 cf + g] (the mma accumulators'
//     layout). With the row index of a k-slice taken in the order 2q + s
//     (any order of the k sum is the same sum), a transposed accumulator
//     is also an mma A operand, so Q^H M and the back-substitution chain
//     through registers with no shuffle and no CTA barrier;
//   - panels of 8 columns factored in a side buffer V (stride 9, odd: the
//     column walks hit distinct banks) at ONE barrier a column: warp w
//     owns panel column 7 - w; at reflector j every warp whose column is
//     beyond j forms the norm, v^H v = 2 ||x|| (||x|| + |x_0|) and its dot
//     product with its column in one butterfly and updates its column
//     itself, so no warp waits for another's s_c; T of the compact-WY form
//     from V^H V (one warp per pair). The complex128 panel at two barriers
//     a column (one warp per dot product) took 121 of K3c-rhs's 165 us a
//     CTA; this one 95 of 141 (K3c: 76 of 114; the probe, solve_timing.py,
//     NVIDIA H100 80GB HBM3, 700 W);
//   - per panel, each warp applies I - V T^H V^H to its M strips and to
//     one trailing column strip of A (wy_strip, the one step that differs
//     between the types): complex128 as mma.sync m8n8k4 products on the
//     FP64 tensor cores (four real ones a complex one), complex64 and
//     float32 on the FP32 pipe, fused multiply-adds with no TF32 (the H100
//     SXM's FP32 FMA peak equals its FP64 tensor-core peak, ~67 TFLOP/s;
//     TF32's 10-bit mantissa would break the float32 tolerances);
//   - the companion and the epilogue by mode (Companion, f64_tc.cuh):
//       kDiagM (K3c): M = diag(r1), built in registers from r1;
//       kDenseM (K3c-rhs): M read from global memory;
//       kIdentityM (K2c, K2 in float32): M = I, so M ends as Q^H; the
//         epilogue writes
//         R = triu(A) (R_jj = alpha_j, the strict lower triangle exactly
//         0) and Q = (Q^H)^H from the fragments, with no
//         back-substitution;
//     the solves then invert R's 8 x 8 diagonal blocks into the side
//     buffer and run the blocked back-substitution in registers (X_b^T =
//     Z_b^T Dinv_b^T, Z_c^T -= X_b^T R_cb^T) on the tensor cores;
//   - complex128: 77 KB of shared memory at n = 64, two CTAs per SM;
//     complex64: 39 KB at n = 64, 124 KB at n = 119 (the one-CTA route's
//     limit); float32: 20 KB at n = 64, 71 KB at n = 128 (its limit, RF =
//     16: Q^T's 16 strips, two a warp, in 64 registers a thread).
// What bounds it: the panel's chain (np dependent reflectors, each a warp
// reduction, a square root, a division and a barrier): 58 of K2c's 93 us
// a CTA in complex64 at n = 64, its products 29 (the probe,
// solve_timing.py, NVIDIA H100 80GB HBM3, 700 W). Reflectors, alpha and
// beta are householder_tc's
// up to rounding: R_jj = -(x_j/|x_j|) ||x|| (complex) or -sign(x_j) ||x||
// (real), and a zero column (v = 0) leaves everything unchanged.
#pragma once

#include "f64_tc.cuh"

namespace dq {

// A's row stride is np + ctc_pad<S>() (the note above)
template <typename S>
__host__ __device__ constexpr int ctc_pad() {
    return sizeof(S) == 16 ? 1 : sizeof(S) == 8 ? 2 : 4;
}

// mirrored by linalg/green_solve.py rhs_smem_bytes (complex128) and
// linalg/qr.py complex_smem_bytes (complex64, complex128 and float32)
template <typename S>
__host__ __device__ constexpr size_t ctc_smem_bytes(int n) {
    // A np x (np + pad), the side buffer np x 9, T and V^H V 8 x 9 each,
    // alpha and vhead (8 each) and beta (8 reals)
    return sizeof(S) * (size_t(round_up(n, 8)) * (round_up(n, 8) + ctc_pad<S>())
                        + size_t(round_up(n, 8)) * kLdV + 2 * 8 * kLdV + 2 * 8)
           + sizeof(typename real_of<S>::type) * 8;
}

// X <- X - V T^H V^H X on one strip of 8 columns of X that the warp holds
// transposed: lane (g, q) reads X[8 rf + 2q + s][8 cf + g] as get(rf, s)
// and writes it back with set(rf, s, x); rows from panel p on (V is zero
// above its panel's rows, T upper triangular).
//   complex128, on the FP64 tensor cores: W^T = X^T conj(V), Y^T = W^T
//     conj(T), X^T -= Y^T V^T (mma.sync m8n8k4);
//   complex64 and float32, on the FP32 pipe: each lane forms its column's
//     w = V^H x
//     over its own rows, the column's four lanes sum them in two butterfly
//     steps (each lane gets the same bits), then y = T^H w and x -= V y.
template <int RF, typename S, typename Get, typename Set>
__device__ __forceinline__ void wy_strip(int p, const S* V, const S* T, Get get, Set set) {
    const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
    if constexpr (on_tensor_cores<S>()) {
        Acc<S> w[2] = {acc_zero<S>(), acc_zero<S>()};
#pragma unroll
        for (int rf = 0; rf < RF; ++rf)
            if (rf >= p)
#pragma unroll
                for (int s = 0; s < 2; ++s)
                    mma_acc(w[s], get(rf, s), conj_(V[(8 * rf + 2 * q + s) * kLdV + g]));
        Acc<S> y = acc_zero<S>();
#pragma unroll
        for (int s = 0; s < 2; ++s)
            mma_acc(y, w[0].c[s] + w[1].c[s], conj_(T[(2 * q + s) * kLdV + g]));
#pragma unroll
        for (int rf = 0; rf < RF; ++rf)
            if (rf >= p) {
                Acc<S> x;
                x.c[0] = get(rf, 0);
                x.c[1] = get(rf, 1);
#pragma unroll
                for (int s = 0; s < 2; ++s)
                    mma_acc(x, -y.c[s], V[(8 * rf + g) * kLdV + 2 * q + s]);
                set(rf, 0, x.c[0]);
                set(rf, 1, x.c[1]);
            }
    } else {
        using R = typename real_of<S>::type;
        const S zero = from_real<S>(R(0));
        S w[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) w[i] = zero;
#pragma unroll
        for (int rf = 0; rf < RF; ++rf)
            if (rf >= p)
#pragma unroll
                for (int s = 0; s < 2; ++s) {
                    const S x = get(rf, s);
                    const S* v = V + (8 * rf + 2 * q + s) * kLdV;
#pragma unroll
                    for (int i = 0; i < 8; ++i) mac_conj(w[i], v[i], x);
                }
#pragma unroll
        for (int o = 1; o < 4; o <<= 1)
#pragma unroll
            for (int i = 0; i < 8; ++i) add_xor(w[i], o);
        // -y = -T^H w (T upper triangular)
        S y[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            S acc = zero;
#pragma unroll
            for (int k = 0; k <= i; ++k) mac_conj(acc, T[k * kLdV + i], w[k]);
            y[i] = -acc;
        }
#pragma unroll
        for (int rf = 0; rf < RF; ++rf)
            if (rf >= p)
#pragma unroll
                for (int s = 0; s < 2; ++s) {
                    S x = get(rf, s);
                    const S* v = V + (8 * rf + 2 * q + s) * kLdV;
#pragma unroll
                    for (int i = 0; i < 8; ++i) mac(x, v[i], y[i]);
                    set(rf, s, x);
                }
    }
}

// kDiagM: M holds r1 (B x n reals), out = inner^{-1} diag(r1); kDenseM: M
// is B x n x n of S, out = inner^{-1} M; kIdentityM: M is unused, out = Q
// and R_out = R of inner = Q R. The solves are complex128 only (their
// back-substitution runs on the tensor cores); S = float runs kIdentityM.
template <typename S, int RF, int CFW, Companion MODE, bool PROBE>
__device__ __forceinline__ void solve_cplx_tc(unsigned char* smem_raw,
                                              const S* __restrict__ inner,
                                              const void* __restrict__ M_in,
                                              S* __restrict__ out, S* __restrict__ R_out,
                                              int n, long long* probe_out) {
    using R = typename real_of<S>::type;
    static_assert(MODE == kIdentityM || on_tensor_cores<S>(),
                  "the solves run in complex128");
    constexpr int NP = 8 * RF, LDA = NP + ctc_pad<S>();
    S* A = reinterpret_cast<S*>(smem_raw);          // NP x LDA
    S* V = A + NP * LDA;                            // NP x kLdV
    S* T = V + NP * kLdV;                           // 8 x kLdV
    S* SV = T + 8 * kLdV;                           // 8 x kLdV
    S* alpha_s = SV + 8 * kLdV;                     // 8
    S* vhead_s = alpha_s + 8;                       // 8
    R* beta_s = reinterpret_cast<R*>(vhead_s + 8);  // 8
    Probe<PROBE, kTcPhases> probe;
    probe.start();
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, q = lane & 3;
    const S zero = from_real<S>(R(0)), one = from_real<S>(R(1));
    const size_t off = size_t(blockIdx.x) * n * n;

    for (int idx = tid; idx < NP * NP; idx += kThreads) {
        const int r = idx / NP, c = idx - r * NP;
        A[r * LDA + c] = r < n && c < n ? inner[off + size_t(r) * n + c]
                                        : (r == c ? one : zero);
    }
    // this warp's M strips, transposed: Mt[rf][u].c[j] = M[8 rf + 2q + j][8 cf + g]
    Acc<S> Mt[RF][CFW];
#pragma unroll
    for (int u = 0; u < CFW; ++u) {
        const int c = 8 * (warp + 8 * u) + g;
#pragma unroll
        for (int rf = 0; rf < RF; ++rf)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const int r = 8 * rf + 2 * q + j;
                if constexpr (MODE == kDiagM)
                    Mt[rf][u].c[j] = r == c && c < n
                        ? from_real<S>(static_cast<const R*>(M_in)[size_t(blockIdx.x) * n + c])
                        : zero;
                else if constexpr (MODE == kDenseM)
                    Mt[rf][u].c[j] = r < n && c < n
                        ? static_cast<const S*>(M_in)[off + size_t(r) * n + c] : zero;
                else
                    Mt[rf][u].c[j] = r == c ? one : zero;
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
                R nrm = R(0);
                S dot = zero;
                for (int k = jr + lane; k < NP; k += 32) {
                    const S x = V[k * kLdV + jj];
                    nrm += abs2(x);
                    if (k > jr) dot += conj_(x) * V[k * kLdV + cw];
                }
                const S x0 = V[jr * kLdV + jj], xc = V[jr * kLdV + cw];
#pragma unroll
                for (int o = 16; o > 0; o >>= 1) {
                    add_xor(nrm, o);
                    add_xor(dot, o);
                }
                const R norm = sqrt_t(nrm);
                const S alpha = householder_alpha(x0, norm);
                const R vtv = R(2) * norm * (norm + sqrt_t(abs2(x0)));
                // a zero column (v == 0) leaves everything unchanged
                const R beta = R(2) / (vtv == R(0) ? R(1) : vtv);
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
            T[r * kLdV + r] = from_real<S>(beta_s[r]);
            for (int i = r + 1; i < 8; ++i) {
                S acc = zero;
                for (int k = r; k < i; ++k) acc += T[r * kLdV + k] * SV[k * kLdV + i];
                T[r * kLdV + i] = (-beta_s[i]) * acc;
            }
        }
        probe.lap(kTcPanel);
        __syncthreads();
        probe.lap(kTcBarrier);
        // A's trailing column strips, one per warp
        for (int cf = p + 1 + warp; cf < RF; cf += kWarps) {
            S* col = A + 2 * q * LDA + 8 * cf + g;   // X[8 rf + 2q + s] at col[(8 rf + s) LDA]
            wy_strip<RF>(p, V, T,
                         [&](int rf, int s) { return col[(8 * rf + s) * LDA]; },
                         [&](int rf, int s, S x) { col[(8 * rf + s) * LDA] = x; });
        }
        probe.lap(kTcApplyA);
        // this warp's M strips, in registers
#pragma unroll
        for (int u = 0; u < CFW; ++u) {
            if (warp + 8 * u >= RF) continue;
            wy_strip<RF>(p, V, T, [&](int rf, int s) { return Mt[rf][u].c[s]; },
                         [&](int rf, int s, S x) { Mt[rf][u].c[s] = x; });
        }
        probe.lap(kTcApplyM);
        __syncthreads();   // A's strips and V are free for the next panel
        probe.lap(kTcBarrier);
    }

    if constexpr (MODE == kIdentityM) {
        // R = triu(A); Q[8 cf + g][8 rf + 2q + j] = conj(Mt[rf][u].c[j]) (M = Q^H)
        for (int idx = tid; idx < n * n; idx += kThreads) {
            const int r = idx / n, c = idx - r * n;
            R_out[off + idx] = c >= r ? A[r * LDA + c] : zero;
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
                    if (c < n) out[off + size_t(row) * n + c] = conj_(Mt[rf][u].c[j]);
                }
        }
        probe.lap(kTcLoadStore);
    } else {
        // R's diagonal blocks inverted into the side buffer: warp w, lane
        // c < 8 solves column c of block w, w + 8, ...
        for (int rb = warp; rb < RF; rb += kWarps) {
            if (lane < 8) {
                const int c = lane, b0 = 8 * rb;
                S x[8];
#pragma unroll
                for (int j = 7; j >= 0; --j) {
                    S acc = j == c ? one : zero;
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
    }
    probe.store(probe_out);
}

}  // namespace dq
