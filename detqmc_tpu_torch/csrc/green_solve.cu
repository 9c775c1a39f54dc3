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
// Three kernels:
//   - K3c (complex128, M = diag(r1)): solve_resident below, A and M in
//     shared memory, one reflector at a time (householder_apply), then a
//     back-substitution with one thread per column of M. Shared memory
//     2 n (n+1) values (133 KB at n = 64); what bounds it: the n dependent
//     reflector steps and the n-deep back-substitution chain per column;
//   - K3c-rhs (complex128, dense M): solve_inner_rhs_tc_kernel, the same
//     solve on the FP64 tensor cores (its note below);
//   - K3 and K3r (float64, M = diag(r1) or dense): the float64 twin of
//     K3c-rhs, solve_f64_tc (its note below), which replaced
//     solve_resident for both: its probe put 75 % of a CTA's 455 us in
//     the reflectors' application (64 steps of three barriers each, both
//     operands of every multiply-add read from shared memory; NVIDIA H100
//     80GB HBM3, 700 W). Per CTA at n = 64 this design takes 71-82 us,
//     69 % of it the panel.
// r1 is real in every case; a dense RHS has inner's type.
#include <type_traits>

#include "tc_blocked.cuh"

namespace dq {

// householder_apply on A and M resident in shared memory, then the
// back-substitution X = R^{-1} M with R_jj = alpha_j, in place in M: one
// thread per column of M walks j = n-1 .. 0, so no CTA barrier is needed
// (each thread reads only the rows of its own column that it has already
// solved). The complex division is M conj(a) / |a|^2. Then M -> out.
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

// ---- K3c-rhs: the complex128 dense-RHS solve on the tensor cores ---------
// X = inner^{-1} M for complex128 n <= 83 (the one-CTA route of
// kernel_for), one CTA per matrix. The first design (solve_resident above,
// which K3c keeps) held A and M in shared memory, 133 KB at
// n = 64, one CTA per SM: 11 waves of 452 us at B = 1408, 70 % of it the
// reflectors' application to A and M with both operands of every
// multiply-add read from shared memory, 15 % warp 0's serial norms behind
// three barriers a column, 13 % a back-substitution that kept 64 of 256
// threads busy (the phase probe, solve_timing.py, NVIDIA H100 80GB HBM3,
// 700 W). This design (np = n rounded up to 8; inner is padded with the
// identity and M with zeros, which changes no entry of X):
//   - A in shared memory at an odd row stride (np + 1: every fragment
//     pattern below is free of bank conflicts for 16-byte elements), M in
//     registers: warp w owns M's column fragments w, w + 8, ... and holds
//     them transposed as mma accumulators, lane (g, q) the entries
//     M[8 rf + 2q + j][8 cf + g]. With the row index of a k-slice taken
//     in the order 2q + s (any order of the k sum is the same sum), a
//     transposed accumulator is also an A operand, so Q^H M and the
//     back-substitution chain through registers with no shuffle and no
//     CTA barrier;
//   - panels of 8 columns factored in a side buffer V (stride 9) at two
//     barriers a column, every warp forming the norm and v^H v = 2 ||x||
//     (||x|| + |x_0|) itself (householder_tc's panel), one warp per
//     column for the dot products; T of the compact-WY form from V^H V
//     (one warp per pair). The panel is most of the time left (the
//     probe: 74 %), but warp 0 alone, with no CTA barrier in the panel,
//     measured slower (218 against 120 us of panel per CTA): the seven
//     dot products serialize in one warp;
//   - per panel, each warp applies I - V T^H V^H to its M strip and to
//     one trailing column strip of A as mma.sync m8n8k4 products
//     (complex128 as four real ones): W^T = X^T conj(V), Y^T = W^T
//     conj(T), X^T -= Y^T V^T;
//   - the back-substitution by 8-row blocks, descending: R's diagonal
//     blocks inverted once into shared memory (the side buffer), then per
//     block X_b^T = Z_b^T Dinv_b^T and Z_c^T -= X_b^T R_cb^T, all in
//     registers;
//   - 77 KB of shared memory at n = 64: two CTAs per SM.
// Reflectors, alpha and beta are householder_tc's, up to rounding.
constexpr int kLdV = 9;        // side buffer stride: V, then R's block inverses

enum { kTcPanel, kTcApplyA, kTcApplyM, kTcBacksub, kTcBarrier, kTcLoadStore, kTcPhases };

__host__ __device__ constexpr size_t rhs_tc_smem_bytes(int n) {
    // A np x (np + 1), the side buffer np x 9, T and V^H V 8 x 9 each,
    // alpha, vhead, s (8 each) and beta (8 doubles)
    return sizeof(cplx<double>) * (size_t(round_up(n, 8)) * (round_up(n, 8) + 1)
                                   + size_t(round_up(n, 8)) * kLdV + 2 * 8 * kLdV + 3 * 8)
           + sizeof(double) * 8;
}

template <int RF, int CFW, bool PROBE>
__global__ void __launch_bounds__(kThreads, CFW == 1 ? 2 : 1)
solve_inner_rhs_tc_kernel(const cplx<double>* __restrict__ inner,
                          const cplx<double>* __restrict__ rhs,
                          cplx<double>* __restrict__ out, int n, long long* probe_out) {
    using S = cplx<double>;
    constexpr int NP = 8 * RF, LDA = NP + 1;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    S* A = reinterpret_cast<S*>(smem_raw);          // NP x LDA
    S* V = A + NP * LDA;                            // NP x kLdV
    S* T = V + NP * kLdV;                           // 8 x kLdV
    S* SV = T + 8 * kLdV;                           // 8 x kLdV
    S* alpha_s = SV + 8 * kLdV;                     // 8
    S* vhead_s = alpha_s + 8;                       // 8
    S* s_s = vhead_s + 8;                           // 8
    double* beta_s = reinterpret_cast<double*>(s_s + 8);   // 8
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
                Mt[rf][u].c[j] = r < n && c < n ? rhs[off + size_t(r) * n + c] : zero;
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
        for (int jj = 0; jj < 8; ++jj) {
            const int jr = j0 + jj;   // the pivot row
            double nrm = 0;
            for (int k = jr + lane; k < NP; k += 32) nrm += abs2(V[k * kLdV + jj]);
            const double norm = sqrt_t(warp_sum(nrm));
            const S x0 = V[jr * kLdV + jj];
            const S alpha = householder_alpha(x0, norm);
            const double vtv = 2.0 * norm * (norm + sqrt_t(abs2(x0)));
            // a zero column (v == 0) leaves everything unchanged
            const double beta = 2.0 / (vtv == 0.0 ? 1.0 : vtv);
            const S vh = x0 - alpha;
            for (int c = jj + 1 + warp; c < 8; c += kWarps) {
                S d = zero;
                for (int k = jr + 1 + lane; k < NP; k += 32)
                    d += conj_(V[k * kLdV + jj]) * V[k * kLdV + c];
                d = warp_sum(d);
                if (lane == 0) s_s[c] = beta * (d + conj_(vh) * V[jr * kLdV + c]);
            }
            if (tid == 0) {
                alpha_s[jj] = alpha;
                beta_s[jj] = beta;
                vhead_s[jj] = vh;
            }
            probe.lap(kTcPanel);
            __syncthreads();
            probe.lap(kTcBarrier);
            const int na = 7 - jj;
            for (int idx = tid; idx < (NP - jr) * na; idx += kThreads) {
                const int k = jr + idx / na, c = jj + 1 + idx % na;
                const S vk = k == jr ? vhead_s[jj] : V[k * kLdV + jj];
                V[k * kLdV + c] -= vk * s_s[c];
            }
            if (tid == 0) V[jr * kLdV + jj] = vhead_s[jj];
            probe.lap(kTcPanel);
            __syncthreads();
            probe.lap(kTcBarrier);
        }
        // R's diagonal block to A (strict lower part 0); V keeps the
        // reflectors, zero above the diagonal. Meanwhile (V^H V)_ki for
        // k < i, one warp per pair: rows from j0 + i, where reflector i
        // starts (the entries above it are R's, not yet zeroed)
        if (tid < 64) {
            const int r = tid >> 3, c = tid & 7;
            const S val = V[(j0 + r) * kLdV + c];
            A[(j0 + r) * LDA + j0 + c] = r < c ? val : r == c ? alpha_s[c] : zero;
            if (r < c) V[(j0 + r) * kLdV + c] = zero;
        }
        for (int pr = warp; pr < 28; pr += kWarps) {
            int i = 1, k = pr;
            while (k >= i) k -= i++;
            S d = zero;
            for (int rr = j0 + i + lane; rr < NP; rr += 32)
                d += conj_(V[rr * kLdV + k]) * V[rr * kLdV + i];
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

// f(kernel) for the instance of np = 8 rf, rf = 1..11 (kernel_for sends
// n <= 83 here; with the probe: rf = 8 only, the sdw_l4 shape), `missing`
// if there is none
template <bool PROBE, typename F>
int with_rhs_tc(int rf, int missing, F f) {
    if constexpr (PROBE) {
        return rf == 8 ? f(solve_inner_rhs_tc_kernel<8, 1, true>) : missing;
    } else {
        switch (rf) {
            case 1: return f(solve_inner_rhs_tc_kernel<1, 1, false>);
            case 2: return f(solve_inner_rhs_tc_kernel<2, 1, false>);
            case 3: return f(solve_inner_rhs_tc_kernel<3, 1, false>);
            case 4: return f(solve_inner_rhs_tc_kernel<4, 1, false>);
            case 5: return f(solve_inner_rhs_tc_kernel<5, 1, false>);
            case 6: return f(solve_inner_rhs_tc_kernel<6, 1, false>);
            case 7: return f(solve_inner_rhs_tc_kernel<7, 1, false>);
            case 8: return f(solve_inner_rhs_tc_kernel<8, 1, false>);
            case 9: return f(solve_inner_rhs_tc_kernel<9, 2, false>);
            case 10: return f(solve_inner_rhs_tc_kernel<10, 2, false>);
            case 11: return f(solve_inner_rhs_tc_kernel<11, 2, false>);
            default: return missing;
        }
    }
}

template <bool PROBE>
int solve_inner_rhs_tc(int device, const void* inner, const void* rhs, void* out,
                       int batch, int n, void* stream, long long* probe) {
    return with_rhs_tc<PROBE>(
        round_up(n, 8) / 8, static_cast<int>(cudaErrorInvalidValue), [&](auto kernel) {
            return launch_tc(device, kernel, batch, rhs_tc_smem_bytes(n), stream,
                             static_cast<const cplx<double>*>(inner),
                             static_cast<const cplx<double>*>(rhs),
                             static_cast<cplx<double>*>(out), n, probe);
        });
}

// ---- K3 / K3r: the float64 solves on the tensor cores ---------------------
// X = inner^{-1} M for float64 n <= 119 (the one-CTA route of kernel_for),
// M = diag(r1) (K3, solve_inner_f64_tc_kernel: M is built in registers, no
// dense M in global memory) or dense (K3r, solve_inner_rhs_f64_tc_kernel),
// one CTA per matrix. K3c-rhs's design in float64, where each complex
// product (four real mma.sync m8n8k4) is one real one and A takes half the
// bytes (np = n rounded up to 8; inner padded with the identity, M with
// zeros):
//   - A in shared memory at row stride np + 4 (= 4 mod 8 doubles:
//     tc_blocked.cuh's rule for 8-byte elements; A's k-slices for W^T are
//     read as rows q + 4 s, which it keeps free of bank conflicts), M in
//     registers as K3c-rhs holds it: warp w owns M's column strips w,
//     w + 8, lane (g, q) the entries M[8 rf + 2q + j][8 cf + g];
//   - panels of 8 columns in the side buffer V (stride 9, odd: the column
//     walks hit distinct banks) at ONE barrier a column: warp w owns panel
//     column 7 - w; at reflector j every warp whose column is beyond j
//     forms the norm and its dot product with its column (summed in the
//     same butterfly as the norm) and then updates its column itself, so
//     no warp waits for another's s_c. K3c-rhs's panel (two barriers a
//     column, one warp per dot product) was 74 % of its CTA (121 of 165
//     us). One warp owning all eight columns (no barrier at all, nine
//     sums in one butterfly) measured twice as slow, two columns a warp
//     no faster: the chain of each reflector (a warp reduction, a square
//     root, a division) is the bound, not the barrier (the phase probe,
//     solve_timing.py, NVIDIA H100 80GB HBM3, 700 W);
//   - V^T V from one warp's mma chain over the panel's rows, T of the
//     compact-WY form from it (lane r of warp 0 holds row r in registers)
//     while the other warps already form W^T = X^T V for their strips of
//     A and M; then Y^T = W^T T and X^T -= Y^T V^T;
//   - R's 8 x 8 diagonal blocks inverted into the side buffer, then the
//     blocked back-substitution in registers (X_b^T = Z_b^T Dinv_b^T,
//     Z_c^T -= X_b^T R_cb^T), as K3c-rhs;
//   - 40 KB of shared memory at n = 64 and at most 80 registers a thread
//     (launch bounds of 3 CTAs per SM up to np = 64): B = 256 (the Hubbard
//     L = 8 sweep) is one wave, B = 2688 (its unequal-time anchors) seven.
// What bounds it: the panel's chain (64 dependent reflectors, each a warp
// reduction, a square root, a division and a barrier); the FP64 tensor
// cores run ~1.1 MFLOP a CTA at n = 64, 0.05 ms for B = 2688 at peak.
// Reflectors, alpha and beta are householder_tc's, up to rounding.
__host__ __device__ constexpr size_t f64_tc_smem_bytes(int n) {
    // A np x (np + 4), the side buffer np x 9, T and V^T V 8 x 9 each,
    // alpha, vhead and beta (8 each)
    return sizeof(double) * (size_t(round_up(n, 8)) * (round_up(n, 8) + 4)
                             + size_t(round_up(n, 8)) * kLdV + 2 * 8 * kLdV + 3 * 8);
}

// M = diag(r1) (DIAG; M holds r1, B x n) or dense M (B x n x n)
template <int RF, bool DIAG, bool PROBE>
__device__ __forceinline__ void solve_f64_tc(unsigned char* smem, const double* __restrict__ inner,
                                             const double* __restrict__ M,
                                             double* __restrict__ out, int n,
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
                if constexpr (DIAG)
                    Mt[rf][u].c[j] = r == c && c < n ? M[size_t(blockIdx.x) * n + c] : 0.0;
                else
                    Mt[rf][u].c[j] = r < n && c < n ? M[off + size_t(r) * n + c] : 0.0;
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

// distinct names, so a profile tells K3 from K3r and both from K3c-rhs
// (K3 takes K3r's arguments, its probe pointer unused, so one launch
// serves both)
template <int RF>
__global__ void __launch_bounds__(kThreads, RF <= 8 ? 3 : 1)
solve_inner_f64_tc_kernel(const double* __restrict__ inner, const double* __restrict__ r1,
                          double* __restrict__ mid, int n, long long*) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    solve_f64_tc<RF, true, false>(smem_raw, inner, r1, mid, n, nullptr);
}

template <int RF, bool PROBE>
__global__ void __launch_bounds__(kThreads, RF <= 8 ? 3 : 1)
solve_inner_rhs_f64_tc_kernel(const double* __restrict__ inner, const double* __restrict__ rhs,
                              double* __restrict__ out, int n, long long* probe_out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    solve_f64_tc<RF, false, PROBE>(smem_raw, inner, rhs, out, n, probe_out);
}

// f(std::integral_constant<int, rf>) for rf = 1..15 (np = 8 rf up to
// 120: kernel_for sends float64 n <= 119 here), `missing` otherwise
template <int RF = 1, typename F>
int with_f64_rf(int rf, int missing, F f) {
    if constexpr (RF > 15) {
        return missing;
    } else {
        return rf == RF ? f(std::integral_constant<int, RF>{})
                        : with_f64_rf<RF + 1>(rf, missing, f);
    }
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
    return dq::solve_inner<dq::cplx<double>>(device, inner, r1, mid, batch, n,
                                             stream);
}

int dq_solve_inner_rhs_f64(int device, const void* inner, const void* rhs,
                           void* out, int batch, int n, void* stream) {
    return dq::solve_f64<false>(device, inner, rhs, out, batch, n, true, stream,
                                nullptr);
}

int dq_solve_inner_rhs_c128(int device, const void* inner, const void* rhs,
                            void* out, int batch, int n, void* stream) {
    return dq::solve_inner_rhs_tc<false>(device, inner, rhs, out, batch, n, stream,
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
    return dq::solve_inner_rhs_tc<true>(device, inner, rhs, out, batch, n, stream,
                                        static_cast<long long*>(probe));
}

// CTAs of the complex128 dense-RHS kernel one SM holds at this n (the
// occupancy calculator, after launch_tc's attributes), or -(cudaError)
int dq_solve_inner_rhs_c128_blocks_per_sm(int device, int n) {
    return dq::with_rhs_tc<false>(
        dq::round_up(n, 8) / 8, -static_cast<int>(cudaErrorInvalidValue), [&](auto kernel) {
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
