// K6: fused SDW wrap and one-sided B apply. Instances: q = 4 complex (the
// full opdim-3 model), q = 2 complex (the opdim-2 reduced sector) and q = 2
// real (opdim 1), in single and double precision (the TPU kernel's real
// single-plane variant, pallas_sdw_wrap.py:29-30); the notes below are
// written for q = 4 complex. The q = 2 instances are the same program with
// q orbitals (the real ones on real lines) and three things of their own:
//   - F staged by cp.async, beside the first tile's line copies;
//   - launch bounds of two CTAs per SM, and plans (linalg/sdw_wrap.py plan)
//     that spread a walker's tiles over two CTAs where a plan with a
//     prefetch buffer and a full kinetic step fits two CTAs per SM: float32
//     at N = 64 (sdw_o1_l8) runs 32-line tiles, two a CTA, 256 CTAs, where
//     it ran one CTA of four tiles a walker; elsewhere the q = 4 rule
//     (complex64 at N = 64: one 141 KB CTA per SM, four 32-line tiles);
//   - the wrappers' host work cut (the plan computed once a shape), which
//     set one call's time: an apply's device time (complex64 0.033 ms,
//     float32 0.021 at W = 128, h = 128) is a third of one call's.
// At W = 128, h = 128 they take (device time a call, parent's first): wrap
// 0.0710 -> 0.0676 (complex64) and 0.0480 -> 0.0439 ms (float32), apply
// 0.0326 -> 0.0327 and 0.0227 -> 0.0212 ms; one bmm with the dense B takes
// 0.0495 / 0.0166 ms of device time. What bounds them, by the probe (a
// CTA): complex64 33 us, the kinetic step 19 of it (the FP32 pipe at about
// half its peak with one CTA of 8 warps per SM), line copies 8, F 2.6, D
// 2.7; float32 19 us, kinetic 9, F 4, lines 4, D 1.7 (solve_timing.py
// --rows k6q2, NVIDIA H100 80GB HBM3, 700 W).
//
// Replaces the TPU kernels detqmc_tpu/linalg/pallas_sdw_wrap.py
// (fused_wrap, kernel body _kernel; fused_apply_left, kernel body
// _apply_kernel). In the model's layout (dim index = orbital * N + site,
// h = 4 N; E (4, N, N) the per-orbital dense kinetic factor, real, passed
// as a real copy (float32 for complex64, float64 for complex128); D
// (W, N, 4, 4) the per-site potential blocks):
//     wrap up:    G' = D . (E @ ((G @ E^-1) . D^-1))
//     wrap down:  G' = E^-1 @ (D^-1 . ((G . D) @ E))
//     apply:      X' = D . (E @ X)                    (B X, B = D_V expK)
//     apply-H:    X' = E^T @ (D^H . X)                (B^H X)
// The TPU kernel keeps a walker's whole G (512 KB at h = 256 in complex64)
// plus a temporary in VMEM. A block here has 227 KB, so the work is split
// by the structure of the factors: right factors (@ E, . D) mix columns
// within a row, left factors mix rows within a column. One launch
// ("line pass") walks tiles of TL rows (right pass) or TL columns (left
// pass) of a walker, each through shared memory as TL lines of h values
// (stored k-major: line value k of line t at [k][t]), applies a kinetic
// step and a potential step in either order, and writes the lines back. A
// wrap is a right pass into a scratch buffer in global memory (the TPU
// kernel's t_ref) and a left pass from it: two launches from one entry
// point; an apply is one left pass.
//
// What bounds it on the H100 (NVIDIA H100 80GB HBM3, 700 W): the kinetic
// steps, 2 h^2 N real x complex multiply-adds per walker and pass (4.2 M
// at h = 256), and one read and one write of G per pass (1 MB per walker
// in complex64): 0.07 ms a wrap of 128 walkers at the FP32 peak. The first
// design took 0.71 ms a wrap and 0.40 ms an apply there (a dense bmm with
// B: 0.38 ms); its clock64() probe (solve_timing.py) put 40 % of a CTA in
// the kinetic step (one F load and four line loads per 8 FMAs), 26 % in
// the D step, 19 % in the line loads and stores and 15 % in restaging F
// (each of 2048 CTAs per pass staged 128 KB of complex E for 16 lines).
// This design:
//   - the kinetic step register-tiled: a thread holds 4 lines x 4 columns
//     n of one orbital as complex accumulators (2 lines in complex128)
//     and per m loads one vector of 4 F values and one vector of its line
//     values (the k-major layout): 32 FMAs per three 16-byte loads in
//     complex64;
//   - F staged from the real E once per CTA, all four orbitals, and each
//     CTA walking several tiles of its walker (all of them at W >= the SM
//     count), so E's traffic is a few per cent of G's;
//   - the next tile's lines copied by cp.async while the current one is
//     computed (three line buffers);
//   - the D step with the four outputs of a site and line per thread;
//   - 16-byte, division-free copies of the lines.
// Where all four orbitals do not fit (complex64 beyond N = 103, complex128
// beyond N = 68), F is staged per tile in groups of two or one orbitals
// (linalg/sdw_wrap.py plan). A wrap then takes 0.29 ms and an apply 0.16
// ms (solve_timing.py, W = 128, h = 256). What holds it now, by the probe:
// the kinetic step (60 % of a CTA's time, the FP32 pipe at about 45 % of
// its peak), the line copies (20 %), the D step (13 %) and F's staging
// (6 %); one 188 KB CTA per SM, 128 CTAs on 132 SMs.
#include "common.cuh"
#include "tc_blocked.cuh"

namespace dq {

struct PassFlags {
    int left;       // lines are columns (left factors) instead of rows
    int kin_first;  // kinetic step before the potential step
    int e_trans;    // F_o[m][n] = E_o[n][m] (left kinetic: E @ X)
    int d_trans;    // Dm_i[a][b] = D_i[b][a] (left potential: D . X)
    int d_conj;     // Dm = conj(D) (D^H . X together with d_trans = 0)
};

// the phase probe's phases (Probe, common.cuh), mirrored by
// linalg/sdw_wrap.py PROBE_PHASES
enum { kStageF, kKinetic, kDStep, kLines, kPhases };

// row strides (elements): lines TL + lpad, lpad 16 bytes of S (none at
// TL = 4, the fallback plans' width), F rows round_up(N, 4) + fpad; both
// keep rows 16-byte aligned. Mirrored by linalg/sdw_wrap.py smem_bytes.
template <typename T> struct k6_pad;
template <> struct k6_pad<float> { static constexpr int f = 4; };
template <> struct k6_pad<double> { static constexpr int f = 2; };
// S values per 16 bytes: the line pad, the left lines' copy width
template <typename S>
__host__ __device__ constexpr int k6_ch() { return 16 / sizeof(S); }

template <typename S>
__host__ __device__ inline int k6_ldt(int TL) { return TL + (TL >= 8 ? k6_ch<S>() : 0); }
template <typename T>
__host__ __device__ inline int k6_ldf(int N) { return round_up(N, 4) + k6_pad<T>::f; }

// nb line buffers of h x ldt (h = q N), D's blocks (q^2 N), og orbitals
// of F
template <typename S, int Q>
size_t k6_smem_bytes(int N, int TL, int og, int nb) {
    using T = typename real_of<S>::type;
    return sizeof(S) * (size_t(nb) * Q * N * k6_ldt<S>(TL) + Q * Q * size_t(N))
           + sizeof(T) * size_t(og) * N * k6_ldf<T>(N);
}

// acc + x f for a real f, one fused multiply-add a part
__device__ __forceinline__ float fma_s(float x, float f, float acc) { return fmaf(x, f, acc); }
__device__ __forceinline__ double fma_s(double x, double f, double acc) { return fma(x, f, acc); }
template <typename T>
__device__ __forceinline__ cplx<T> fma_s(cplx<T> x, T f, cplx<T> acc) {
    return mk(fma_s(x.re, f, acc.re), fma_s(x.im, f, acc.im));
}

// F_o[m][n] (m < N, n < round_up(N, 4), zero beyond N) for the og orbitals
// from o0: E_o or, with e_trans, E_o^T; E read row by row (coalesced). With
// ASYNC the values go by cp.async (one committed group), so that the copy
// of F runs beside the first tile's line copies and the caller's
// cp_async_wait_all; else by plain loads and stores
template <bool ASYNC, typename T>
__device__ void stage_f(T* Fs, const T* E, int N, int o0, int og, int e_trans) {
    const int NP = round_up(N, 4), ldf = k6_ldf<T>(N);
    for (int oo = 0; oo < og; ++oo) {
        const T* Eo = E + size_t(o0 + oo) * N * N;
        T* F = Fs + size_t(oo) * N * ldf;
        for (int idx = threadIdx.x; idx < N * NP; idx += kThreads) {
            const int a = idx / NP, b = idx - a * NP;
            if (b < N) {
                const T* src = Eo + a * N + b;              // E_o[a][b]
                T* dst = e_trans ? F + b * ldf + a : F + a * ldf + b;
                if constexpr (ASYNC) cp_async(dst, src);
                else *dst = *src;
            } else {
                F[a * ldf + b] = T(0);       // n = b beyond N, row m = a
            }
        }
    }
    if constexpr (ASYNC) cp_async_commit();
}

// lines per thread in the kinetic step: 4 in complex64 and float32, 2 in
// double precision (whose smaller tiles would leave threads idle at 4);
// mirrored by linalg/sdw_wrap.py lines_per_thread. Two lines a thread in
// complex64 where four leave threads idle (16-line tiles at q = 2, N = 64,
// two CTAs per SM) took 8 % longer than the 32-line tiles at four lines a
// thread and one CTA per SM (0.0355 against 0.0329 ms an apply,
// solve_timing.py's k6q2 rows, NVIDIA H100 80GB HBM3, 700 W)
template <typename T>
__host__ __device__ constexpr int k6_rt() { return sizeof(T) == 4 ? 4 : 2; }

// out[o N + n][t] = sum_m in[o N + m][t] F_o[m][n] for the og orbitals
// from o0 (F of orbital o at Fs + (o - o0) N ldf): an RT x 4 block of
// (t, n) per thread
template <typename S>
__device__ void kin_block(const S* in, S* out, const typename real_of<S>::type* Fs, int N,
                          int TL, int o0, int og) {
    using T = typename real_of<S>::type;
    constexpr int RT = k6_rt<T>();
    const int NG = round_up(N, 4) / 4, TG = TL / RT, ldt = k6_ldt<S>(TL), ldf = k6_ldf<T>(N);
    for (int p = threadIdx.x; p < og * NG * TG; p += kThreads) {
        const int ng = p % NG, rest = p / NG, tg = rest % TG, oo = rest / TG;
        const int n0 = 4 * ng, t0 = RT * tg, o = o0 + oo;
        const T* F = Fs + size_t(oo) * N * ldf + n0;
        const S* src = in + size_t(o) * N * ldt + t0;
        S acc[RT][4];
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[r][j] = from_real<S>(T(0));
#pragma unroll 2
        for (int m = 0; m < N; ++m) {
            T f[4];
            S x[RT];
            load4(F + m * ldf, f);
            if constexpr (RT == 4) {
                load4(src + m * ldt, x);
            } else {
#pragma unroll
                for (int r = 0; r < RT; ++r) x[r] = src[m * ldt + r];
            }
#pragma unroll
            for (int r = 0; r < RT; ++r)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[r][j] = fma_s(x[r], f[j], acc[r][j]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            if (n0 + j >= N) break;
            S* dst = out + (size_t(o) * N + n0 + j) * ldt + t0;
#pragma unroll
            for (int r = 0; r < RT; ++r) dst[r] = acc[r][j];
        }
    }
}

// the kinetic step of all q orbitals: F staged per group of og orbitals
// when og < q (og == q: staged once per CTA); ends with a barrier
template <typename S, int Q, typename PR>
__device__ void kin_step(const S* in, S* out, typename real_of<S>::type* Fs,
                         const typename real_of<S>::type* E, int N, int TL, int og,
                         int e_trans, PR& probe) {
    for (int o0 = 0; o0 < Q; o0 += og) {
        if (og < Q) {
            if (o0 > 0) __syncthreads();   // the last group is done with Fs
            stage_f<false>(Fs, E, N, o0, og, e_trans);
            __syncthreads();
            probe.lap(kStageF);
        }
        kin_block(in, out, Fs, N, TL, o0, og);
    }
    __syncthreads();
    probe.lap(kKinetic);
}

// out[b N + i][t] = sum_a in[a N + i][t] Dm_i[a][b]: the q b of a site
// and line per thread (TL = 1 << tl_shift)
template <typename S, int Q>
__device__ void dv_step(const S* in, S* out, const S* Ds, int N, int TL, int tl_shift) {
    const int ldt = k6_ldt<S>(TL);
    for (int p = threadIdx.x; p < N * TL; p += kThreads) {
        const int t = p & (TL - 1), i = p >> tl_shift;
        S x[Q];
#pragma unroll
        for (int a = 0; a < Q; ++a) x[a] = in[(size_t(a) * N + i) * ldt + t];
        const S* d = Ds + i * Q * Q;
#pragma unroll
        for (int b = 0; b < Q; ++b) {
            S acc = x[0] * d[b];
#pragma unroll
            for (int a = 1; a < Q; ++a) acc += x[a] * d[Q * a + b];
            out[(size_t(b) * N + i) * ldt + t] = acc;
        }
    }
}

// Lines l0 .. l0 + TL of X (W's walker at X) into dst[k][t] by cp.async,
// zero beyond h (TL = 1 << tl_shift): columns of X (left) as 16-byte pieces
// of a row (one value at a time where a row of h values is no whole number
// of pieces: real float32 lines at odd N), rows of X (right) a warp per
// line along k (coalesced)
template <typename S>
__device__ void load_lines(S* dst, const S* X, int h, int ldt, int l0, int TL, int tl_shift,
                           int left) {
    using T = typename real_of<S>::type;
    constexpr int CH = k6_ch<S>();              // elements per 16 bytes
    const S zero = from_real<S>(T(0));
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (left && h % CH != 0) {
        for (int idx = threadIdx.x; idx < h << tl_shift; idx += kThreads) {
            const int k = idx >> tl_shift, t = idx & (TL - 1);
            S* d = dst + k * ldt + t;
            if (l0 + t < h) cp_async(d, X + size_t(k) * h + l0 + t);
            else *d = zero;
        }
    } else if (left) {
        const int cshift = tl_shift - CH / 2, cmask = (1 << cshift) - 1;
        for (int idx = threadIdx.x; idx < h << cshift; idx += kThreads) {
            const int k = idx >> cshift, t = (idx & cmask) * CH;
            S* d = dst + k * ldt + t;
            if (l0 + t < h) {
                cp_async16(d, X + size_t(k) * h + l0 + t);
            } else {
#pragma unroll
                for (int c = 0; c < CH; ++c) d[c] = zero;
            }
        }
    } else {
        for (int t = warp; t < TL; t += kWarps) {
            const int l = l0 + t;
            for (int k = lane; k < h; k += 32) {
                S* d = dst + k * ldt + t;
                if (l < h) cp_async(d, X + size_t(l) * h + k);
                else *d = zero;
            }
        }
    }
    cp_async_commit();
}

// src[k][t] back to lines l0 .. l0 + TL of X (those below h), as
// load_lines reads them
template <typename S>
__device__ void store_lines(const S* src, S* X, int h, int ldt, int l0, int TL, int tl_shift,
                            int left) {
    constexpr int CH = k6_ch<S>();
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (left && h % CH != 0) {
        for (int idx = threadIdx.x; idx < h << tl_shift; idx += kThreads) {
            const int k = idx >> tl_shift, t = idx & (TL - 1);
            if (l0 + t < h) X[size_t(k) * h + l0 + t] = src[k * ldt + t];
        }
    } else if (left) {
        const int cshift = tl_shift - CH / 2, cmask = (1 << cshift) - 1;
        for (int idx = threadIdx.x; idx < h << cshift; idx += kThreads) {
            const int k = idx >> cshift, t = (idx & cmask) * CH;
            if (l0 + t < h)
                *reinterpret_cast<uint4*>(X + size_t(k) * h + l0 + t) =
                    *reinterpret_cast<const uint4*>(src + k * ldt + t);
        }
    } else {
        for (int t = warp; t < TL; t += kWarps) {
            const int l = l0 + t;
            if (l >= h) break;
            for (int k = lane; k < h; k += 32) X[size_t(l) * h + k] = src[k * ldt + t];
        }
    }
}

// A CTA takes tiles [t_begin, t_end) of walker w: og == 4 stages F once;
// the next tile's lines are copied by cp.async while the current one is
// computed when there are three line buffers (nb == 3).
template <typename S, int Q, bool PROBE>
__global__ void __launch_bounds__(kThreads, Q == 2 ? 2 : 1)
line_pass_kernel(const S* X_in, S* X_out, const typename real_of<S>::type* __restrict__ E,
                 const S* __restrict__ D, int N, int TL, int og, int nb, int tpc,
                 PassFlags fl, long long* probe_out) {
    using T = typename real_of<S>::type;
    constexpr int QQ = Q * Q;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    Probe<PROBE, kPhases> probe;
    probe.start();
    const int tid = threadIdx.x, h = Q * N, ldt = k6_ldt<S>(TL), tl_shift = __ffs(TL) - 1;
    const int tiles = (h + TL - 1) / TL, per_w = (tiles + tpc - 1) / tpc;
    const size_t w = blockIdx.x / per_w;
    const int t_begin = int(blockIdx.x - w * per_w) * tpc;
    const int t_end = min(tiles, t_begin + tpc);
    const size_t buf_elems = size_t(h) * ldt;
    const S* Xw = X_in + w * size_t(h) * h;
    S* Yw = X_out + w * size_t(h) * h;
    S* lines = reinterpret_cast<S*>(smem_raw);    // nb x h x ldt
    S* Ds = lines + nb * buf_elems;               // N x q^2: Dm_i[a][b]
    T* Fs = reinterpret_cast<T*>(Ds + QQ * N);    // og x N x ldf

    if (t_begin < t_end) load_lines(lines, Xw, h, ldt, t_begin * TL, TL, tl_shift, fl.left);
    const S* Dw = D + w * size_t(N) * QQ;
    for (int idx = tid; idx < QQ * N; idx += kThreads) {
        const int i = idx / QQ, a = (idx / Q) % Q, b = idx % Q;
        S d = fl.d_trans ? Dw[i * QQ + Q * b + a] : Dw[idx];
        if (fl.d_conj) d = conj_(d);
        Ds[idx] = d;
    }
    probe.lap(kLines);
    if (og == Q) stage_f<Q == 2>(Fs, E, N, 0, Q, fl.e_trans);   // q = 4: plain copies
    probe.lap(kStageF);
    S* cur = lines;
    S* nxt = lines + 2 * buf_elems;
    S* tmp = lines + buf_elems;
    for (int tile = t_begin; tile < t_end; ++tile) {
        cp_async_wait_all();
        __syncthreads();   // the tile landed; F, D staged; the last tile stored
        if (nb == 3 && tile + 1 < t_end)
            load_lines(nxt, Xw, h, ldt, (tile + 1) * TL, TL, tl_shift, fl.left);
        probe.lap(kLines);
        if (fl.kin_first) {
            kin_step<S, Q>(cur, tmp, Fs, E, N, TL, og, fl.e_trans, probe);
            dv_step<S, Q>(tmp, cur, Ds, N, TL, tl_shift);
            __syncthreads();
            probe.lap(kDStep);
        } else {
            dv_step<S, Q>(cur, tmp, Ds, N, TL, tl_shift);
            __syncthreads();
            probe.lap(kDStep);
            kin_step<S, Q>(tmp, cur, Fs, E, N, TL, og, fl.e_trans, probe);
        }
        // the result is in cur
        store_lines(cur, Yw, h, ldt, tile * TL, TL, tl_shift, fl.left);
        if (nb == 3) {
            S* c = cur;
            cur = nxt;
            nxt = c;
        } else if (tile + 1 < t_end) {
            __syncthreads();   // every thread is done with the tile's lines
            load_lines(cur, Xw, h, ldt, (tile + 1) * TL, TL, tl_shift, fl.left);
        }
        probe.lap(kLines);
    }
    probe.store(probe_out);
}

template <typename S, int Q>
int line_pass(int device, const void* X_in, void* X_out, const void* E, const void* D,
              int W, int N, int TL, int og, int nb, int tpc, PassFlags fl, void* stream,
              long long* probe) {
    using T = typename real_of<S>::type;
    const size_t smem = k6_smem_bytes<S, Q>(N, TL, og, nb);
    const int tiles = (Q * N + TL - 1) / TL, per_w = (tiles + tpc - 1) / tpc;
    const auto args = [&](auto kernel) {
        return launch_smem(device, kernel, W * per_w, smem, stream,
                           static_cast<const S*>(X_in), static_cast<S*>(X_out),
                           static_cast<const T*>(E), static_cast<const S*>(D), N, TL, og, nb,
                           tpc, fl, probe);
    };
    return probe ? args(line_pass_kernel<S, Q, true>) : args(line_pass_kernel<S, Q, false>);
}

inline bool k6_plan_ok(int N, int q, int TL, int og, int nb, int tpc) {
    return N > 0 && TL >= 4 && TL % 4 == 0 && (og == 1 || og == 2 || og == 4) && og <= q &&
           (nb == 2 || nb == 3) && tpc >= 1;
}

template <typename S, int Q>
int sdw_wrap(int device, const void* G, void* Tmp, void* G_out, const void* E,
             const void* Einv, const void* D, const void* Dinv, int W, int N, int up,
             int TL, int og, int nb, int tpc, void* stream, long long* probe = nullptr) {
    if (!k6_plan_ok(N, Q, TL, og, nb, tpc)) return static_cast<int>(cudaErrorInvalidValue);
    // right pass on rows into Tmp, then left pass on columns into G_out; the
    // probe's records: the right pass's CTAs, then the left pass's
    const PassFlags right{0, up, 0, 0, 0}, left{1, up, 1, 1, 0};
    const int tiles = (Q * N + TL - 1) / TL;
    const size_t ctas = size_t(W) * ((tiles + tpc - 1) / tpc);
    int err = line_pass<S, Q>(device, G, Tmp, up ? Einv : E, up ? Dinv : D, W, N, TL, og,
                              nb, tpc, right, stream, probe);
    if (err) return err;
    return line_pass<S, Q>(device, Tmp, G_out, up ? E : Einv, up ? D : Dinv, W, N, TL, og,
                           nb, tpc, left, stream,
                           probe ? probe + ctas * (kPhases + 2) : nullptr);
}

template <typename S, int Q>
int sdw_apply(int device, const void* X, void* X_out, const void* E, const void* D,
              int W, int N, int herm, int TL, int og, int nb, int tpc, void* stream,
              long long* probe = nullptr) {
    if (!k6_plan_ok(N, Q, TL, og, nb, tpc)) return static_cast<int>(cudaErrorInvalidValue);
    // B X: E @ X then D . ;  B^H X: D^H . X then E^T @
    const PassFlags fl = herm ? PassFlags{1, 0, 0, 0, 1} : PassFlags{1, 1, 1, 1, 0};
    return line_pass<S, Q>(device, X, X_out, E, D, W, N, TL, og, nb, tpc, fl, stream,
                           probe);
}

template <typename S, int Q>
int line_pass_blocks(int device, int N, int TL, int og, int nb) {
    if (!k6_plan_ok(N, Q, TL, og, nb, 1)) return -static_cast<int>(cudaErrorInvalidValue);
    return blocks_per_sm(device, line_pass_kernel<S, Q, false>,
                         k6_smem_bytes<S, Q>(N, TL, og, nb));
}

}  // namespace dq

// E, Einv: the real kinetic factors (float32 / float64); D, Dinv and G of
// the instance's scalar; TL, og, nb, tpc: the plan (linalg/sdw_wrap.py plan)
#define DQ_SDW_WRAP_ENTRIES(WRAP, APPLY, S, Q)                                          \
    extern "C" int WRAP(int device, const void* G, void* Tmp, void* G_out,              \
                        const void* E, const void* Einv, const void* D, const void* Dinv, \
                        int W, int N, int up, int TL, int og, int nb, int tpc,          \
                        void* stream) {                                                 \
        return dq::sdw_wrap<S, Q>(device, G, Tmp, G_out, E, Einv, D, Dinv, W, N, up,    \
                                  TL, og, nb, tpc, stream);                             \
    }                                                                                   \
    extern "C" int APPLY(int device, const void* X, void* X_out, const void* E,         \
                         const void* D, int W, int N, int herm, int TL, int og, int nb, \
                         int tpc, void* stream) {                                       \
        return dq::sdw_apply<S, Q>(device, X, X_out, E, D, W, N, herm, TL, og, nb, tpc, \
                                   stream);                                             \
    }

DQ_SDW_WRAP_ENTRIES(dq_sdw_wrap_c64, dq_sdw_apply_c64, dq::cplx<float>, 4)
DQ_SDW_WRAP_ENTRIES(dq_sdw_wrap_c128, dq_sdw_apply_c128, dq::cplx<double>, 4)
DQ_SDW_WRAP_ENTRIES(dq_sdw_wrap_q2_c64, dq_sdw_apply_q2_c64, dq::cplx<float>, 2)
DQ_SDW_WRAP_ENTRIES(dq_sdw_wrap_q2_c128, dq_sdw_apply_q2_c128, dq::cplx<double>, 2)
DQ_SDW_WRAP_ENTRIES(dq_sdw_wrap_q2_f32, dq_sdw_apply_q2_f32, float, 2)
DQ_SDW_WRAP_ENTRIES(dq_sdw_wrap_q2_f64, dq_sdw_apply_q2_f64, double, 2)

// the same with the phase probe on: probe gets each CTA's cycles per phase,
// total cycles and total ns (a wrap: the right pass's CTAs, then the left
// pass's). Instances: complex64 at q = 4 (sdw_l8) and q = 2 (sdw_o2_l8),
// float32 at q = 2 (sdw_o1_l8), the main paths' K6
#define DQ_SDW_WRAP_PROBE_ENTRIES(WRAP, APPLY, S, Q)                                     \
    extern "C" int WRAP(int device, const void* G, void* Tmp, void* G_out,              \
                        const void* E, const void* Einv, const void* D, const void* Dinv, \
                        int W, int N, int up, int TL, int og, int nb, int tpc,          \
                        void* probe, void* stream) {                                    \
        return dq::sdw_wrap<S, Q>(device, G, Tmp, G_out, E, Einv, D, Dinv, W, N, up,    \
                                  TL, og, nb, tpc, stream,                              \
                                  static_cast<long long*>(probe));                      \
    }                                                                                   \
    extern "C" int APPLY(int device, const void* X, void* X_out, const void* E,         \
                         const void* D, int W, int N, int herm, int TL, int og, int nb, \
                         int tpc, void* probe, void* stream) {                          \
        return dq::sdw_apply<S, Q>(device, X, X_out, E, D, W, N, herm, TL, og, nb, tpc, \
                                   stream, static_cast<long long*>(probe));             \
    }

DQ_SDW_WRAP_PROBE_ENTRIES(dq_sdw_wrap_probe_c64, dq_sdw_apply_probe_c64, dq::cplx<float>, 4)
DQ_SDW_WRAP_PROBE_ENTRIES(dq_sdw_wrap_probe_q2_c64, dq_sdw_apply_probe_q2_c64,
                          dq::cplx<float>, 2)
DQ_SDW_WRAP_PROBE_ENTRIES(dq_sdw_wrap_probe_q2_f32, dq_sdw_apply_probe_q2_f32, float, 2)

extern "C" {

// CTAs of a K6 line pass per SM at this plan (complex: complex128, else
// complex64), or -(cudaError)
int dq_sdw_wrap_blocks_per_sm(int device, int complex128, int N, int TL, int og, int nb) {
    return complex128 ? dq::line_pass_blocks<dq::cplx<double>, 4>(device, N, TL, og, nb)
                      : dq::line_pass_blocks<dq::cplx<float>, 4>(device, N, TL, og, nb);
}

// the q = 2 instances' (dtype: 0 float32, 1 float64, 2 complex64, 3
// complex128)
int dq_sdw_wrap_q2_blocks_per_sm(int device, int dtype, int N, int TL, int og, int nb) {
    switch (dtype) {
        case 0: return dq::line_pass_blocks<float, 2>(device, N, TL, og, nb);
        case 1: return dq::line_pass_blocks<double, 2>(device, N, TL, og, nb);
        case 2: return dq::line_pass_blocks<dq::cplx<float>, 2>(device, N, TL, og, nb);
        case 3: return dq::line_pass_blocks<dq::cplx<double>, 2>(device, N, TL, og, nb);
    }
    return -static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
