// K6: fused SDW wrap and one-sided B apply, complex64 / complex128.
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

// row strides (elements): lines TL + lpad (none at TL = 4, the fallback
// plans' width), F rows round_up(N, 4) + fpad; both keep rows 16-byte
// aligned. Mirrored by linalg/sdw_wrap.py smem_bytes.
template <typename T> struct k6_pad;
template <> struct k6_pad<float> { static constexpr int lines = 2, f = 4; };
template <> struct k6_pad<double> { static constexpr int lines = 1, f = 2; };

template <typename T>
__host__ __device__ inline int k6_ldt(int TL) { return TL + (TL >= 8 ? k6_pad<T>::lines : 0); }
template <typename T>
__host__ __device__ inline int k6_ldf(int N) { return round_up(N, 4) + k6_pad<T>::f; }

// nb line buffers of h x ldt, D's blocks (16 N), og orbitals of F
template <typename T>
size_t k6_smem_bytes(int N, int TL, int og, int nb) {
    return sizeof(cplx<T>) * (size_t(nb) * 4 * N * k6_ldt<T>(TL) + 16 * size_t(N))
           + sizeof(T) * size_t(og) * N * k6_ldf<T>(N);
}

// F_o[m][n] (m < N, n < round_up(N, 4), zero beyond N) for the og orbitals
// from o0: E_o or, with e_trans, E_o^T; E read row by row (coalesced)
template <typename T>
__device__ void stage_f(T* Fs, const T* E, int N, int o0, int og, int e_trans) {
    const int NP = round_up(N, 4), ldf = k6_ldf<T>(N);
    for (int oo = 0; oo < og; ++oo) {
        const T* Eo = E + size_t(o0 + oo) * N * N;
        T* F = Fs + size_t(oo) * N * ldf;
        for (int idx = threadIdx.x; idx < N * NP; idx += kThreads) {
            const int a = idx / NP, b = idx - a * NP;
            if (b < N) {
                const T v = Eo[a * N + b];   // E_o[a][b]
                if (e_trans) F[b * ldf + a] = v;
                else         F[a * ldf + b] = v;
            } else {
                F[a * ldf + b] = T(0);       // n = b beyond N, row m = a
            }
        }
    }
}

// lines per thread in the kinetic step: 4 in complex64, 2 in complex128
// (whose smaller tiles would leave threads idle at 4); mirrored by
// linalg/sdw_wrap.py lines_per_thread
template <typename T>
__host__ __device__ constexpr int k6_rt() { return sizeof(T) == 4 ? 4 : 2; }

// out[o N + n][t] = sum_m in[o N + m][t] F_o[m][n] for the og orbitals
// from o0 (F of orbital o at Fs + (o - o0) N ldf): an RT x 4 block of
// (t, n) per thread
template <typename T>
__device__ void kin_block(const cplx<T>* in, cplx<T>* out, const T* Fs, int N, int TL,
                          int o0, int og) {
    constexpr int RT = k6_rt<T>();
    const int NG = round_up(N, 4) / 4, TG = TL / RT, ldt = k6_ldt<T>(TL), ldf = k6_ldf<T>(N);
    for (int p = threadIdx.x; p < og * NG * TG; p += kThreads) {
        const int ng = p % NG, rest = p / NG, tg = rest % TG, oo = rest / TG;
        const int n0 = 4 * ng, t0 = RT * tg, o = o0 + oo;
        const T* F = Fs + size_t(oo) * N * ldf + n0;
        const cplx<T>* src = in + size_t(o) * N * ldt + t0;
        cplx<T> acc[RT][4];
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[r][j] = mk(T(0), T(0));
#pragma unroll 2
        for (int m = 0; m < N; ++m) {
            T f[4];
            cplx<T> x[RT];
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
                for (int j = 0; j < 4; ++j) {
                    acc[r][j].re = fma(x[r].re, f[j], acc[r][j].re);
                    acc[r][j].im = fma(x[r].im, f[j], acc[r][j].im);
                }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            if (n0 + j >= N) break;
            cplx<T>* dst = out + (size_t(o) * N + n0 + j) * ldt + t0;
#pragma unroll
            for (int r = 0; r < RT; ++r) dst[r] = acc[r][j];
        }
    }
}

// the kinetic step of all four orbitals: F staged per group of og
// orbitals when og < 4 (og == 4: staged once per CTA); ends with a barrier
template <typename T, typename PR>
__device__ void kin_step(const cplx<T>* in, cplx<T>* out, T* Fs, const T* E, int N, int TL,
                         int og, int e_trans, PR& probe) {
    for (int o0 = 0; o0 < 4; o0 += og) {
        if (og < 4) {
            if (o0 > 0) __syncthreads();   // the last group is done with Fs
            stage_f(Fs, E, N, o0, og, e_trans);
            __syncthreads();
            probe.lap(kStageF);
        }
        kin_block(in, out, Fs, N, TL, o0, og);
    }
    __syncthreads();
    probe.lap(kKinetic);
}

// out[b N + i][t] = sum_a in[a N + i][t] Dm_i[a][b]: the four b of a site
// and line per thread (TL = 1 << tl_shift)
template <typename T>
__device__ void dv_step(const cplx<T>* in, cplx<T>* out, const cplx<T>* Ds, int N,
                        int TL, int tl_shift) {
    const int ldt = k6_ldt<T>(TL);
    for (int p = threadIdx.x; p < N * TL; p += kThreads) {
        const int t = p & (TL - 1), i = p >> tl_shift;
        cplx<T> x[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) x[a] = in[(size_t(a) * N + i) * ldt + t];
        const cplx<T>* d = Ds + i * 16;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
            cplx<T> acc = x[0] * d[b];
#pragma unroll
            for (int a = 1; a < 4; ++a) acc += x[a] * d[4 * a + b];
            out[(size_t(b) * N + i) * ldt + t] = acc;
        }
    }
}

// Lines l0 .. l0 + TL of X (W's walker at X) into dst[k][t] by cp.async,
// zero beyond h (TL = 1 << tl_shift): columns of X (left) as 16-byte pieces
// of a row, rows of X (right) a warp per line along k (coalesced)
template <typename T>
__device__ void load_lines(cplx<T>* dst, const cplx<T>* X, int h, int ldt, int l0,
                           int TL, int tl_shift, int left) {
    constexpr int CH = 16 / sizeof(cplx<T>);    // elements per 16 bytes
    const cplx<T> zero = mk(T(0), T(0));
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (left) {
        const int cshift = tl_shift - (CH == 2 ? 1 : 0), cmask = (1 << cshift) - 1;
        for (int idx = threadIdx.x; idx < h << cshift; idx += kThreads) {
            const int k = idx >> cshift, t = (idx & cmask) * CH;
            cplx<T>* d = dst + k * ldt + t;
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
                cplx<T>* d = dst + k * ldt + t;
                if (l < h) cp_async(d, X + size_t(l) * h + k);
                else *d = zero;
            }
        }
    }
    cp_async_commit();
}

// src[k][t] back to lines l0 .. l0 + TL of X (those below h), as
// load_lines reads them
template <typename T>
__device__ void store_lines(const cplx<T>* src, cplx<T>* X, int h, int ldt, int l0,
                            int TL, int tl_shift, int left) {
    constexpr int CH = 16 / sizeof(cplx<T>);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (left) {
        const int cshift = tl_shift - (CH == 2 ? 1 : 0), cmask = (1 << cshift) - 1;
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
template <typename T, bool PROBE>
__global__ void __launch_bounds__(kThreads, 1)
line_pass_kernel(const cplx<T>* X_in, cplx<T>* X_out, const T* __restrict__ E,
                 const cplx<T>* __restrict__ D, int N, int TL, int og, int nb, int tpc,
                 PassFlags fl, long long* probe_out) {
    using S = cplx<T>;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    Probe<PROBE, kPhases> probe;
    probe.start();
    const int tid = threadIdx.x, h = 4 * N, ldt = k6_ldt<T>(TL), tl_shift = __ffs(TL) - 1;
    const int tiles = (h + TL - 1) / TL, per_w = (tiles + tpc - 1) / tpc;
    const size_t w = blockIdx.x / per_w;
    const int t_begin = int(blockIdx.x - w * per_w) * tpc;
    const int t_end = min(tiles, t_begin + tpc);
    const size_t buf_elems = size_t(h) * ldt;
    const S* Xw = X_in + w * size_t(h) * h;
    S* Yw = X_out + w * size_t(h) * h;
    S* lines = reinterpret_cast<S*>(smem_raw);    // nb x h x ldt
    S* Ds = lines + nb * buf_elems;               // N x 16: Dm_i[a][b]
    T* Fs = reinterpret_cast<T*>(Ds + 16 * N);    // og x N x ldf

    if (t_begin < t_end) load_lines(lines, Xw, h, ldt, t_begin * TL, TL, tl_shift, fl.left);
    const S* Dw = D + w * size_t(N) * 16;
    for (int idx = tid; idx < 16 * N; idx += kThreads) {
        const int i = idx >> 4, a = (idx >> 2) & 3, b = idx & 3;
        S d = fl.d_trans ? Dw[i * 16 + 4 * b + a] : Dw[idx];
        if (fl.d_conj) d = conj_(d);
        Ds[idx] = d;
    }
    probe.lap(kLines);
    if (og == 4) stage_f(Fs, E, N, 0, 4, fl.e_trans);
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
            kin_step(cur, tmp, Fs, E, N, TL, og, fl.e_trans, probe);
            dv_step(tmp, cur, Ds, N, TL, tl_shift);
            __syncthreads();
            probe.lap(kDStep);
        } else {
            dv_step(cur, tmp, Ds, N, TL, tl_shift);
            __syncthreads();
            probe.lap(kDStep);
            kin_step(tmp, cur, Fs, E, N, TL, og, fl.e_trans, probe);
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

template <typename T>
int line_pass(int device, const void* X_in, void* X_out, const void* E, const void* D,
              int W, int N, int TL, int og, int nb, int tpc, PassFlags fl, void* stream,
              long long* probe) {
    const size_t smem = k6_smem_bytes<T>(N, TL, og, nb);
    const int tiles = (4 * N + TL - 1) / TL, per_w = (tiles + tpc - 1) / tpc;
    const auto args = [&](auto kernel) {
        return launch_smem(device, kernel, W * per_w, smem, stream,
                           static_cast<const cplx<T>*>(X_in), static_cast<cplx<T>*>(X_out),
                           static_cast<const T*>(E), static_cast<const cplx<T>*>(D), N, TL,
                           og, nb, tpc, fl, probe);
    };
    return probe ? args(line_pass_kernel<T, true>) : args(line_pass_kernel<T, false>);
}

inline bool k6_plan_ok(int N, int TL, int og, int nb, int tpc) {
    return N > 0 && TL >= 4 && TL % 4 == 0 && (og == 1 || og == 2 || og == 4) &&
           (nb == 2 || nb == 3) && tpc >= 1;
}

template <typename T>
int sdw_wrap(int device, const void* G, void* Tmp, void* G_out, const void* E,
             const void* Einv, const void* D, const void* Dinv, int W, int N, int up,
             int TL, int og, int nb, int tpc, void* stream, long long* probe = nullptr) {
    if (!k6_plan_ok(N, TL, og, nb, tpc)) return static_cast<int>(cudaErrorInvalidValue);
    // right pass on rows into Tmp, then left pass on columns into G_out; the
    // probe's records: the right pass's CTAs, then the left pass's
    const PassFlags right{0, up, 0, 0, 0}, left{1, up, 1, 1, 0};
    const int tiles = (4 * N + TL - 1) / TL;
    const size_t ctas = size_t(W) * ((tiles + tpc - 1) / tpc);
    int err = line_pass<T>(device, G, Tmp, up ? Einv : E, up ? Dinv : D, W, N, TL, og,
                           nb, tpc, right, stream, probe);
    if (err) return err;
    return line_pass<T>(device, Tmp, G_out, up ? E : Einv, up ? D : Dinv, W, N, TL, og,
                        nb, tpc, left, stream,
                        probe ? probe + ctas * (kPhases + 2) : nullptr);
}

template <typename T>
int sdw_apply(int device, const void* X, void* X_out, const void* E, const void* D,
              int W, int N, int herm, int TL, int og, int nb, int tpc, void* stream,
              long long* probe = nullptr) {
    if (!k6_plan_ok(N, TL, og, nb, tpc)) return static_cast<int>(cudaErrorInvalidValue);
    // B X: E @ X then D . ;  B^H X: D^H . X then E^T @
    const PassFlags fl = herm ? PassFlags{1, 0, 0, 0, 1} : PassFlags{1, 1, 1, 1, 0};
    return line_pass<T>(device, X, X_out, E, D, W, N, TL, og, nb, tpc, fl, stream,
                        probe);
}

template <typename T>
int line_pass_blocks(int device, int N, int TL, int og, int nb) {
    if (!k6_plan_ok(N, TL, og, nb, 1)) return -static_cast<int>(cudaErrorInvalidValue);
    return blocks_per_sm(device, line_pass_kernel<T, false>, k6_smem_bytes<T>(N, TL, og, nb));
}

}  // namespace dq

extern "C" {

// E, Einv: the real kinetic factors (float32 / float64); TL, og, nb, tpc:
// the plan (linalg/sdw_wrap.py plan)
int dq_sdw_wrap_c64(int device, const void* G, void* Tmp, void* G_out, const void* E,
                    const void* Einv, const void* D, const void* Dinv, int W, int N,
                    int up, int TL, int og, int nb, int tpc, void* stream) {
    return dq::sdw_wrap<float>(device, G, Tmp, G_out, E, Einv, D, Dinv, W, N, up, TL,
                               og, nb, tpc, stream);
}

int dq_sdw_wrap_c128(int device, const void* G, void* Tmp, void* G_out, const void* E,
                     const void* Einv, const void* D, const void* Dinv, int W, int N,
                     int up, int TL, int og, int nb, int tpc, void* stream) {
    return dq::sdw_wrap<double>(device, G, Tmp, G_out, E, Einv, D, Dinv, W, N, up, TL,
                                og, nb, tpc, stream);
}

int dq_sdw_apply_c64(int device, const void* X, void* X_out, const void* E,
                     const void* D, int W, int N, int herm, int TL, int og, int nb,
                     int tpc, void* stream) {
    return dq::sdw_apply<float>(device, X, X_out, E, D, W, N, herm, TL, og, nb, tpc,
                                stream);
}

int dq_sdw_apply_c128(int device, const void* X, void* X_out, const void* E,
                      const void* D, int W, int N, int herm, int TL, int og, int nb,
                      int tpc, void* stream) {
    return dq::sdw_apply<double>(device, X, X_out, E, D, W, N, herm, TL, og, nb, tpc,
                                 stream);
}

// the same with the phase probe on (complex64, the main path's dtype): probe
// gets each CTA's cycles per phase, total cycles and total ns (a wrap: the
// right pass's CTAs, then the left pass's)
int dq_sdw_wrap_probe_c64(int device, const void* G, void* Tmp, void* G_out,
                          const void* E, const void* Einv, const void* D,
                          const void* Dinv, int W, int N, int up, int TL, int og, int nb,
                          int tpc, void* probe, void* stream) {
    return dq::sdw_wrap<float>(device, G, Tmp, G_out, E, Einv, D, Dinv, W, N, up, TL,
                               og, nb, tpc, stream, static_cast<long long*>(probe));
}

int dq_sdw_apply_probe_c64(int device, const void* X, void* X_out, const void* E,
                           const void* D, int W, int N, int herm, int TL, int og,
                           int nb, int tpc, void* probe, void* stream) {
    return dq::sdw_apply<float>(device, X, X_out, E, D, W, N, herm, TL, og, nb, tpc,
                                stream, static_cast<long long*>(probe));
}

// CTAs of a K6 line pass per SM at this plan (complex: complex128, else
// complex64), or -(cudaError)
int dq_sdw_wrap_blocks_per_sm(int device, int complex128, int N, int TL, int og, int nb) {
    return complex128 ? dq::line_pass_blocks<double>(device, N, TL, og, nb)
                      : dq::line_pass_blocks<float>(device, N, TL, og, nb);
}

}  // extern "C"
