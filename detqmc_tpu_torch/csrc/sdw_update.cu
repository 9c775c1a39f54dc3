// K4: SDW slice update (q x q site blocks), one CTA per walker.
//
// Replaces the TPU kernel detqmc_tpu/linalg/pallas_sdw_update.py
// (slice_update_sdw, kernel body _kernel, generic over q and over real or
// complex), which keeps 128 walkers in the vector lanes and G as (re, im)
// f32 planes in VMEM. Here one CTA holds one walker's G (h x h, h = q N)
// in shared memory and walks the N sites in order. Instances: q = 4
// complex (the full opdim-3 model), q = 4 real (the full opdim-1 chain),
// q = 2 complex (the opdim-2 reduced sector) and q = 2 real (opdim 1), in
// single and double precision. Per
// site i (orbital-major indices j_b = b N + i, pallas_sdw_update.py:197-331):
//     live  = dtau * (phi_new_i - phi_old_i) . sum_d phi[nb_d]   (live phi)
//     M     = 1 - G[j_a, j_b];   A = 1 + Delta_i M     (q x q)
//     R, adj(A)  closed form: the 12 2x2 minors at q = 4 (sdw_site.cuh)
//     accept     = lhs_i < c_det log|R|^2 + live
//     T     = adj(A) Delta_i / R
//     G    -= sum_b (sum_a G[:, j_a] T_ab) (x) (e_{j_b} - G[j_b, :])
//     phi_i = accept ? phi_new_i : phi_old_i
// The first design ran the scalar chain on thread 0 while 255 threads
// waited, four __syncthreads a site (two on a rejected one), and staged
// the site's columns, rows and combined columns through shared memory in
// passes of their own: 49 us a CTA at complex64 h = 64, 72 % of it thread
// 0's chain, 16 % the rank-4 update (its clock64() probe, solve_timing.py,
// NVIDIA H100 80GB HBM3, 700 W). This design:
//   - every warp runs the chain (sdw_site.cuh site_step_warp, 16 lanes, one
//     4x4 entry a lane, the same bits as the plain version), so all warps
//     decide alike and none waits for a broadcast: a rejected site takes
//     no barrier. Each warp keeps its own copy of the live field (a fast
//     warp's accept would race a slow warp's live term). The next site's
//     entries of Delta are loaded while a site is decided;
//   - every thread owns fixed entries of G: warp w the rows w + 8m, lane l
//     the columns l + 32k. An accepted site takes two barriers: all
//     threads stage the site's rows e_{j_b} - G[j_b, :] and each warp forms
//     the combined columns of its own rows from G's columns j_a (nothing
//     writes G before barrier 1); then every thread updates its own
//     entries; barrier 2 makes G current for the next site's chains and
//     frees the staged values. The staged rows and combined columns are
//     laid out [row][b], one vector load an entry's four operands;
//   - G stays in shared memory at every h: its entries in registers at
//     h = 64 (16 a thread) and 16 warps were tried on the card and were
//     not faster.
// The q = 2 instances are the same program at q = 2 (4 lanes a chain, the
// staged rows and combined columns [row][b] of two entries), the real ones
// (q = 4 and q = 2) with real scalars throughout; they are not tuned.
// What bounds it: the N dependent chains (~40 shuffles and ~60 dependent
// rounded operations a site) and, per accepted site, the rank-q update's
// h^2 x 8 q explicitly rounded FP32 (FP64) operations (h^2 x 2 q real),
// the plain version's rounding. A launch lasts as long as its slowest walker: at sdw_l4's
// acceptance (~0.25) the one of 128 that accepts the most sites.
// Every product and sum is explicitly rounded (cmul_rn ...) in the plain
// PyTorch version's order (linalg/sdw_update.py), so for equal inputs the
// kernel reproduces it bit for bit up to log(), and the accept decisions
// agree.
#include "sdw_site.cuh"

namespace dq {

// the phase probe's phases (Probe, common.cuh), mirrored by
// linalg/sdw_update.py PROBE_PHASES: the site's scalar chain (live term,
// decision, T), the barriers, the staging of the site's rows,
// the combined columns, the rank-4 update, the loads and stores
enum { kChain, kBarrier, kStage, kComb, kUpdate, kLoadStore, kPhases };

// the largest h the kernel takes (linalg/sdw_update.py MAX_H): the
// combined columns a lane forms are sized for it
constexpr int kMaxH = 160;

// shared memory of one CTA (linalg/sdw_update.py smem_bytes): G (h x h,
// h = q N), the staged rows and the combined columns (q h values each),
// then phi_new, lhs and every warp's copy of the live field (reals), and
// the neighbour table
inline size_t update_smem(int N, int opdim, int q, size_t sbytes, size_t rbytes) {
    const size_t h = size_t(q) * N;
    return sbytes * (h * h + 2 * q * h) + rbytes * (size_t(N) * opdim * (1 + kWarps) + N)
           + sizeof(int) * 4 * size_t(N);
}

template <typename S, int Q, bool PROBE>
__global__ void __launch_bounds__(kThreads, 1)
sdw_update_kernel(const S* __restrict__ G_in, const typename real_of<S>::type* __restrict__ phi_in,
                  const typename real_of<S>::type* __restrict__ phin_in,
                  const typename real_of<S>::type* __restrict__ lhs_in,
                  const S* __restrict__ delta_in, const int* __restrict__ nb_in,
                  S* __restrict__ G_out, typename real_of<S>::type* __restrict__ phi_out,
                  typename real_of<S>::type* __restrict__ acc_out, int N, int opdim,
                  typename real_of<S>::type dtau, typename real_of<S>::type c_det,
                  long long* probe_out) {
    using T = typename real_of<S>::type;
    constexpr int QQ = Q * Q;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int h = Q * N, NO = N * opdim;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const size_t wk = blockIdx.x;
    S* G = reinterpret_cast<S*>(smem_raw);              // h x h
    S* rows = G + h * h;                                // h x q: e_{j_b} - G[j_b, c]
    S* cc = rows + Q * h;                               // h x q: the combined columns
    T* phin = reinterpret_cast<T*>(cc + Q * h);         // N x opdim
    T* lhs = phin + NO;                                 // N
    T* phiw = lhs + N;                                  // kWarps x N x opdim
    int* nb = reinterpret_cast<int*>(phiw + kWarps * NO);   // N x 4
    Probe<PROBE, kPhases> probe;
    probe.start();

    const S* Gw = G_in + wk * size_t(h) * h;
    for (int idx = tid; idx < h * h; idx += kThreads) G[idx] = Gw[idx];
    for (int idx = tid; idx < NO; idx += kThreads) {
        phin[idx] = phin_in[wk * NO + idx];
        const T p = phi_in[wk * NO + idx];
        for (int w = 0; w < kWarps; ++w) phiw[w * NO + idx] = p;
    }
    for (int idx = tid; idx < N; idx += kThreads) lhs[idx] = lhs_in[wk * N + idx];
    for (int idx = tid; idx < 4 * N; idx += kThreads) nb[idx] = nb_in[idx];
    T* phi = phiw + warp * NO;               // this warp's live field
    // lanes e, e + q^2, ... take G_II's entry e = q a + b and its row a
    // and column b of Delta_i
    const SiteLanes<Q> L;
    const S* dw = delta_in + wk * QQ * size_t(N);
    SiteDelta<S, Q> dnext = site_delta<S, Q>(dw, L);
    // lane e's G_II entry G[a N + i][b N + i] (its 16 entries share a bank:
    // the next site's is loaded while a site is decided, again after an
    // accepted one)
    auto gii = [&](int i) { return G[(L.a * N + i) * h + L.b * N + i]; };
    T n_acc = T(0);
    probe.lap(kLoadStore);
    __syncthreads();
    probe.lap(kBarrier);
    S gnext = gii(0);

    for (int i = 0; i < N; ++i) {
        const SiteDelta<S, Q> d = dnext;
        const S g = gnext;
        if (i + 1 < N) {
            dnext = site_delta<S, Q>(dw + QQ * (i + 1), L);
            gnext = gii(i + 1);
        }
        // every warp decides, on identical inputs (site i's own field is
        // still the slice's: phi_i = phi_in_i)
        const T live = site_live(phi, phin + i * opdim, phi + i * opdim, nb + 4 * i,
                                 opdim, dtau);
        S Te;                                // entry e of T (on accept)
        const bool accept = site_step_warp<S, Q>(g, d, lhs[i], live, c_det, L, Te);
        probe.lap(kChain);
        if (!accept) continue;               // uniform: no barrier
        n_acc = add_rn(n_acc, T(1));
        if (lane == 0)
            for (int o = 0; o < opdim; ++o) phi[i * opdim + o] = phin[i * opdim + o];
        // the site's rows e_{j_b} - G[j_b, :] (rows[c][b]), staged by every
        // thread (nothing writes G before barrier 1)
        for (int idx = tid; idx < Q * h; idx += kThreads) {
            const int c = idx / Q, j = (idx % Q) * N + i;
            rows[idx] = rsub_rn(c == j ? T(1) : T(0), G[j * h + c]);
        }
        probe.lap(kStage);
        // the combined columns of this warp's rows, read from G's columns
        // j_a: lane l forms entry (row warp + 8 (l / q + (32 / q) t),
        // column l % q)
        constexpr int LQ = 32 / Q;           // rows a warp forms per t
        const int bl = lane % Q;
        S tcol[Q];                           // column bl of T
#pragma unroll
        for (int a = 0; a < Q; ++a) tcol[a] = shfl_c(Te, Q * a + bl);
        constexpr int TQ = (Q * kMaxH / kWarps + 31) / 32;
#pragma unroll
        for (int t = 0; t < TQ; ++t) {
            const int r = warp + kWarps * (lane / Q + LQ * t);
            if (kWarps * LQ * t >= h) break; // uniform: no row of this t
            const S* Gr = G + min(r, h - 1) * h + i;
            S cb = cmul_rn(Gr[0], tcol[0]);
#pragma unroll
            for (int a = 1; a < Q; ++a) cb = cadd_rn(cb, cmul_rn(Gr[a * N], tcol[a]));
            if (r < h) cc[Q * r + bl] = cb;
        }
        probe.lap(kComb);
        __syncthreads();                     // the staged rows, this warp's comb
        probe.lap(kBarrier);
        // the rank-q update of this thread's entries
        for (int c = lane; c < h; c += 32) {
            S rw[Q];
            load_q<Q>(rows + Q * c, rw);
#pragma unroll 8
            for (int r = warp; r < h; r += kWarps) {
                S cm[Q];
                load_q<Q>(cc + Q * r, cm);
                S u = cmul_rn(cm[0], rw[0]);
#pragma unroll
                for (int b = 1; b < Q; ++b) u = cadd_rn(u, cmul_rn(cm[b], rw[b]));
                G[r * h + c] = csub_rn(G[r * h + c], u);
            }
        }
        probe.lap(kUpdate);
        __syncthreads();                     // G for the chains, the staged values
        probe.lap(kBarrier);
        if (i + 1 < N) gnext = gii(i + 1);
    }

    __syncthreads();                         // every thread's last update
    S* Go = G_out + wk * size_t(h) * h;
    for (int idx = tid; idx < h * h; idx += kThreads) Go[idx] = G[idx];
    // warp 0's field is every warp's
    for (int idx = tid; idx < NO; idx += kThreads) phi_out[wk * NO + idx] = phiw[idx];
    if (tid == 0) acc_out[wk] = n_acc;
    probe.lap(kLoadStore);
    probe.store(probe_out);
}

template <typename S, int Q, bool PROBE = false>
int sdw_update(int device, const void* G, const void* phi, const void* phin,
               const void* lhs, const void* delta, const void* nb, void* G_out,
               void* phi_out, void* acc_out, int W, int N, int opdim,
               double dtau, double c_det, void* stream, long long* probe = nullptr) {
    using T = typename real_of<S>::type;
    if (Q * N > kMaxH) return static_cast<int>(cudaErrorInvalidValue);
    return launch_smem(device, sdw_update_kernel<S, Q, PROBE>, W,
                       update_smem(N, opdim, Q, sizeof(S), sizeof(T)), stream,
                       static_cast<const S*>(G), static_cast<const T*>(phi),
                       static_cast<const T*>(phin), static_cast<const T*>(lhs),
                       static_cast<const S*>(delta), static_cast<const int*>(nb),
                       static_cast<S*>(G_out), static_cast<T*>(phi_out),
                       static_cast<T*>(acc_out), N, opdim, static_cast<T>(dtau),
                       static_cast<T>(c_det), probe);
}

template <typename S, int Q>
int update_blocks(int device, int N, int opdim) {
    using T = typename real_of<S>::type;
    return blocks_per_sm(device, sdw_update_kernel<S, Q, false>,
                         update_smem(N, opdim, Q, sizeof(S), sizeof(T)));
}

// CTAs per SM (no launch) of the q = 4 and the q = 2 instances (dtype: 0
// float32, 1 float64, 2 complex64, 3 complex128)
template <int Q>
int update_blocks_of(int device, int dtype, int N, int opdim) {
    switch (dtype) {
        case 0: return update_blocks<float, Q>(device, N, opdim);
        case 1: return update_blocks<double, Q>(device, N, opdim);
        case 2: return update_blocks<cplx<float>, Q>(device, N, opdim);
        case 3: return update_blocks<cplx<double>, Q>(device, N, opdim);
    }
    return -static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace dq

// the C entries: G and delta of the instance's scalar (complex64 / 128 or
// float32 / 64), the real tensors in its real type
#define DQ_SDW_UPDATE_ENTRY(NAME, S, Q)                                              \
    extern "C" int NAME(int device, const void* G, const void* phi, const void* phin, \
                        const void* lhs, const void* delta, const void* nb,          \
                        void* G_out, void* phi_out, void* acc_out, int W, int N,     \
                        int opdim, double dtau, double c_det, void* stream) {        \
        return dq::sdw_update<S, Q>(device, G, phi, phin, lhs, delta, nb, G_out,     \
                                    phi_out, acc_out, W, N, opdim, dtau, c_det,      \
                                    stream);                                         \
    }

DQ_SDW_UPDATE_ENTRY(dq_sdw_update_c64, dq::cplx<float>, 4)
DQ_SDW_UPDATE_ENTRY(dq_sdw_update_c128, dq::cplx<double>, 4)
DQ_SDW_UPDATE_ENTRY(dq_sdw_update_f32, float, 4)
DQ_SDW_UPDATE_ENTRY(dq_sdw_update_f64, double, 4)
DQ_SDW_UPDATE_ENTRY(dq_sdw_update_q2_c64, dq::cplx<float>, 2)
DQ_SDW_UPDATE_ENTRY(dq_sdw_update_q2_c128, dq::cplx<double>, 2)
DQ_SDW_UPDATE_ENTRY(dq_sdw_update_q2_f32, float, 2)
DQ_SDW_UPDATE_ENTRY(dq_sdw_update_q2_f64, double, 2)

extern "C" {

// the complex64 update with the phase probe on: probe (W x 8 int64) gets
// each CTA's cycles per phase (PROBE_PHASES), its total cycles and ns
int dq_sdw_update_probe_c64(int device, const void* G, const void* phi,
                            const void* phin, const void* lhs, const void* delta,
                            const void* nb, void* G_out, void* phi_out, void* acc_out,
                            int W, int N, int opdim, double dtau, double c_det,
                            void* probe, void* stream) {
    return dq::sdw_update<dq::cplx<float>, 4, true>(
        device, G, phi, phin, lhs, delta, nb, G_out, phi_out, acc_out, W, N, opdim, dtau,
        c_det, stream, static_cast<long long*>(probe));
}

// CTAs per SM (no launch) of the instance at q = 4 or 2 (dtype as
// dq::update_blocks_of)
int dq_sdw_update_blocks_per_sm(int device, int dtype, int q, int N, int opdim) {
    if (q == 4) return dq::update_blocks_of<4>(device, dtype, N, opdim);
    if (q == 2) return dq::update_blocks_of<2>(device, dtype, N, opdim);
    return -static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
