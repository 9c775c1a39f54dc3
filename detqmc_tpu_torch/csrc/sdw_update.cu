// K4: SDW slice update (q x q site blocks), one CTA per walker.
//
// Replaces the TPU kernel detqmc_tpu/linalg/pallas_sdw_update.py
// (slice_update_sdw, kernel body _kernel, generic over q and over real or
// complex), which keeps 128 walkers in the vector lanes and G as (re, im)
// f32 planes in VMEM. Here one CTA holds one walker's G (h x h, h = q N)
// in shared memory and walks the N sites in order. Instances: q = 4
// complex (the full opdim-3 model) in the first body, q = 4 real (the
// full opdim-1 chain), q = 2 complex (the opdim-2 reduced sector) and
// q = 2 real (opdim 1) in the look-ahead body below, each in single and
// double precision. Per
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
// This first body runs the complex q = 4 instances; the q = 2 and real
// q = 4 ones run the look-ahead body below (linalg/sdw_update.py plan),
// which decides a round of sites at once. What bounds the first body: the N dependent chains (~40 shuffles and ~60 dependent
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
// linalg/sdw_update.py PROBE_PHASES: the site's chain (the gather of G_II
// and Delta_i, the live term, A, det and adj, the log and the decision,
// T: sdw_site.cuh site_step_warp's laps 0-3), the barriers, the staging
// of the site's rows, the combined columns, the rank-q update, the loads
// and stores. A load is charged where its value is first used.
enum { kGather, kLive, kA, kDetAdj, kDecision, kT, kBarrier, kStage, kComb, kUpdate,
       kLoadStore, kPhases };

// the largest h the kernel takes (linalg/sdw_update.py MAX_H): the
// combined columns a lane forms are sized for it
constexpr int kMaxH = 160;

// shared memory of one CTA (linalg/sdw_update.py smem_bytes): G (h x h,
// h = q N), the staged rows and the combined columns (q h values each),
// then phi_new, lhs and every warp's copy of the live field (reals), and
// the neighbour table. The models size what K4 takes by it at every
// instance (the look-ahead body fits wherever it does)
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
        probe.lap(kGather);
        // every warp decides, on identical inputs (site i's own field is
        // still the slice's: phi_i = phi_in_i)
        const T live = site_live(phi, phin + i * opdim, phi + i * opdim, nb + 4 * i,
                                 opdim, dtau);
        probe.lap(kLive);
        S Te;                                // entry e of T (on accept)
        const bool accept = site_step_warp<S, Q>(g, d, lhs[i], live, c_det, L, Te,
                                                 [&](int k) { probe.lap(kA + k); });
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


// ---- the look-ahead body: q = 2 (complex and real) and real q = 4 ----------
// One walker a CTA of kWarps = 8 warps, shaped by the first body's probe
// of these instances (PERF.md): there a rejected site cost 0.45-0.6
// us, the walk's dependent chain, an accepted site as much again, and the
// barriers < 1 % of a CTA. Here the sites are decided in rounds:
//   - warp w decides site i0 + w as if the round's sites before it are
//     rejected (G, and the field its live term reads, are then what they
//     would be), all warps at once; one barrier publishes the decisions
//     (a byte a warp, read as one word), and the round's first accepted
//     site j is the walk's next accepted site (every site before it
//     rejected, its decision and T exact). A run of rejected sites costs
//     a chain a round, not a chain a site, and every decision has the
//     sequential walk's bits;
//   - after an accepted site, all threads stage the rows e_{j_b} -
//     G[j_b, :] and the combined columns into shared memory, and warps
//     0 ... nc - 1 (half of them, a quarter at real q = 4) read the G_II
//     of sites j + 1 ... before a barrier; the next round then runs the
//     update on the other warps (kRB rows'
//     operands loaded before their stores: the first body's update waited
//     for each store before its next loads) while those warps decide the
//     next sites from their G_II corrected by the update's own operations
//     (correct_site: the same bits as the updated G);
//   - at q = 2 every lane runs the whole chain in registers
//     (site_step_lane: no shuffle); real q = 4 keeps site_step_warp (16
//     lanes; every lane's own chain cost as much on four warps and twice
//     as much on eight);
//   - Delta sits in shared memory beside G (row stride h + 1: a site's
//     column entries of consecutive rows fall in distinct banks); each
//     lane owns KC = ceil(h / 32) columns (a template parameter).
// What bounds it (PERF.md): an accept-heavy walker sets the launch's
// time, and for it each accepted site costs a round (the longer of the
// chain and the update on the other warps) plus the staging between two
// barriers.

// a byte count rounded up to 16 (the look-ahead body's segments)
__host__ __device__ constexpr size_t al16(size_t b) { return (b + 15) / 16 * 16; }

// shared memory of one CTA of the look-ahead body (linalg/sdw_update.py
// ahead_smem_bytes): G (h x (h + 1)), the staged rows and the combined
// columns (h x q each), Delta (N x q x q), each warp's T (kWarps x q x q),
// then the reals phi_new, lhs and the live field, the round flags (2 x 8
// bytes) and the neighbour table, each segment 16-byte aligned
inline size_t ahead_smem(int N, int opdim, int q, size_t sbytes, size_t rbytes) {
    const size_t h = size_t(q) * N, NO = size_t(N) * opdim;
    return al16(sbytes * h * (h + 1)) + 2 * al16(sbytes * h * q) + al16(sbytes * N * q * q)
           + al16(sbytes * kWarps * q * q) + 2 * al16(rbytes * NO) + al16(rbytes * N)
           + 16 + al16(sizeof(int) * 4 * N);
}

// The q = 2 step of one site on every lane alike, from all four entries
// of G_II (g, entry 2 a + b) and Delta_i (D, row-major) in registers:
// site_step_warp's operations on each entry in its order, lane by lane,
// so the same bits. On accept all of T in Tm; lap(k) as site_step_warp's.
template <typename S, typename Lap>
__device__ __forceinline__ bool site_step_lane(const S (&g)[4], const S (&D)[4],
                                               typename real_of<S>::type lhs,
                                               typename real_of<S>::type live,
                                               typename real_of<S>::type c_det, S (&Tm)[4],
                                               Lap lap) {
    using T = typename real_of<S>::type;
    S M[4], A[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) M[e] = rsub_rn(e == 0 || e == 3 ? T(1) : T(0), g[e]);
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b)
            A[2 * a + b] = radd_rn(cadd_rn(cmul_rn(D[2 * a], M[b]), cmul_rn(D[2 * a + 1], M[2 + b])),
                                   a == b ? T(1) : T(0));
    lap(0);
    const S det = csub_rn(cmul_rn(A[0], A[3]), cmul_rn(A[1], A[2]));
    lap(1);
    const T r2 = abs2_rn(det);
    const bool accept = lhs < add_rn(mul_rn(c_det, log_t(r2)), live);
    lap(2);
    if (!accept) return false;               // warp-uniform
    const S adj[4] = {A[3], -A[1], -A[2], A[0]};   // [[a11, -a01], [-a10, a00]]
    const S rinv = conj_scale_rn(det, div_rn(T(1), r2));
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b)
            Tm[2 * a + b] = cmul_rn(
                cadd_rn(cmul_rn(adj[2 * a], D[b]), cmul_rn(adj[2 * a + 1], D[2 + b])), rinv);
    lap(3);
    return true;
}

// a site's operands as its chain reads them: at q = 2 all of G_II and
// Delta_i on every lane, at q = 4 lane e's entry of G_II and its row and
// column of Delta_i (site_step_warp)
template <typename S, int Q>
struct SiteOps {
    S g[4], d[4];
};
template <typename S>
struct SiteOps<S, 4> {
    S g;
    SiteDelta<S, 4> d;
};

// site i's operands from G (row stride hs) and Delta (dl) in shared memory
template <typename S, int Q>
__device__ __forceinline__ void gather_site(const S* G, const S* dl, int N, int hs, int i,
                                            const SiteLanes<Q>& L, SiteOps<S, Q>& o) {
    if constexpr (Q == 2) {
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
            for (int b = 0; b < 2; ++b) o.g[2 * a + b] = G[(a * N + i) * hs + b * N + i];
#pragma unroll
        for (int e = 0; e < 4; ++e) o.d[e] = dl[4 * i + e];
    } else {
        o.g = G[(L.a * N + i) * hs + L.b * N + i];
        o.d = site_delta<S, 4>(dl + 16 * i, L);
    }
}

// the step of the site with operands o: on accept T (row-major) written
// to Tw, the warp's slot in shared memory
template <typename S, int Q, typename Lap>
__device__ __forceinline__ bool site_step_k4(const SiteOps<S, Q>& o, typename real_of<S>::type lhs,
                                             typename real_of<S>::type live,
                                             typename real_of<S>::type c_det,
                                             const SiteLanes<Q>& L, S* Tw, Lap lap) {
    if constexpr (Q == 2) {
        S Tm[4];
        const bool accept = site_step_lane<S>(o.g, o.d, lhs, live, c_det, Tm, lap);
        if (accept && (threadIdx.x & 31) == 0)
#pragma unroll
            for (int f = 0; f < 4; ++f) Tw[f] = Tm[f];
        return accept;
    } else {
        S Te;
        const bool accept = site_step_warp<S, Q>(o.g, o.d, lhs, live, c_det, L, Te, lap);
        if (accept && (threadIdx.x & 31) < Q * Q) Tw[threadIdx.x & 31] = Te;
        return accept;
    }
}

// site i's live term (sdw_site.cuh site_live's operations in its order)
// with opdim <= 3 unrolled: no loop, so it schedules beside the chain
template <typename T>
__device__ __forceinline__ T live_k4(const T* phi, const T* phin_i, const T* phi0_i,
                                     const int* nb_i, int opdim, T dtau) {
    const int4 n = *reinterpret_cast<const int4*>(nb_i);
    T dot = T(0);
#pragma unroll
    for (int o = 0; o < 3; ++o)
        if (o < opdim) {
            T snb = add_rn(phi[n.x * opdim + o], phi[n.y * opdim + o]);
            snb = add_rn(snb, phi[n.z * opdim + o]);
            snb = add_rn(snb, phi[n.w * opdim + o]);
            const T d = mul_rn(sub_rn(phin_i[o], phi0_i[o]), snb);
            dot = o == 0 ? d : add_rn(dot, d);
        }
    return mul_rn(dtau, dot);
}

// rows an update step of the look-ahead body loads before its stores
constexpr int kRB = 4;

// site k's G_II after the pending accepted site's update, from its
// entries before it (o.g), the combined columns (cc) and the staged rows
// (rows): the update's own operations on those entries, so the same bits
template <typename S, int Q>
__device__ __forceinline__ void correct_site(SiteOps<S, Q>& o, const S* cc, const S* rows, int N,
                                             int k, const SiteLanes<Q>& L) {
    auto upd = [&](S g, int a, int b) {
        S cm[Q], rw[Q];
        load_q<Q>(cc + Q * (a * N + k), cm);
        load_q<Q>(rows + Q * (b * N + k), rw);
        S u = cmul_rn(cm[0], rw[0]);
#pragma unroll
        for (int t = 1; t < Q; ++t) u = cadd_rn(u, cmul_rn(cm[t], rw[t]));
        return csub_rn(g, u);
    };
    if constexpr (Q == 2) {
#pragma unroll
        for (int e = 0; e < 4; ++e) o.g[e] = upd(o.g[e], e >> 1, e & 1);
    } else {
        o.g = upd(o.g, L.a, L.b);
    }
}

// the rank-q update of rows w0 + ws m (at this lane's KC columns) with the
// staged rows and the combined columns, kRB rows' operands loaded before
// their stores
template <typename S, int Q, int KC>
__device__ __forceinline__ void update_rows(S* G, const S* rows, const S* cc, int h, int hs,
                                            int lane, int w0, int ws) {
    S rw[KC][Q];
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
        if (kc < KC - 1 || lane + 32 * kc < h) load_q<Q>(rows + Q * (lane + 32 * kc), rw[kc]);
    for (int r0 = w0; r0 < h; r0 += kRB * ws) {
        S cm[kRB][Q], gv[kRB][KC];
#pragma unroll
        for (int t = 0; t < kRB; ++t) {
            const int r = min(r0 + t * ws, h - 1);
            load_q<Q>(cc + Q * r, cm[t]);
#pragma unroll
            for (int kc = 0; kc < KC; ++kc)
                if (kc < KC - 1 || lane + 32 * kc < h) gv[t][kc] = G[r * hs + lane + 32 * kc];
        }
#pragma unroll
        for (int t = 0; t < kRB; ++t) {
            const int r = r0 + t * ws;
            if (r < h)
#pragma unroll
                for (int kc = 0; kc < KC; ++kc) {
                    const int c = lane + 32 * kc;
                    if (kc < KC - 1 || c < h) {
                        S u = cmul_rn(cm[t][0], rw[kc][0]);
#pragma unroll
                        for (int b = 1; b < Q; ++b) u = cadd_rn(u, cmul_rn(cm[t][b], rw[kc][b]));
                        G[r * hs + c] = csub_rn(gv[t][kc], u);
                    }
                }
        }
    }
}

template <typename S, int Q, int KC, bool PROBE>
__global__ void __launch_bounds__(kThreads)
sdw_update_ahead_kernel(const S* __restrict__ G_in, const typename real_of<S>::type* __restrict__ phi_in,
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
    const int h = Q * N, hs = h + 1, NO = N * opdim;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    // the warps that decide sites while an accepted site's update runs on
    // the others: half of them at q = 2; a quarter at real q = 4, whose
    // update (8 rounded operations an entry of h^2 at h = 2 q N) outlasted
    // the deciding warps' chains on four warps (PERF.md)
    constexpr int nt = kThreads, nw = kWarps, nc = Q == 4 ? nw / 4 : nw / 2;
    const size_t wk = blockIdx.x;
    unsigned char* sp = smem_raw;
    S* G = reinterpret_cast<S*>(sp);                    // h x hs
    sp += al16(sizeof(S) * h * hs);
    S* rows = reinterpret_cast<S*>(sp);                 // h x q: e_{j_b} - G[j_b, c]
    sp += al16(sizeof(S) * h * Q);
    S* cc = reinterpret_cast<S*>(sp);                   // h x q: the combined columns
    sp += al16(sizeof(S) * h * Q);
    S* dl = reinterpret_cast<S*>(sp);                   // N x q x q: Delta
    sp += al16(sizeof(S) * N * QQ);
    S* Ts = reinterpret_cast<S*>(sp);                   // kWarps x q x q: each warp's T
    sp += al16(sizeof(S) * nw * QQ);
    T* phin = reinterpret_cast<T*>(sp);                 // N x opdim
    sp += al16(sizeof(T) * NO);
    T* phi = reinterpret_cast<T*>(sp);                  // N x opdim: the live field
    sp += al16(sizeof(T) * NO);
    T* lhs = reinterpret_cast<T*>(sp);                  // N
    sp += al16(sizeof(T) * N);
    // a round's decisions, a byte a warp, two rounds' worth (each read as
    // one 8-byte word)
    unsigned char* flags = sp;
    sp += 16;
    int* nb = reinterpret_cast<int*>(sp);               // N x 4
    Probe<PROBE, kPhases> probe;
    probe.start();

    // the small operands by cp.async, G by plain loads (row r of idx =
    // r h + c from a float reciprocal: exact for h <= kMaxH)
    const S* dw = delta_in + wk * QQ * size_t(N);
    for (int idx = tid; idx < N * QQ; idx += nt) cp_async(dl + idx, dw + idx);
    for (int idx = tid; idx < NO; idx += nt) {
        cp_async(phin + idx, phin_in + wk * NO + idx);
        cp_async(phi + idx, phi_in + wk * NO + idx);
    }
    for (int idx = tid; idx < N; idx += nt) cp_async(lhs + idx, lhs_in + wk * N + idx);
    for (int idx = tid; idx < 4 * N; idx += nt)
        cp_async(reinterpret_cast<float*>(nb) + idx, reinterpret_cast<const float*>(nb_in) + idx);
    cp_async_commit();
    const S* Gw = G_in + wk * size_t(h) * h;
    const float inv_h = 1.0f / float(h);
    for (int idx = tid; idx < h * h; idx += nt) {
        const int r = int((float(idx) + 0.5f) * inv_h);
        G[r * hs + idx - r * h] = Gw[idx];
    }
    if (tid < 16) flags[tid] = 0;
    cp_async_wait_all();
    probe.lap(kLoadStore);
    __syncthreads();
    probe.lap(kBarrier);
    const SiteLanes<Q> L;
    T n_acc = T(0);
    // pending: the last accepted site's update runs in this round, on
    // warps nc ... nw - 1, while warps 0 ... nc - 1 decide the sites after
    // it from their G_II read before the update and corrected
    bool pending = false;
    SiteOps<S, Q> op;                        // this warp's next site, read before the update

    for (int i0 = 0, round = 0; i0 < N; ++round) {
        // warp w decides site i0 + w as if the round's sites before it
        // are rejected
        const int nd = pending ? nc : nw, k = i0 + warp;
        bool accept = false;
        if (warp < nd && k < N) {            // warp-uniform
            SiteOps<S, Q> o;
            if (pending) {
                o = op;
                correct_site<S, Q>(o, cc, rows, N, k, L);
            } else {
                gather_site<S, Q>(G, dl, N, hs, k, L, o);
            }
            probe.lap(kGather);
            const T live = live_k4(phi, phin + k * opdim, phi + k * opdim, nb + 4 * k, opdim,
                                   dtau);
            probe.lap(kLive);
            accept = site_step_k4<S, Q>(o, lhs[k], live, c_det, L, Ts + warp * QQ,
                                        [&](int p) { probe.lap(kA + p); });
        } else if (pending && warp >= nc) {
            update_rows<S, Q, KC>(G, rows, cc, h, hs, lane, warp - nc, nw - nc);
            probe.lap(kUpdate);
        }
        unsigned char* fl = flags + 8 * (round & 1);   // two rounds' buffers
        if (lane == 0) fl[warp] = accept;
        __syncthreads();
        // the round's first accepted site (nw if none)
        const unsigned long long m = *reinterpret_cast<const unsigned long long*>(fl);
        const int j = m ? (__ffsll(static_cast<long long>(m)) - 1) >> 3 : nw;
        probe.lap(kBarrier);
        pending = false;
        if (j == nw) {                       // uniform: every site rejected
            i0 += nd;
            continue;
        }
        const int i = i0 + j;
        n_acc = add_rn(n_acc, T(1));
        S Tm[QQ];
#pragma unroll
        for (int f = 0; f < QQ; ++f) Tm[f] = Ts[j * QQ + f];
        // the site's rows e_{j_b} - G[j_b, :] (rows[c][b]), and the next
        // sites' operands before the update
        for (int idx = tid; idx < Q * h; idx += nt) {
            const int c = idx / Q, jb = (idx % Q) * N + i;
            rows[idx] = rsub_rn(c == jb ? T(1) : T(0), G[jb * hs + c]);
        }
        if (warp < nc && i + 1 + warp < N) gather_site<S, Q>(G, dl, N, hs, i + 1 + warp, L, op);
        probe.lap(kStage);
        // the combined columns sum_a G[r, j_a] T[a, b] of rows tid + nt t
        for (int r = tid; r < h; r += nt) {
            const S* Gr = G + r * hs + i;
            S gc[Q];
#pragma unroll
            for (int a = 0; a < Q; ++a) gc[a] = Gr[a * N];
#pragma unroll
            for (int b = 0; b < Q; ++b) {
                S cb = cmul_rn(gc[0], Tm[b]);
#pragma unroll
                for (int a = 1; a < Q; ++a) cb = cadd_rn(cb, cmul_rn(gc[a], Tm[Q * a + b]));
                cc[Q * r + b] = cb;
            }
        }
        // every warp has read site i's old field (before the barrier above)
        if (tid == 0)
            for (int o = 0; o < opdim; ++o) phi[i * opdim + o] = phin[i * opdim + o];
        probe.lap(kComb);
        __syncthreads();                     // the staged rows, the combined columns, the field
        probe.lap(kBarrier);
        pending = true;
        i0 = i + 1;
    }
    if (pending) {                           // the last accepted site's update
        update_rows<S, Q, KC>(G, rows, cc, h, hs, lane, warp, nw);
        probe.lap(kUpdate);
    }

    __syncthreads();                         // every warp's last update
    S* Go = G_out + wk * size_t(h) * h;
    for (int idx = tid; idx < h * h; idx += nt) {
        const int r = int((float(idx) + 0.5f) * inv_h);
        Go[idx] = G[r * hs + idx - r * h];
    }
    for (int idx = tid; idx < NO; idx += nt) phi_out[wk * NO + idx] = phi[idx];
    if (tid == 0) acc_out[wk] = n_acc;
    probe.lap(kLoadStore);
    probe.store(probe_out);
}

// the look-ahead body's instance for h = Q N (KC = ceil(h / 32))
template <typename S, int Q, bool PROBE>
auto ahead_kernel(int h) {
    using Fn = decltype(&sdw_update_ahead_kernel<S, Q, 1, PROBE>);
    constexpr Fn fns[5] = {sdw_update_ahead_kernel<S, Q, 1, PROBE>,
                           sdw_update_ahead_kernel<S, Q, 2, PROBE>,
                           sdw_update_ahead_kernel<S, Q, 3, PROBE>,
                           sdw_update_ahead_kernel<S, Q, 4, PROBE>,
                           sdw_update_ahead_kernel<S, Q, 5, PROBE>};
    return fns[(h + 31) / 32 - 1];
}

template <typename S, int Q, bool PROBE = false>
int sdw_update_ahead(int device, const void* G, const void* phi, const void* phin,
                     const void* lhs, const void* delta, const void* nb, void* G_out,
                     void* phi_out, void* acc_out, int W, int N, int opdim, double dtau,
                     double c_det, void* stream, long long* probe = nullptr) {
    using T = typename real_of<S>::type;
    // live_k4 unrolls opdim <= 3
    if (Q * N > kMaxH || opdim > 3) return static_cast<int>(cudaErrorInvalidValue);
    return launch_smem(device, ahead_kernel<S, Q, PROBE>(Q * N), W,
                       ahead_smem(N, opdim, Q, sizeof(S), sizeof(T)), stream,
                       static_cast<const S*>(G), static_cast<const T*>(phi),
                       static_cast<const T*>(phin), static_cast<const T*>(lhs),
                       static_cast<const S*>(delta), static_cast<const int*>(nb),
                       static_cast<S*>(G_out), static_cast<T*>(phi_out),
                       static_cast<T*>(acc_out), N, opdim, static_cast<T>(dtau),
                       static_cast<T>(c_det), probe);
}

template <typename S, int Q>
int ahead_blocks(int device, int N, int opdim) {
    using T = typename real_of<S>::type;
    return blocks_per_sm(device, ahead_kernel<S, Q, false>(Q * N),
                         ahead_smem(N, opdim, Q, sizeof(S), sizeof(T)));
}

// CTAs per SM (no launch) of the instance for G of dtype (0 float32, 1
// float64, 2 complex64, 3 complex128) at q = 4 or 2, in the body it runs
inline int update_blocks_of(int device, int dtype, int q, int N, int opdim) {
    if (q == 4) {
        switch (dtype) {
            case 0: return ahead_blocks<float, 4>(device, N, opdim);
            case 1: return ahead_blocks<double, 4>(device, N, opdim);
            case 2: return update_blocks<cplx<float>, 4>(device, N, opdim);
            case 3: return update_blocks<cplx<double>, 4>(device, N, opdim);
        }
    } else if (q == 2) {
        switch (dtype) {
            case 0: return ahead_blocks<float, 2>(device, N, opdim);
            case 1: return ahead_blocks<double, 2>(device, N, opdim);
            case 2: return ahead_blocks<cplx<float>, 2>(device, N, opdim);
            case 3: return ahead_blocks<cplx<double>, 2>(device, N, opdim);
        }
    }
    return -static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace dq

// the C entries: G and delta of the instance's scalar (complex64 / 128 or
// float32 / 64), the real tensors in its real type; BODY is the first body
// (sdw_update) or the look-ahead body (sdw_update_ahead)
#define DQ_SDW_UPDATE_ENTRY(NAME, BODY, S, Q)                                        \
    extern "C" int NAME(int device, const void* G, const void* phi, const void* phin, \
                        const void* lhs, const void* delta, const void* nb,          \
                        void* G_out, void* phi_out, void* acc_out, int W, int N,     \
                        int opdim, double dtau, double c_det, void* stream) {        \
        return dq::BODY<S, Q>(device, G, phi, phin, lhs, delta, nb, G_out, phi_out,  \
                              acc_out, W, N, opdim, dtau, c_det, stream);            \
    }
// the same with the phase probe on: probe (W x (kPhases + 2) int64) gets
// each CTA's cycles per phase (PROBE_PHASES), its total cycles and ns
#define DQ_SDW_UPDATE_PROBE_ENTRY(NAME, BODY, S, Q)                                  \
    extern "C" int NAME(int device, const void* G, const void* phi, const void* phin, \
                        const void* lhs, const void* delta, const void* nb,          \
                        void* G_out, void* phi_out, void* acc_out, int W, int N,     \
                        int opdim, double dtau, double c_det, void* probe,           \
                        void* stream) {                                              \
        return dq::BODY<S, Q, true>(device, G, phi, phin, lhs, delta, nb, G_out,     \
                                    phi_out, acc_out, W, N, opdim, dtau, c_det,      \
                                    stream, static_cast<long long*>(probe));         \
    }

DQ_SDW_UPDATE_ENTRY(dq_sdw_update_c64, sdw_update, dq::cplx<float>, 4)
DQ_SDW_UPDATE_ENTRY(dq_sdw_update_c128, sdw_update, dq::cplx<double>, 4)
DQ_SDW_UPDATE_ENTRY(dq_sdw_update_f32, sdw_update_ahead, float, 4)
DQ_SDW_UPDATE_ENTRY(dq_sdw_update_f64, sdw_update_ahead, double, 4)
DQ_SDW_UPDATE_ENTRY(dq_sdw_update_q2_c64, sdw_update_ahead, dq::cplx<float>, 2)
DQ_SDW_UPDATE_ENTRY(dq_sdw_update_q2_c128, sdw_update_ahead, dq::cplx<double>, 2)
DQ_SDW_UPDATE_ENTRY(dq_sdw_update_q2_f32, sdw_update_ahead, float, 2)
DQ_SDW_UPDATE_ENTRY(dq_sdw_update_q2_f64, sdw_update_ahead, double, 2)

DQ_SDW_UPDATE_PROBE_ENTRY(dq_sdw_update_probe_c64, sdw_update, dq::cplx<float>, 4)
DQ_SDW_UPDATE_PROBE_ENTRY(dq_sdw_update_probe_f32, sdw_update_ahead, float, 4)
DQ_SDW_UPDATE_PROBE_ENTRY(dq_sdw_update_probe_q2_c64, sdw_update_ahead, dq::cplx<float>, 2)
DQ_SDW_UPDATE_PROBE_ENTRY(dq_sdw_update_probe_q2_f32, sdw_update_ahead, float, 2)

extern "C" {

// CTAs per SM (no launch) of the instance at q = 4 or 2 (dtype as
// dq::update_blocks_of)
int dq_sdw_update_blocks_per_sm(int device, int dtype, int q, int N, int opdim) {
    return dq::update_blocks_of(device, dtype, q, N, opdim);
}

}  // extern "C"
