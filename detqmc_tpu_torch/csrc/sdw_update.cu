// K4: SDW slice update (O(3), full 4x4 complex site blocks), one CTA per
// walker.
//
// Replaces the TPU kernel detqmc_tpu/linalg/pallas_sdw_update.py
// (slice_update_sdw, kernel body _kernel), which keeps 128 walkers in the
// vector lanes and G as (re, im) f32 planes in VMEM. Here one CTA holds
// one walker's complex G (h x h, h = 4N) in shared memory and walks the N
// sites in order. Per site i (orbital-major indices j_b = b N + i,
// pallas_sdw_update.py:197-331):
//     live  = dtau * (phi_new_i - phi_old_i) . sum_d phi[nb_d]   (live phi)
//     M     = 1 - G[j_a, j_b];   A = 1 + Delta_i M     (4 x 4 complex)
//     R, adj(A)  closed form from the 12 2x2 minors (sdw_site.cuh)
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
// What bounds it: the N dependent chains (~40 shuffles and ~60 dependent
// rounded operations a site) and, per accepted site, the rank-4 update's
// h^2 x 32 explicitly rounded FP32 (FP64) operations, the plain version's
// rounding. A launch lasts as long as its slowest walker: at sdw_l4's
// acceptance (~0.25) the one of 128 that accepts the most sites.
// Every product and sum is explicitly rounded (cmul_rn ...) in the plain
// PyTorch version's order (linalg/sdw_update.py), so for equal inputs the
// kernel reproduces it bit for bit up to log(), and the accept decisions
// agree.
#include "sdw_site.cuh"
#include "tc_blocked.cuh"   // load4

namespace dq {

// the phase probe's phases (Probe, common.cuh), mirrored by
// linalg/sdw_update.py PROBE_PHASES: the site's scalar chain (live term,
// decision, T), the barriers, the staging of the site's rows,
// the combined columns, the rank-4 update, the loads and stores
enum { kChain, kBarrier, kStage, kComb, kUpdate, kLoadStore, kPhases };

// the largest h the kernel takes (linalg/sdw_update.py MAX_H): the
// combined columns a lane forms are sized for it
constexpr int kMaxH = 160;

// shared memory of one CTA (linalg/sdw_update.py smem_bytes): G (h x h),
// the staged rows and the combined columns (4 h complex values each), then
// phi_new, lhs and every warp's copy of the live field (reals), and the
// neighbour table
inline size_t update_smem(int N, int opdim, size_t cbytes) {
    const size_t h = 4 * size_t(N), rbytes = cbytes / 2;
    return cbytes * (h * h + 8 * h) + rbytes * (size_t(N) * opdim * (1 + kWarps) + N)
           + sizeof(int) * 4 * size_t(N);
}

template <typename T, bool PROBE>
__global__ void __launch_bounds__(kThreads, 1)
sdw_update_kernel(const cplx<T>* __restrict__ G_in, const T* __restrict__ phi_in,
                  const T* __restrict__ phin_in, const T* __restrict__ lhs_in,
                  const cplx<T>* __restrict__ delta_in, const int* __restrict__ nb_in,
                  cplx<T>* __restrict__ G_out, T* __restrict__ phi_out,
                  T* __restrict__ acc_out, int N, int opdim, T dtau, T c_det,
                  long long* probe_out) {
    using S = cplx<T>;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int h = 4 * N, NO = N * opdim;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const size_t wk = blockIdx.x;
    S* G = reinterpret_cast<S*>(smem_raw);              // h x h
    S* rows = G + h * h;                                // h x 4: e_{j_b} - G[j_b, c]
    S* cc = rows + 4 * h;                               // h x 4: the combined columns
    T* phin = reinterpret_cast<T*>(cc + 4 * h);         // N x opdim
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
    // lanes e and e + 16 take G_II's entry e = 4 a + b and its row a and
    // column b of Delta_i
    const SiteLanes L;
    const S* dw = delta_in + wk * 16 * size_t(N);
    SiteDelta<T> dnext = site_delta(dw, L);
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
        const SiteDelta<T> d = dnext;
        const S g = gnext;
        if (i + 1 < N) {
            dnext = site_delta(dw + 16 * (i + 1), L);
            gnext = gii(i + 1);
        }
        // every warp decides, on identical inputs (site i's own field is
        // still the slice's: phi_i = phi_in_i)
        const T live = site_live(phi, phin + i * opdim, phi + i * opdim, nb + 4 * i,
                                 opdim, dtau);
        S Te;                                // entry e of T (on accept)
        const bool accept = site_step_warp(g, d, lhs[i], live, c_det, L, Te);
        probe.lap(kChain);
        if (!accept) continue;               // uniform: no barrier
        n_acc = add_rn(n_acc, T(1));
        if (lane == 0)
            for (int o = 0; o < opdim; ++o) phi[i * opdim + o] = phin[i * opdim + o];
        // the site's rows e_{j_b} - G[j_b, :] (rows[c][b]), staged by every
        // thread (nothing writes G before barrier 1)
        for (int idx = tid; idx < 4 * h; idx += kThreads) {
            const int c = idx >> 2, j = (idx & 3) * N + i;
            const S v = G[j * h + c];
            rows[idx] = mk(sub_rn(c == j ? T(1) : T(0), v.re), -v.im);
        }
        probe.lap(kStage);
        // the combined columns of this warp's rows, read from G's columns
        // j_a: lane l forms entry (row warp + 8 (l / 4 + 8 t), column l % 4)
        const int bl = lane & 3;
        S tcol[4];                           // column bl of T
#pragma unroll
        for (int a = 0; a < 4; ++a) tcol[a] = shfl_c(Te, 4 * a + bl);
        constexpr int TQ = (4 * kMaxH / kWarps + 31) / 32;
#pragma unroll
        for (int t = 0; t < TQ; ++t) {
            const int r = warp + kWarps * ((lane >> 2) + 8 * t);
            if (64 * t >= h) break;          // uniform: no row of this t
            const S* Gr = G + min(r, h - 1) * h + i;
            S cb = cmul_rn(Gr[0], tcol[0]);
#pragma unroll
            for (int a = 1; a < 4; ++a) cb = cadd_rn(cb, cmul_rn(Gr[a * N], tcol[a]));
            if (r < h) cc[4 * r + bl] = cb;
        }
        probe.lap(kComb);
        __syncthreads();                     // the staged rows, this warp's comb
        probe.lap(kBarrier);
        // the rank-4 update of this thread's entries
        for (int c = lane; c < h; c += 32) {
            S rw[4];
            load4(rows + 4 * c, rw);
#pragma unroll 8
            for (int r = warp; r < h; r += kWarps) {
                S cm[4];
                load4(cc + 4 * r, cm);
                S u = cmul_rn(cm[0], rw[0]);
#pragma unroll
                for (int b = 1; b < 4; ++b) u = cadd_rn(u, cmul_rn(cm[b], rw[b]));
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

template <typename T, bool PROBE = false>
int sdw_update(int device, const void* G, const void* phi, const void* phin,
               const void* lhs, const void* delta, const void* nb, void* G_out,
               void* phi_out, void* acc_out, int W, int N, int opdim,
               double dtau, double c_det, void* stream, long long* probe = nullptr) {
    if (4 * N > kMaxH) return static_cast<int>(cudaErrorInvalidValue);
    return launch_smem(device, sdw_update_kernel<T, PROBE>, W,
                       update_smem(N, opdim, sizeof(cplx<T>)), stream,
                       static_cast<const cplx<T>*>(G), static_cast<const T*>(phi),
                       static_cast<const T*>(phin), static_cast<const T*>(lhs),
                       static_cast<const cplx<T>*>(delta), static_cast<const int*>(nb),
                       static_cast<cplx<T>*>(G_out), static_cast<T*>(phi_out),
                       static_cast<T*>(acc_out), N, opdim, static_cast<T>(dtau),
                       static_cast<T>(c_det), probe);
}

}  // namespace dq

extern "C" {

int dq_sdw_update_c64(int device, const void* G, const void* phi,
                      const void* phin, const void* lhs, const void* delta,
                      const void* nb, void* G_out, void* phi_out, void* acc_out,
                      int W, int N, int opdim, double dtau, double c_det,
                      void* stream) {
    return dq::sdw_update<float>(device, G, phi, phin, lhs, delta, nb, G_out,
                                 phi_out, acc_out, W, N, opdim, dtau, c_det, stream);
}

int dq_sdw_update_c128(int device, const void* G, const void* phi,
                       const void* phin, const void* lhs, const void* delta,
                       const void* nb, void* G_out, void* phi_out,
                       void* acc_out, int W, int N, int opdim, double dtau,
                       double c_det, void* stream) {
    return dq::sdw_update<double>(device, G, phi, phin, lhs, delta, nb, G_out,
                                  phi_out, acc_out, W, N, opdim, dtau, c_det, stream);
}

// the complex64 update with the phase probe on: probe (W x 8 int64) gets
// each CTA's cycles per phase (PROBE_PHASES), its total cycles and ns
int dq_sdw_update_probe_c64(int device, const void* G, const void* phi,
                            const void* phin, const void* lhs, const void* delta,
                            const void* nb, void* G_out, void* phi_out, void* acc_out,
                            int W, int N, int opdim, double dtau, double c_det,
                            void* probe, void* stream) {
    return dq::sdw_update<float, true>(device, G, phi, phin, lhs, delta, nb, G_out,
                                       phi_out, acc_out, W, N, opdim, dtau, c_det,
                                       stream, static_cast<long long*>(probe));
}

// CTAs per SM (no launch)
int dq_sdw_update_blocks_per_sm(int device, int complex128, int N, int opdim) {
    const size_t c = complex128 ? sizeof(dq::cplx<double>) : sizeof(dq::cplx<float>);
    return complex128 ? dq::blocks_per_sm(device, dq::sdw_update_kernel<double, false>,
                                          dq::update_smem(N, opdim, c))
                      : dq::blocks_per_sm(device, dq::sdw_update_kernel<float, false>,
                                          dq::update_smem(N, opdim, c));
}

}  // extern "C"
