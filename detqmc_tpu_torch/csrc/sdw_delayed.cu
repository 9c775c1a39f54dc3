// K5: the delayed SDW slice update, one launch per slice, one CTA per
// walker, the flushes G -= C R in the kernel's own body. Instances: q = 4
// complex (the full opdim-3 model), q = 4 real (the full opdim-1 chain),
// q = 2 complex (the opdim-2 reduced sector) and q = 2 real (opdim 1), in
// single and double precision; the notes below are written for complex
// q = 4. The real q = 4 instances are the same program with real scalars
// (4 x 4 flush tiles), the q = 2 instances the same program with q
// orbitals a site (2 x 2 flush tiles, h = 2 N need not be a multiple of
// 4), and both run a second body where it fits (the last note).
//
// Replaces the TPU kernel detqmc_tpu/linalg/pallas_sdw_delayed.py
// (slice_update_sdw_delayed, kernel body _kernel) in its default
// flush-each scheme (pallas_sdw_delayed.py:292-306): the slice's N sites
// go in chunks of K (the last one ragged); each chunk's sites emit
// rank-(4 K) factors C (h x 4K) and R (4K x h), and G is flushed with
// them before the next chunk reads it. Slots are site-major: slot
// k = j q + b is orbital b of the chunk's j-th site i = i0 + j, dim index
// j_b = b N + i (q = 4). Per site (pallas_sdw_delayed.py:91-216):
//     col_b = G[:, j_b] - sum_{k < j q} C[:, k] R[k, j_b]   (k ascending)
//     row_b = G[j_b, :] - sum_{k < j q} C[j_b, k] R[k, :]
//     accept, T = the scalar chain of K4 (sdw_site.cuh) on G_II = col_b[j_a]
//     C[:, j q + b] = accept ? sum_a col_a T_ab : 0;  R[j q + b, :] = e_{j_b} - row_b
//     phi_i = accept ? phi_new_i : phi_i
// and after the chunk G -= C R, slot by slot in ascending k. A rejected
// site's slots hold C = 0, which adds exact zeros to every sum: only
// accepted sites take slots here, and the plain version
// (linalg/sdw_delayed.py), which keeps every slot, gets the same values.
//
// Each entry of G, and each column and row entry a site reads, is its
// input minus the slots' products in slot order, rounded one product and
// one difference at a time, whichever chunk flushed them: the plain
// version's per-chunk flush and a later flush of the same slots give the
// same bits (for every K). So this kernel keeps the slots of K accepted
// sites (4 K slots, the memory the chunk's slots take) and flushes when
// they are full and at the end of the slice: the result is the per-chunk
// flush's, with fewer passes over G (sdw_l8's acceptance is ~0.2).
//
// G is the working copy in global memory: the output buffer G_out, whose
// first flush reads G_in (with no accepted site the final flush copies).
// The C and R slots (4 K x h each; C stored transposed, slot-major) stay
// in shared memory where they fit (2 x 32 x 256 x 8 B = 128 KB at
// h = 256, K = 8 in complex64). Where only one buffer fits (complex128 at
// h = 256, complex64 at h = 512, K = 8) R stays there and C goes to a
// global scratch (L2): the flush reads a slot's R entries at a different
// column on every thread of a warp but its C entries at one band's rows,
// a broadcast. Where neither fits, both go to the scratch
// (linalg/sdw_delayed.py plan). The flush loads scratch entries a few
// slots ahead (flush). Both measured (PERF.md): complex128 at
// h = 256 2.1 -> 1.8 ms a slice; complex64 at h = 512 19.3 -> 15.3 ms,
// still twice the parent's per-chunk kernels with their library flushes.
//
// What bounds it (NVIDIA H100 80GB HBM3, 700 W; the probes in PERF.md):
// the flush's products, 8 explicitly rounded FP32 operations per complex
// multiply-add, h^2 per accepted slot (half the FMA peak's rate at best),
// then the site walk's dependent chain. The parent design spent 57 % of
// its per-chunk kernel in slot corrections and 34 % in one thread's
// scalar chain, and left the flush to a library product. This design:
//   - one launch per slice: no panel copies, no library flush, no
//     per-chunk launches; the delta blocks, the fields and the proposal's
//     lhs are staged in shared memory once;
//   - the flush is register-tiled (TR x 4 complex entries a thread, 16-byte
//     loads, the next tile's G loads in flight during the products),
//     FP32 SIMT products in complex64 (no TF32), FP64 in complex128, every
//     product and sum explicitly rounded in the plain version's order;
//   - no broadcast of the accept: lanes 0-15 of every warp form the
//     16 corrected G_II entries and every warp runs the scalar chain on
//     them, one 4x4 entry a lane (sdw_site.cuh site_step_warp), so all
//     warps decide alike and none waits on another; a rejected site takes
//     no barrier, an accepted one writes its slots and takes one. Each
//     warp keeps its own copy of the live field (the next sites' live
//     term reads it), so a fast warp's update never meets a slow warp's
//     read;
//   - a site's G_II entries are loaded while the site before is decided;
//     its columns and rows (strided reads of 4 h entries) only once it is
//     accepted (prefetching them for every site cost more than their
//     latency on the accepted ones: PERF.md); no runtime integer division
//     per element.
//
// The q = 2 and the real q = 4 instances run a second body where it fits
// (sdw_delayed_smem_kernel; linalg/sdw_delayed.py plan: N % 4 == 0 and
// both slot buffers beside four rows of G at least). Its probe split
// (PERF.md, PR 18) put the flush first and the walk's global reads after
// it, so:
//   - G's first R rows live in shared memory (all of G where it fits: q = 2
//     at h = 128 in float32 and complex64; the first 144 of 256 rows at
//     real q = 4, h = 256, float32), rows 16-byte aligned at stride
//     h + 16 / sizeof(S), copied in by cp.async, read there by the walk,
//     flushed in place and stored by the last flush; the other rows stay
//     in global memory as in the first body;
//   - the flush: 8 x 4 tiles of floats (4 x 4 of doubles and complex64,
//     2 x 4 of complex128) at every q, every access a vector one, four
//     slots' operands loaded before their products, the next tile's loads
//     issued before the current one's;
//   - the slots' rows put each orbital's block 16 bytes of banks after the
//     one before, so that a site's q entries b N + i, which every walk
//     warp's gather and every accepted site's line corrections read, fall
//     in q different banks (at N = 64 they shared one);
//   - the walk runs on 4 warps up to h = 128 (one a scheduler), which
//     request each flush from the other 4 through a command word.
#include "sdw_site.cuh"

namespace dq {

// the phase probe's phases (Probe, common.cuh), mirrored by
// linalg/sdw_delayed.py PROBE_PHASES: the corrected G_II entries, the
// live term and the scalar chain, the slot writes of an accepted site,
// the barriers, the flush, the staging of the slice's operands
enum { kGather, kDecide, kSlot, kBarrier, kFlush, kSetup, kPhases };

// M consecutive values at src (aligned to 16 bytes, or for M = 2 floats
// to 8) into v, and back, by vector accesses
template <int M>
__device__ __forceinline__ void load_c(cplx<float> (&v)[M], const cplx<float>* src) {
    static_assert(M % 2 == 0, "complex64 loads go in pairs");
#pragma unroll
    for (int q = 0; q < M; q += 2) {
        const float4 x = *reinterpret_cast<const float4*>(src + q);
        v[q] = mk(x.x, x.y);
        v[q + 1] = mk(x.z, x.w);
    }
}
template <int M>
__device__ __forceinline__ void load_c(cplx<double> (&v)[M], const cplx<double>* src) {
#pragma unroll
    for (int q = 0; q < M; ++q) {
        const double2 x = *reinterpret_cast<const double2*>(src + q);
        v[q] = mk(x.x, x.y);
    }
}
template <int M>
__device__ __forceinline__ void load_c(float (&v)[M], const float* src) {
    if constexpr (M % 4 == 0) {
#pragma unroll
        for (int q = 0; q < M; q += 4) {
            const float4 x = *reinterpret_cast<const float4*>(src + q);
            v[q] = x.x;
            v[q + 1] = x.y;
            v[q + 2] = x.z;
            v[q + 3] = x.w;
        }
    } else {
#pragma unroll
        for (int q = 0; q < M; q += 2) {
            const float2 x = *reinterpret_cast<const float2*>(src + q);
            v[q] = x.x;
            v[q + 1] = x.y;
        }
    }
}
template <int M>
__device__ __forceinline__ void load_c(double (&v)[M], const double* src) {
#pragma unroll
    for (int q = 0; q < M; q += 2) {
        const double2 x = *reinterpret_cast<const double2*>(src + q);
        v[q] = x.x;
        v[q + 1] = x.y;
    }
}
template <int M>
__device__ __forceinline__ void store_c(float* dst, const float (&v)[M]) {
    if constexpr (M % 4 == 0) {
#pragma unroll
        for (int q = 0; q < M; q += 4)
            *reinterpret_cast<float4*>(dst + q) = make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
    } else {
#pragma unroll
        for (int q = 0; q < M; q += 2)
            *reinterpret_cast<float2*>(dst + q) = make_float2(v[q], v[q + 1]);
    }
}
template <int M>
__device__ __forceinline__ void store_c(double* dst, const double (&v)[M]) {
#pragma unroll
    for (int q = 0; q < M; q += 2)
        *reinterpret_cast<double2*>(dst + q) = make_double2(v[q], v[q + 1]);
}

template <int M>
__device__ __forceinline__ void store_c(cplx<float>* dst, const cplx<float> (&v)[M]) {
#pragma unroll
    for (int q = 0; q < M; q += 2)
        *reinterpret_cast<float4*>(dst + q) = make_float4(v[q].re, v[q].im, v[q + 1].re,
                                                          v[q + 1].im);
}
template <int M>
__device__ __forceinline__ void store_c(cplx<double>* dst, const cplx<double> (&v)[M]) {
#pragma unroll
    for (int q = 0; q < M; ++q)
        *reinterpret_cast<double2*>(dst + q) = make_double2(v[q].re, v[q].im);
}

// Gd = Gs - sum_{s < ns} C[:, s] R[s, :] (C stored slot-major: Cs[s h + r]),
// slot by slot in ascending s, each entry rounded as the plain version
// rounds it. Thread t takes the tiles t, t + kThreads, ... of TR x TC
// entries, the tiles of a row band on neighbouring threads (coalesced G
// rows, one C read for the band); the next tile's G loads are issued
// before the current tile's products. Where the slots live in the global
// scratch (RES < 2: C; RES == 0: R too) their entries are loaded kRing
// slots ahead of their products: from L2 a load waits longer than one
// slot's products take (PERF.md); from shared memory the ring cost
// more than it hid. ns = 0 copies. h % TR == 0 and h % TC == 0.
constexpr int kRing = 4;
template <typename S, int TR, int TC, int RES>
__device__ __forceinline__ void flush(const S* Gs, S* Gd, const S* Cs, const S* Rs, int h,
                                      int ns) {
    constexpr bool RING_C = RES < 2, RING_R = RES == 0;
    constexpr int D = RING_C ? kRing : 1;   // slots a pass of the inner loop
    const int tcn = h / TC, tiles = (h / TR) * tcn;
    // tile t = band tcn + col; t += kThreads steps (band, col) by (db, dc)
    const int db = kThreads / tcn, dc = kThreads - db * tcn;
    int band = threadIdx.x / tcn, col = threadIdx.x - (threadIdx.x / tcn) * tcn;
    S cur[TR][TC] = {}, nxt[TR][TC] = {};
    auto load_tile = [&](int bd, int cl, S (&v)[TR][TC]) {
        const S* src = Gs + size_t(bd) * TR * h + cl * TC;
#pragma unroll
        for (int p = 0; p < TR; ++p) load_c(v[p], src + size_t(p) * h);
    };
    int t = threadIdx.x;
    if (t < tiles) load_tile(band, col, cur);
    for (; t < tiles; t += kThreads) {
        int nband = band + db, ncol = col + dc;
        if (ncol >= tcn) {
            ncol -= tcn;
            ++nband;
        }
        if (t + kThreads < tiles) load_tile(nband, ncol, nxt);
        const int r0 = band * TR, c0 = col * TC;
        S cq[D][TR], rq[RING_R ? kRing : 1][TC];
        if constexpr (RING_C) {
#pragma unroll
            for (int d = 0; d < kRing; ++d)
                if (d < ns) {
                    load_c(cq[d], Cs + size_t(d) * h + r0);
                    if constexpr (RING_R) load_c(rq[d], Rs + size_t(d) * h + c0);
                }
        }
        for (int s0 = 0; s0 < ns; s0 += D) {
#pragma unroll
            for (int d = 0; d < D; ++d) {
                const int s = s0 + d;
                if (s >= ns) break;
                S c[TR], r[TC];
                if constexpr (RING_C) {
#pragma unroll
                    for (int p = 0; p < TR; ++p) c[p] = cq[d][p];
                    if (s + kRing < ns) load_c(cq[d], Cs + size_t(s + kRing) * h + r0);
                } else {
                    load_c(c, Cs + size_t(s) * h + r0);
                }
                if constexpr (RING_R) {
#pragma unroll
                    for (int q = 0; q < TC; ++q) r[q] = rq[d][q];
                    if (s + kRing < ns) load_c(rq[d], Rs + size_t(s + kRing) * h + c0);
                } else {
                    load_c(r, Rs + size_t(s) * h + c0);
                }
#pragma unroll
                for (int p = 0; p < TR; ++p)
#pragma unroll
                    for (int q = 0; q < TC; ++q)
                        cur[p][q] = csub_rn(cur[p][q], cmul_rn(c[p], r[q]));
            }
        }
        S* dst = Gd + size_t(r0) * h + c0;
#pragma unroll
        for (int p = 0; p < TR; ++p) store_c(dst + size_t(p) * h, cur[p]);
#pragma unroll
        for (int p = 0; p < TR; ++p)
#pragma unroll
            for (int q = 0; q < TC; ++q) cur[p][q] = nxt[p][q];
        band = nband;
        col = ncol;
    }
}

// shared memory of one CTA (linalg/sdw_delayed.py smem_bytes): the slot
// buffers it holds (RES of C and R: 2 both, 1 R; each q K x h, h = q N),
// the slice's delta blocks (q^2 N), then phi_new and lhs, every warp's copy
// of the live field, and the neighbour table
inline size_t delayed_smem(int N, int opdim, int K, int q, size_t sbytes, size_t rbytes,
                           int res) {
    const size_t h = size_t(q) * N;
    return res * size_t(q) * K * h * sbytes + size_t(q) * q * N * sbytes +
           rbytes * (size_t(N) * opdim * (1 + kWarps) + N) + sizeof(int) * 4 * size_t(N);
}

// EPT: entries of a site's columns and rows per thread (h <= EPT kThreads);
// TR x TC: the flush tile; RES: the slot buffers in shared memory (2: C and
// R; 1: R, C in the global scratch `slots`, q K x h per walker; 0: neither,
// both in the scratch, 2 x q K x h per walker)
template <typename S, int Q, int EPT, int TR, int TC, int RES, bool PROBE>
__global__ void __launch_bounds__(kThreads, 1)
sdw_delayed_kernel(const S* __restrict__ G_in, S* G_out,
                   const typename real_of<S>::type* __restrict__ phi_in,
                   const typename real_of<S>::type* __restrict__ phin_in,
                   const typename real_of<S>::type* __restrict__ lhs_in,
                   const S* __restrict__ delta_in, const int* __restrict__ nb_in,
                   typename real_of<S>::type* __restrict__ phi_out,
                   typename real_of<S>::type* __restrict__ acc_out, S* slots, int N,
                   int opdim, int K, typename real_of<S>::type dtau,
                   typename real_of<S>::type c_det, long long* probe_out) {
    using T = typename real_of<S>::type;
    constexpr int QQ = Q * Q;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int h = Q * N, Kq = Q * K, NO = N * opdim;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const size_t wk = blockIdx.x;
    S* Cs;                                   // Kq x h: Cs[s h + r] = C[r][s]
    S* Rs;                                   // Kq x h: Rs[s h + c] = R[s][c]
    S* dl;                                   // q^2 N: the delta blocks
    S* sm = reinterpret_cast<S*>(smem_raw);
    if constexpr (RES == 2) {
        Cs = sm;
        Rs = Cs + size_t(Kq) * h;
        dl = Rs + size_t(Kq) * h;
    } else if constexpr (RES == 1) {
        Rs = sm;
        dl = Rs + size_t(Kq) * h;
        Cs = slots + wk * size_t(Kq) * h;
    } else {
        Cs = slots + wk * 2 * size_t(Kq) * h;
        Rs = Cs + size_t(Kq) * h;
        dl = sm;
    }
    T* phin = reinterpret_cast<T*>(dl + QQ * N);   // N x opdim
    T* lhs = phin + NO;                            // N
    T* phiw = lhs + N;                             // kWarps x N x opdim
    int* nb = reinterpret_cast<int*>(phiw + kWarps * NO);   // N x 4
    Probe<PROBE, kPhases> probe;
    probe.start();

    for (int idx = tid; idx < QQ * N; idx += kThreads) dl[idx] = delta_in[wk * QQ * N + idx];
    for (int idx = tid; idx < NO; idx += kThreads) {
        phin[idx] = phin_in[wk * NO + idx];
        const T p = phi_in[wk * NO + idx];
        for (int w = 0; w < kWarps; ++w) phiw[w * NO + idx] = p;
    }
    for (int idx = tid; idx < N; idx += kThreads) lhs[idx] = lhs_in[wk * N + idx];
    for (int idx = tid; idx < 4 * N; idx += kThreads) nb[idx] = nb_in[idx];
    T* phi = phiw + warp * NO;               // this warp's live field

    const S* Gw = G_in + wk * size_t(h) * h;
    S* G = G_out + wk * size_t(h) * h;
    // lanes e, e + q^2, ... hold G_II's entry e = q a + b: G_cur[j_a][j_b]
    const SiteLanes<Q> L;
    T n_acc = T(0);
    probe.lap(kSetup);
    __syncthreads();
    probe.lap(kBarrier);

    // the slots hold K accepted sites; G is flushed when they are full and
    // at the end of the slice (or copied there if nothing was flushed)
    const S* Gs = Gw;                        // G_in until the first flush
    int nk = 0;                              // accepted sites in the slots
    auto flush_slots = [&]() {
        // the sites' loads of G and reads of the slots must have landed
        __syncthreads();
        probe.lap(kBarrier);
        flush<S, TR, TC, RES>(Gs, G, Cs, Rs, h, Q * nk);
        probe.lap(kFlush);
        __syncthreads();
        probe.lap(kBarrier);
        Gs = G;
        nk = 0;
    };
    // lane e's G_II entry G[j_a][j_b] of the next site is loaded while
    // the current one is decided
    auto gii_of = [&](int i) { return Gs[size_t(L.a * N + i) * h + L.b * N + i]; };
    S gnext = gii_of(0);
    for (int i = 0; i < N; ++i) {
        if (nk == K) {
            flush_slots();
            gnext = gii_of(i);
        }
        S x = gnext;
        if (i + 1 < N) gnext = gii_of(i + 1);
        const int ns = Q * nk;
        // lane e's G_II[a][b] = col_b[j_a], corrected slot by slot
        const int ja = L.a * N + i, jb = L.b * N + i;
#pragma unroll 4
        for (int s = 0; s < ns; ++s)
            x = csub_rn(x, cmul_rn(Cs[size_t(s) * h + ja], Rs[size_t(s) * h + jb]));
        probe.lap(kGather);
        // every warp decides, on identical inputs (site i's own field
        // is still the slice's: phi_i = phi_in_i)
        const T live = site_live(phi, phin + i * opdim, phi + i * opdim, nb + 4 * i,
                                 opdim, dtau);
        S Tm[QQ];
        const bool accept = site_step_warp<S, Q>(x, dl + QQ * i, lhs[i], live, c_det, L, Tm);
        probe.lap(kDecide);
        if (!accept) continue;           // uniform: no barrier
        n_acc = add_rn(n_acc, T(1));
        if (lane == 0)
            for (int o = 0; o < opdim; ++o) phi[i * opdim + o] = phin[i * opdim + o];
        __syncwarp();
        // the owned entries of the site's columns and rows, corrected by
        // the slots; the site's slots from them
#pragma unroll
        for (int m = 0; m < EPT; ++m) {
            const int r = tid + m * kThreads;
            if (r >= h) continue;
            S col[Q], row[Q];
#pragma unroll
            for (int b = 0; b < Q; ++b) {
                col[b] = Gs[size_t(r) * h + b * N + i];
                row[b] = Gs[size_t(b * N + i) * h + r];
            }
            for (int s = 0; s < ns; ++s) {
                const S* Cr = Cs + size_t(s) * h;
                const S* Rr = Rs + size_t(s) * h;
                const S cr = Cr[r], rr = Rr[r];
#pragma unroll
                for (int b = 0; b < Q; ++b) {
                    col[b] = csub_rn(col[b], cmul_rn(cr, Rr[b * N + i]));
                    row[b] = csub_rn(row[b], cmul_rn(Cr[b * N + i], rr));
                }
            }
#pragma unroll
            for (int b = 0; b < Q; ++b) {
                S c = cmul_rn(col[0], Tm[b]);
#pragma unroll
                for (int a = 1; a < Q; ++a) c = cadd_rn(c, cmul_rn(col[a], Tm[Q * a + b]));
                Cs[size_t(ns + b) * h + r] = c;
                Rs[size_t(ns + b) * h + r] = rsub_rn(r == b * N + i ? T(1) : T(0), row[b]);
            }
        }
        ++nk;
        probe.lap(kSlot);
        __syncthreads();
        probe.lap(kBarrier);
    }
    if (nk > 0 || Gs == Gw) flush_slots();

    // warp 0's field is every warp's
    for (int idx = tid; idx < NO; idx += kThreads) phi_out[wk * NO + idx] = phiw[idx];
    if (tid == 0) acc_out[wk] = n_acc;
    probe.store(probe_out);
}

// ---- the second body: the q = 2 and real q = 4 instances -----------------

// The second body's slots: C[r][s] at Cs[s hs + slot_pos(r)], R[s][c] at
// Rs[s hs + slot_pos(c)], each block of N entries (one orbital) 16 bytes
// on from the one before, hs = h + q 16 / sizeof(S): a site's q entries
// b N + i fall in q different banks (with N a multiple of 32 they would
// share one, and every walk warp's gather would wait q times on it), and
// N % 4 == 0 keeps four entries of a block 16-byte aligned
template <typename S>
__host__ __device__ constexpr int slot_pad() { return 16 / int(sizeof(S)); }
// r's slot position, with inv = ceil(2^20 / N): (r inv) >> 20 = r / N
// exactly for r < 2^20 / N (every r < h <= 512), no runtime division
__host__ __device__ constexpr unsigned slot_inv(int N) { return ((1u << 20) + N - 1) / N; }
template <typename S>
__device__ __forceinline__ int slot_pos(int r, unsigned inv) {
    return r + slot_pad<S>() * int((unsigned(r) * inv) >> 20);
}

// The second body's flush of G, whose rows r < R lie in shared memory (Gm,
// row stride ld) and the others in global memory (read from Gs, written
// to G): every entry minus sum_{s < ns} C[r][s] R[s][c], slot by slot in
// ascending s, each product and difference rounded as the plain version
// rounds them. Tiles of TR x TC entries (R % TR == 0), the tiles of a row
// band on neighbouring threads, every access a vector one; the next tile's
// loads are issued before the current tile's products, and the slots'
// operands kFlushBatch slots at a time before their products. LAST: the
// slice's last flush, which stores the rows in shared memory to G too
// (and skips the global rows where they hold G already: ns = 0 after a
// flush). ns = 0 copies.
constexpr int kFlushBatch = 4;
template <typename S, int TR, int TC, bool LAST>
__device__ __forceinline__ void flush_rows(S* Gm, int ld, int R, const S* Gs, S* G,
                                           const S* Cs, const S* Rs, int h, unsigned inv,
                                           int hs, int ns, bool skip_global) {
    const int tcn = h / TC;
    const int tiles = ((skip_global ? R : h) / TR) * tcn;
    // tile t = band tcn + col; t += kThreads steps (band, col) by (db, dc)
    const int db = kThreads / tcn, dc = kThreads - db * tcn;
    int band = threadIdx.x / tcn, col = threadIdx.x - (threadIdx.x / tcn) * tcn;
    S cur[TR][TC] = {}, nxt[TR][TC] = {};
    auto load_tile = [&](int bd, int cl, S (&v)[TR][TC]) {
        const int r0 = bd * TR;
        const S* src = r0 < R ? Gm + r0 * ld + cl * TC : Gs + size_t(r0) * h + cl * TC;
        const int lds = r0 < R ? ld : h;
#pragma unroll
        for (int p = 0; p < TR; ++p) load_c(v[p], src + size_t(p) * lds);
    };

    int t = threadIdx.x;
    if (t < tiles) load_tile(band, col, cur);
    for (; t < tiles; t += kThreads) {
        int nband = band + db, ncol = col + dc;
        if (ncol >= tcn) {
            ncol -= tcn;
            ++nband;
        }
        if (t + kThreads < tiles) load_tile(nband, ncol, nxt);
        const int r0 = band * TR, c0 = col * TC;
        // the slots' entries at rows r0 ... and columns c0 ... (slot_pos;
        // the rows in groups of four, each within one orbital's block)
        constexpr int RG = TR < 4 ? TR : 4;
        const S* cs[TR / RG];
#pragma unroll
        for (int g = 0; g < TR / RG; ++g) cs[g] = Cs + slot_pos<S>(r0 + g * RG, inv);
        const S* rs = Rs + slot_pos<S>(c0, inv);
        auto load_c_rows = [&](S (&c)[TR], int off) {
#pragma unroll
            for (int g = 0; g < TR / RG; ++g) {
                S v[RG];
                load_c(v, cs[g] + off);
#pragma unroll
                for (int k = 0; k < RG; ++k) c[g * RG + k] = v[k];
            }
        };
        int s = 0;
        for (; s + kFlushBatch <= ns; s += kFlushBatch) {
            S c[kFlushBatch][TR], r[kFlushBatch][TC];
#pragma unroll
            for (int d = 0; d < kFlushBatch; ++d) {
                load_c_rows(c[d], (s + d) * hs);
                load_c(r[d], rs);
                rs += hs;
            }
#pragma unroll
            for (int d = 0; d < kFlushBatch; ++d)
#pragma unroll
                for (int p = 0; p < TR; ++p)
#pragma unroll
                    for (int q = 0; q < TC; ++q)
                        cur[p][q] = csub_rn(cur[p][q], cmul_rn(c[d][p], r[d][q]));
        }
        for (; s < ns; ++s) {
            S c[TR], r[TC];
            load_c_rows(c, s * hs);
            load_c(r, rs);
            rs += hs;
#pragma unroll
            for (int p = 0; p < TR; ++p)
#pragma unroll
                for (int q = 0; q < TC; ++q) cur[p][q] = csub_rn(cur[p][q], cmul_rn(c[p], r[q]));
        }
        const bool shared = r0 < R && !LAST;
        S* dst = shared ? Gm + r0 * ld + c0 : G + size_t(r0) * h + c0;
        const int ldd = shared ? ld : h;
#pragma unroll
        for (int p = 0; p < TR; ++p) store_c(dst + size_t(p) * ldd, cur[p]);
#pragma unroll
        for (int p = 0; p < TR; ++p)
#pragma unroll
            for (int q = 0; q < TC; ++q) cur[p][q] = nxt[p][q];
        band = nband;
        col = ncol;
    }
}

// x - sum_{s < ns} c[s hs] r[s hs], s ascending, each product and
// difference rounded once (ns even); the operands of kBatch slots are
// loaded before their products, so the chain waits on shared memory once
// a batch
constexpr int kBatch = 8;
template <typename S>
__device__ __forceinline__ S correct(S x, const S* c, const S* r, int hs, int ns) {
    int s = 0;
    for (; s + kBatch <= ns; s += kBatch) {
        S cv[kBatch], rv[kBatch];
#pragma unroll
        for (int d = 0; d < kBatch; ++d) {
            cv[d] = *c;
            rv[d] = *r;
            c += hs;
            r += hs;
        }
#pragma unroll
        for (int d = 0; d < kBatch; ++d) x = csub_rn(x, cmul_rn(cv[d], rv[d]));
    }
    for (; s < ns; s += 2) {
        const S c0 = c[0], r0 = r[0], c1 = c[hs], r1 = r[hs];
        x = csub_rn(csub_rn(x, cmul_rn(c0, r0)), cmul_rn(c1, r1));
        c += 2 * hs;
        r += 2 * hs;
    }
    return x;
}

// An accepted site's owned entry r (slot position pr) of its q columns
// (col[b] = G_cur[r][j_b]) and q rows (row[b] = G_cur[j_b][r]) corrected
// by the ns slots in ascending order (the first body's chain; pj[b] the
// slot position of j_b), the operands of q slots loaded before their
// products (ns a multiple of q)
template <typename S, int Q>
__device__ __forceinline__ void correct_lines(S (&col)[Q], S (&row)[Q], const S* Cs,
                                              const S* Rs, int hs, const int (&pj)[Q], int pr,
                                              int ns) {
    for (int s = 0; s < ns; s += Q) {
        S cr[Q], rr[Q], rj[Q][Q], cj[Q][Q];
#pragma unroll
        for (int d = 0; d < Q; ++d) {
            cr[d] = Cs[pr];
            rr[d] = Rs[pr];
#pragma unroll
            for (int b = 0; b < Q; ++b) {
                rj[d][b] = Rs[pj[b]];
                cj[d][b] = Cs[pj[b]];
            }
            Cs += hs;
            Rs += hs;
        }
#pragma unroll
        for (int d = 0; d < Q; ++d)
#pragma unroll
            for (int b = 0; b < Q; ++b) {
                col[b] = csub_rn(col[b], cmul_rn(cr[d], rj[d][b]));
                row[b] = csub_rn(row[b], cmul_rn(cj[d][b], rr[d]));
            }
    }
}

// the shared memory a block may use (linalg/_kernels.py MAX_SMEM_BYTES)
// less the 1 KB every plan keeps free
constexpr size_t kSmemBudget = 232448 - 1024;

// The second body's site walk runs on WALK warps: 4 (one a scheduler, so
// that no other warp competes for the issue slots of the chain that every
// walk warp runs) up to h = 128, else 8 (a site's columns and rows at one
// entry a thread up to h = 256); the other warps join the flushes only
__host__ __device__ constexpr int walk_warps(int h) { return h <= 128 ? 4 : 8; }

// a barrier of the walk's WALK warps alone (barrier 1; __syncthreads is 0)
template <int WALK>
__device__ __forceinline__ void walk_sync() {
    if constexpr (WALK == kWarps) {
        __syncthreads();
    } else {
#if defined(__CUDA_ARCH__)
        asm volatile("bar.sync 1, %0;" ::"n"(32 * WALK) : "memory");
#elif defined(DQ_HOST_EMULATION)
        host_named_sync(1, 32 * WALK);
#endif
    }
}

// the walk's requests to the other warps (the command word)
enum { kCmdFlush, kCmdFinal };

// G's rows in shared memory at stride h + 16 / sizeof(S): 16-byte aligned
// (the flush's vector accesses), each row 16 bytes of banks on from the one
// before
__host__ __device__ constexpr int second_ld(int h, int sbytes) { return h + 16 / sbytes; }

// shared memory of the second body without G's rows (linalg/sdw_delayed.py
// smem_bytes): the C and R slots (q K x hs each, hs = h + q 16 / sbytes),
// the slice's delta blocks, phi_new and lhs, the walk warps' copies of the
// live field, the neighbour table, the command word and its argument;
// rounded up to 16 bytes
__host__ __device__ constexpr size_t second_fixed(int N, int opdim, int K, int q, int sbytes,
                                                  int rbytes) {
    return ((2 * size_t(q) * K * (q * N + q * 16 / sbytes) + size_t(q) * q * N) * sbytes +
            size_t(rbytes) * (size_t(N) * opdim * (1 + walk_warps(q * N)) + N) +
            sizeof(int) * (4 * size_t(N) + 2) + 15) / 16 * 16;
}

// the rows of G the second body keeps in shared memory: all h where they
// fit beside the rest, else the most that fit, a multiple of 8 (the flush
// tiles' rows); -1 where the rest alone does not fit
__host__ __device__ constexpr int second_rows(int N, int opdim, int K, int q, int sbytes,
                                              int rbytes) {
    const size_t fixed = second_fixed(N, opdim, K, q, sbytes, rbytes);
    const size_t row = size_t(second_ld(q * N, sbytes)) * sbytes;
    if (fixed > kSmemBudget) return -1;
    const size_t rows = (kSmemBudget - fixed) / row / 8 * 8;
    return rows < size_t(q) * N ? int(rows) : q * N;
}

inline size_t delayed_smem_second(int N, int opdim, int K, int q, size_t sbytes, size_t rbytes) {
    const int R = second_rows(N, opdim, K, q, int(sbytes), int(rbytes));
    return second_fixed(N, opdim, K, q, int(sbytes), int(rbytes)) +
           size_t(R < 0 ? 0 : R) * second_ld(q * N, int(sbytes)) * sbytes;
}

// The slice as the first body computes it (see the note at the top), G's
// first R rows in shared memory (second_rows: all of G where it fits) and
// the others in global memory (G_out, read from G_in until the first
// flush); same arguments as sdw_delayed_kernel (slots unused). The walk's
// warps request each flush and the last one through the command word; the
// other warps wait for it at the block barrier.
template <typename S, int Q, int EPT, int TR, int TC, int WALK, bool PROBE>
__global__ void __launch_bounds__(kThreads, 1)
sdw_delayed_smem_kernel(const S* __restrict__ G_in, S* G_out,
                        const typename real_of<S>::type* __restrict__ phi_in,
                        const typename real_of<S>::type* __restrict__ phin_in,
                        const typename real_of<S>::type* __restrict__ lhs_in,
                        const S* __restrict__ delta_in, const int* __restrict__ nb_in,
                        typename real_of<S>::type* __restrict__ phi_out,
                        typename real_of<S>::type* __restrict__ acc_out, S* slots, int N,
                        int opdim, int K, typename real_of<S>::type dtau,
                        typename real_of<S>::type c_det, long long* probe_out) {
    using T = typename real_of<S>::type;
    constexpr int QQ = Q * Q, WT = 32 * WALK;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int h = Q * N, Kq = Q * K, NO = N * opdim, ld = second_ld(h, sizeof(S));
    const int hs = h + Q * slot_pad<S>();
    const unsigned inv = slot_inv(N);
    const int R = second_rows(N, opdim, K, Q, sizeof(S), sizeof(T));
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const size_t wk = blockIdx.x;
    S* Cs = reinterpret_cast<S*>(smem_raw);  // Kq x hs: C[r][s] (slot_pos)
    S* Rs = Cs + Kq * hs;                    // Kq x hs: R[s][c]
    S* dl = Rs + Kq * hs;                    // q^2 N: the delta blocks
    T* phin = reinterpret_cast<T*>(dl + QQ * N);      // N x opdim
    T* lhs = phin + NO;                               // N
    T* phiw = lhs + N;                                // WALK x N x opdim
    int* nb = reinterpret_cast<int*>(phiw + WALK * NO);   // N x 4
    int* cmd = nb + 4 * N;                            // command, argument
    // G's rows r < R, Gm[r ld + c], after the rest (16-byte aligned)
    S* Gm = reinterpret_cast<S*>(smem_raw + second_fixed(N, opdim, K, Q, sizeof(S), sizeof(T)));
    Probe<PROBE, kPhases> probe;
    probe.start();

    const S* Gw = G_in + wk * size_t(h) * h;
    S* G = G_out + wk * size_t(h) * h;
    {
        // G_in's rows r < R, one warp a row, 16 bytes a copy
        const int cpr = h * int(sizeof(S)) / 16;
        for (int r = warp; r < R; r += kWarps)
            for (int c = lane; c < cpr; c += 32)
                cp_async16(reinterpret_cast<unsigned char*>(Gm + r * ld) + 16 * c,
                           reinterpret_cast<const unsigned char*>(Gw + size_t(r) * h) + 16 * c);
        cp_async_commit();
    }
    for (int idx = tid; idx < QQ * N; idx += kThreads) dl[idx] = delta_in[wk * QQ * N + idx];
    for (int idx = tid; idx < NO; idx += kThreads) {
        phin[idx] = phin_in[wk * NO + idx];
        const T p = phi_in[wk * NO + idx];
        for (int w = 0; w < WALK; ++w) phiw[w * NO + idx] = p;
    }
    for (int idx = tid; idx < N; idx += kThreads) lhs[idx] = lhs_in[wk * N + idx];
    for (int idx = tid; idx < 4 * N; idx += kThreads) nb[idx] = nb_in[idx];

    // what every thread runs of the walk's requests, between two barriers
    const S* Gs = Gw;                        // the global rows' source
    bool flushed = false;
    auto run = [&](int c, int ns) {
        if (c == kCmdFlush) {
            flush_rows<S, TR, TC, false>(Gm, ld, R, Gs, G, Cs, Rs, h, inv, hs, ns, false);
            Gs = G;
            flushed = true;
        } else {
            flush_rows<S, TR, TC, true>(Gm, ld, R, Gs, G, Cs, Rs, h, inv, hs, ns,
                                        flushed && ns == 0);
        }
    };
    cp_async_wait_all();
    probe.lap(kSetup);
    __syncthreads();
    probe.lap(kBarrier);

    if (warp >= WALK) {
        for (;;) {
            __syncthreads();
            const int c = cmd[0], ns = cmd[1];
            run(c, ns);
            if (c == kCmdFinal) break;
            __syncthreads();
        }
    } else {
        auto request = [&](int c, int ns) {
            // the walk's reads of G and of the slots have landed
            if (tid == 0) {
                cmd[0] = c;
                cmd[1] = ns;
            }
            __syncthreads();
            probe.lap(kBarrier);
            run(c, ns);
            probe.lap(kFlush);
            if (c != kCmdFinal) {
                __syncthreads();
                probe.lap(kBarrier);
            }
        };
        // the site's column b entry r and row b entry c, r, c < h
        auto colv = [&](int r, int b, int i) -> S {
            return r < R ? Gm[r * ld + b * N + i] : Gs[size_t(r) * h + b * N + i];
        };
        auto rowv = [&](int b, int i, int c) -> S {
            const int r = b * N + i;
            return r < R ? Gm[r * ld + c] : Gs[size_t(r) * h + c];
        };
        T* phi = phiw + warp * NO;           // this warp's live field
        // lanes e, e + q^2, ... hold G_II's entry e = q a + b: G_cur[j_a][j_b],
        // loaded for the next site while the current one is decided
        const SiteLanes<Q> L;
        // the slot positions of j_a, j_b (at site 0), and of the thread's
        // own entries r = tid + m 32 WALK
        const int pa = L.a * (N + slot_pad<S>()), pb = L.b * (N + slot_pad<S>());
        int pr[EPT];
#pragma unroll
        for (int m = 0; m < EPT; ++m) pr[m] = slot_pos<S>(tid + m * WT, inv);
        T n_acc = T(0);
        int nk = 0;                          // accepted sites in the slots
        S gnext = colv(L.a * N, L.b, 0);
        for (int i = 0; i < N; ++i) {
            if (nk == K) {
                request(kCmdFlush, Q * nk);
                nk = 0;
                gnext = colv(L.a * N + i, L.b, i);
            }
            const int ns = Q * nk;
            // lane e's G_II[a][b] = col_b[j_a], corrected slot by slot
            const int ja = L.a * N + i;
            const S g = gnext;
            if (i + 1 < N) gnext = colv(ja + 1, L.b, i + 1);
            const S x = correct(g, Cs + pa + i, Rs + pb + i, hs, ns);
            probe.lap(kGather);
            // every walk warp decides, on identical inputs (site i's own
            // field is still the slice's: phi_i = phi_in_i)
            const T live = site_live(phi, phin + i * opdim, phi + i * opdim, nb + 4 * i,
                                     opdim, dtau);
            S Tm[QQ];
            const bool accept = site_step_warp<S, Q>(x, dl + QQ * i, lhs[i], live, c_det, L,
                                                     Tm);
            probe.lap(kDecide);
            if (!accept) continue;           // uniform: no barrier
            n_acc = add_rn(n_acc, T(1));
            if (lane == 0)
                for (int o = 0; o < opdim; ++o) phi[i * opdim + o] = phin[i * opdim + o];
            __syncwarp();
            int pj[Q];
#pragma unroll
            for (int b = 0; b < Q; ++b) pj[b] = b * (N + slot_pad<S>()) + i;
#pragma unroll
            for (int m = 0; m < EPT; ++m) {
                const int r = tid + m * WT;
                if (r >= h) continue;
                S col[Q], row[Q];
#pragma unroll
                for (int b = 0; b < Q; ++b) {
                    col[b] = colv(r, b, i);
                    row[b] = rowv(b, i, r);
                }
                correct_lines<S, Q>(col, row, Cs, Rs, hs, pj, pr[m], ns);
#pragma unroll
                for (int b = 0; b < Q; ++b) {
                    S c = cmul_rn(col[0], Tm[b]);
#pragma unroll
                    for (int a = 1; a < Q; ++a) c = cadd_rn(c, cmul_rn(col[a], Tm[Q * a + b]));
                    Cs[(ns + b) * hs + pr[m]] = c;
                    Rs[(ns + b) * hs + pr[m]] = rsub_rn(r == b * N + i ? T(1) : T(0), row[b]);
                }
            }
            ++nk;
            probe.lap(kSlot);
            walk_sync<WALK>();
            probe.lap(kBarrier);
        }
        request(kCmdFinal, Q * nk);
        if (tid == 0) acc_out[wk] = n_acc;
    }

    // walk warp 0's field is every warp's (no write to it since the last
    // request)
    for (int idx = tid; idx < NO; idx += kThreads) phi_out[wk * NO + idx] = phiw[idx];
    probe.store(probe_out);
}

// the first body's instance for h = q N (EPT = 1 up to h = 256, else 2)
// and the slots' residence res (RES, 0-2); nullptr where res is not 0-2.
// Flush tiles (linalg/sdw_delayed.py flush_tile): 2 x 4 complex128
// entries, 4 x 4 of the other scalars at q = 4; 2 x 2 at q = 2
template <typename S, int Q, int EPT, bool PROBE>
auto delayed_instance(int res) {
    constexpr int TR = Q == 2 ? 2 : (sizeof(S) == 16 ? 2 : 4);
    constexpr int TC = Q == 2 ? 2 : 4;
    using Fn = decltype(&sdw_delayed_kernel<S, Q, EPT, TR, TC, 2, PROBE>);
    Fn fn = nullptr;
    if (res == 2) fn = sdw_delayed_kernel<S, Q, EPT, TR, TC, 2, PROBE>;
    else if (res == 1) fn = sdw_delayed_kernel<S, Q, EPT, TR, TC, 1, PROBE>;
    else if (res == 0) fn = sdw_delayed_kernel<S, Q, EPT, TR, TC, 0, PROBE>;
    return fn;
}

// the second body's instance for h = q N (N % 4 == 0): 4 walk warps up to
// h = 128, 8 beyond, an entry of a site's columns and rows a walk thread up
// to h = 256, two beyond; its probe instances up to h = 256
template <typename S, int Q, bool PROBE>
auto second_instance(int N) {
    // flush tiles of 8 x 4 floats (each R entry a shared-memory load serves
    // 8 products), 2 x 4 complex128 entries, else 4 x 4
    constexpr int TR = sizeof(S) == 4 ? 8 : sizeof(S) == 16 ? 2 : 4;
    using Fn = decltype(&sdw_delayed_kernel<S, Q, 1, 2, 2, 2, PROBE>);
    const int h = Q * N;
    if (N % 4 != 0) return Fn(nullptr);
    if (h <= 128) return Fn(sdw_delayed_smem_kernel<S, Q, 1, TR, 4, 4, PROBE>);
    if (h <= 256) return Fn(sdw_delayed_smem_kernel<S, Q, 1, TR, 4, 8, PROBE>);
    if constexpr (!PROBE)
        if (h <= 512) return Fn(sdw_delayed_smem_kernel<S, Q, 2, TR, 4, 8, PROBE>);
    return Fn(nullptr);
}

// the first body's probe instances beyond h = 256 only at complex q = 4;
// residence 3 is the second body's (q = 2 and real q = 4, where the slots
// fit beside G's first eight rows at least)
template <typename S, int Q, bool PROBE>
auto delayed_kernel(int N, int opdim, int K, int res) {
    using T = typename real_of<S>::type;
    constexpr bool COMPLEX = !std::is_same<S, T>::value;
    constexpr bool EPT2 = !PROBE || (Q == 4 && COMPLEX);
    using Fn = decltype(delayed_instance<S, Q, 1, PROBE>(res));
    const int h = Q * N;
    if (res == 3) {
        if constexpr (Q == 2 || !COMPLEX)
            if (second_rows(N, opdim, K, Q, sizeof(S), sizeof(T)) >= 8)
                return second_instance<S, Q, PROBE>(N);
        return Fn(nullptr);
    }
    if (h <= kThreads) return delayed_instance<S, Q, 1, PROBE>(res);
    if constexpr (EPT2)
        if (h <= 2 * kThreads) return delayed_instance<S, Q, 2, PROBE>(res);
    return Fn(nullptr);
}

// the dynamic shared memory of residence res
inline size_t delayed_smem_of(int N, int opdim, int K, int q, size_t sbytes, size_t rbytes,
                              int res) {
    return res == 3 ? delayed_smem_second(N, opdim, K, q, sbytes, rbytes)
                    : delayed_smem(N, opdim, K, q, sbytes, rbytes, res);
}

template <typename S, int Q, bool PROBE = false>
int sdw_delayed(int device, const void* G, void* G_out, const void* phi, const void* phin,
                const void* lhs, const void* delta, const void* nb, void* phi_out,
                void* acc_out, void* slots, int W, int N, int opdim, int K, int resident,
                double dtau, double c_det, void* stream, long long* probe = nullptr) {
    using T = typename real_of<S>::type;
    auto fn = delayed_kernel<S, Q, PROBE>(N, opdim, K, resident);
    if (!fn || K < 1 || K > N) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = delayed_smem_of(N, opdim, K, Q, sizeof(S), sizeof(T), resident);
    return launch_smem(device, fn, W, smem, stream, static_cast<const S*>(G),
                       static_cast<S*>(G_out), static_cast<const T*>(phi),
                       static_cast<const T*>(phin), static_cast<const T*>(lhs),
                       static_cast<const S*>(delta), static_cast<const int*>(nb),
                       static_cast<T*>(phi_out), static_cast<T*>(acc_out),
                       static_cast<S*>(slots), N, opdim, K, static_cast<T>(dtau),
                       static_cast<T>(c_det), probe);
}

template <typename S, int Q>
int delayed_blocks(int device, int N, int opdim, int K, int resident) {
    using T = typename real_of<S>::type;
    auto fn = delayed_kernel<S, Q, false>(N, opdim, K, resident);
    if (!fn) return -static_cast<int>(cudaErrorInvalidValue);
    return blocks_per_sm(device, fn,
                         delayed_smem_of(N, opdim, K, Q, sizeof(S), sizeof(T), resident));
}

// CTAs per SM of the q = 4 and the q = 2 instances (dtype: 0 float32,
// 1 float64, 2 complex64, 3 complex128)
template <int Q>
int delayed_blocks_of(int device, int dtype, int N, int opdim, int K, int resident) {
    switch (dtype) {
        case 0: return delayed_blocks<float, Q>(device, N, opdim, K, resident);
        case 1: return delayed_blocks<double, Q>(device, N, opdim, K, resident);
        case 2: return delayed_blocks<cplx<float>, Q>(device, N, opdim, K, resident);
        case 3: return delayed_blocks<cplx<double>, Q>(device, N, opdim, K, resident);
    }
    return -static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace dq

// G -> G_out over one slice, slots of K accepted sites; resident: the first
// body's slot buffers in shared memory (2: C and R, 1: R, 0: none) or the
// second body (3: C, R and G's first rows); slots: the global scratch for
// the others (W x (2 - resident) x q K x q N of G's scalar; unused from 2
// on) (linalg/sdw_delayed.py plan)
#define DQ_SDW_DELAYED_ENTRY(NAME, S, Q)                                               \
    extern "C" int NAME(int device, const void* G, void* G_out, const void* phi,       \
                        const void* phin, const void* lhs, const void* delta,          \
                        const void* nb, void* phi_out, void* acc_out, void* slots,     \
                        int W, int N, int opdim, int K, int resident, double dtau,     \
                        double c_det, void* stream) {                                  \
        return dq::sdw_delayed<S, Q>(device, G, G_out, phi, phin, lhs, delta, nb,      \
                                     phi_out, acc_out, slots, W, N, opdim, K,          \
                                     resident, dtau, c_det, stream);                   \
    }

DQ_SDW_DELAYED_ENTRY(dq_sdw_delayed_c64, dq::cplx<float>, 4)
DQ_SDW_DELAYED_ENTRY(dq_sdw_delayed_c128, dq::cplx<double>, 4)
DQ_SDW_DELAYED_ENTRY(dq_sdw_delayed_f32, float, 4)
DQ_SDW_DELAYED_ENTRY(dq_sdw_delayed_f64, double, 4)
DQ_SDW_DELAYED_ENTRY(dq_sdw_delayed_q2_c64, dq::cplx<float>, 2)
DQ_SDW_DELAYED_ENTRY(dq_sdw_delayed_q2_c128, dq::cplx<double>, 2)
DQ_SDW_DELAYED_ENTRY(dq_sdw_delayed_q2_f32, float, 2)
DQ_SDW_DELAYED_ENTRY(dq_sdw_delayed_q2_f64, double, 2)

// the same with the phase probe on: probe (W x 8 int64) gets each CTA's
// cycles per phase (PROBE_PHASES), its total cycles and its total ns
#define DQ_SDW_DELAYED_PROBE_ENTRY(NAME, S, Q)                                         \
    extern "C" int NAME(int device, const void* G, void* G_out, const void* phi,       \
                        const void* phin, const void* lhs, const void* delta,          \
                        const void* nb, void* phi_out, void* acc_out, void* slots,     \
                        int W, int N, int opdim, int K, int resident, double dtau,     \
                        double c_det, void* probe, void* stream) {                     \
        return dq::sdw_delayed<S, Q, true>(device, G, G_out, phi, phin, lhs, delta,    \
                                           nb, phi_out, acc_out, slots, W, N, opdim,   \
                                           K, resident, dtau, c_det, stream,           \
                                           static_cast<long long*>(probe));            \
    }

DQ_SDW_DELAYED_PROBE_ENTRY(dq_sdw_delayed_probe_c64, dq::cplx<float>, 4)
DQ_SDW_DELAYED_PROBE_ENTRY(dq_sdw_delayed_probe_f32, float, 4)
DQ_SDW_DELAYED_PROBE_ENTRY(dq_sdw_delayed_probe_q2_c64, dq::cplx<float>, 2)
DQ_SDW_DELAYED_PROBE_ENTRY(dq_sdw_delayed_probe_q2_f32, float, 2)

extern "C" {

// CTAs per SM of the production instance at q = 4 or 2 (no launch; dtype
// as dq::delayed_blocks_of)
int dq_sdw_delayed_blocks_per_sm(int device, int dtype, int q, int N, int opdim, int K,
                                 int resident) {
    if (q == 4) return dq::delayed_blocks_of<4>(device, dtype, N, opdim, K, resident);
    if (q == 2) return dq::delayed_blocks_of<2>(device, dtype, N, opdim, K, resident);
    return -static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
