// K1: Hubbard Metropolis slice update, one CTA per walker.
//
// Replaces the TPU kernel detqmc_tpu/linalg/pallas_update_lanes.py
// (slice_update, kernel body _kernel), which keeps 128 walkers in the
// vector lanes and G in VMEM. Here one CTA holds one walker's G for all C
// spin components and runs the sequential loop over the N sites inside
// the block. Per site i (pallas_update_lanes.py:17-23):
//     delta_c = exp(-2 sgn_c alpha s_i) - 1
//     R_c     = 1 + delta_c (1 - G_c[i,i])
//     R_tot   = R^2 / (1 + delta)  (C == 1, particle-hole mode) | R_0 R_1
//     accept  = u_i < |R_tot|
//     G_c    -= (delta_c / R_c) G_c[:, i] (x) (e_i - G_c[i, :])
//     s_i -> -s_i, sign *= sign(R_tot), acc += 1   (on accept)
//
// What bounds it (NVIDIA H100 80GB HBM3, 700 W; the parent design's probe
// in PERF.md): the N dependent site steps. The parent held G in shared
// memory and spent two thirds of its time in the rank-1 update (two runtime
// integer divisions and a shared-memory read-modify-write per entry), the
// rest in one thread's ratio while the others waited at two barriers a
// site. This design:
//   - G lives in registers: thread t owns a TR x TC tile of one
//     component (4 x 4 at N = 64: 256 threads a walker), so the update is
//     TR TC register operations on TR + TC values read from shared memory
//     (4 x 8 tiles where 4 x 4 ones need more threads than the registers
//     hold; shapes that neither fits go to K1b: linalg/slice_update.py
//     plan);
//   - no broadcast of the ratio: every thread forms the ratio and the
//     decision itself with the same operations in the same order, so all
//     agree bit for bit; a rejected site costs no barrier. Every warp
//     keeps G's diagonal in its lanes' registers (updated after every
//     accepted site with the tile entries' own operations) and shuffles
//     G[i][i] to all lanes;
//   - an accepted site: the owners of column i and row i publish them
//     (before the update) into the next of two buffers, one barrier, and
//     every thread updates its tile and its warp's diagonal;
//   - no runtime integer division (a tile's place is fixed at the start).
// The ratios and the update use explicitly rounded operations in the plain
// version's order, so for equal inputs the kernel reproduces the plain
// PyTorch version bit for bit up to exp(), and the accept decisions agree.
#include "common.cuh"

namespace dq {

// the phase probe's phases (Probe, common.cuh), mirrored by
// linalg/slice_update.py PROBE_PHASES: the ratio and decision, the publish
// of an accepted site, the barriers, the tile update, G's and the field's
// loads and stores
enum { kDecide, kPublish, kBarrier, kUpdate, kLoadStore, kPhases };

// registers a thread may use at most for a tile of WORDS 32-bit words (the
// tile and ~96 for the rest: ptxas spilled at ~64); the CTA's threads at
// most 65536 over that
template <int WORDS>
constexpr int k1_max_threads() {
    return (65536 / (WORDS + 96)) / 32 * 32;
}

constexpr int kDiag = 4;   // diagonal entries a lane keeps (N <= 128)

// TR x TC tile per thread in registers, components in blocks of tiles:
// thread t owns tile t % tpc of component t / tpc. Shared memory: the
// field, the uniforms and the sites' delta_c (C x NP), and two publish
// buffers of C x 2 x NP values (u, w; NP = N rounded up to a multiple of 8).
template <typename T, int TR, int TC, bool PROBE>
__global__ void __launch_bounds__(k1_max_threads<TR * TC * int(sizeof(T)) / 4>())
slice_update_kernel(const T* __restrict__ G_in, const T* __restrict__ field_in,
                    const T* __restrict__ u01, const T* __restrict__ sign_in,
                    T* __restrict__ G_out, T* __restrict__ field_out,
                    T* __restrict__ sign_out, T* __restrict__ acc_out,
                    int C, int N, T alpha, long long* probe_out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int NP = (N + 7) / 8 * 8;
    T* fld = reinterpret_cast<T*>(smem_raw);  // N (read only: the flips go
    T* uni = fld + NP;                         // NP  straight to field_out)
    T* dlt = uni + NP;                         // C x NP: delta_c of each site
    T* pub = dlt + C * NP;                     // 2 x C x 2 x NP: u, w
    Probe<PROBE, kPhases> probe;
    probe.start();

    const int tid = threadIdx.x, nt = blockDim.x;
    const size_t wk = blockIdx.x;
    const int NN = N * N;
    const T* Gw = G_in + wk * C * NN;
    const int tr = (N + TR - 1) / TR, tcn = (N + TC - 1) / TC, tpc = tr * tcn;
    const bool owner = tid < C * tpc;
    const int c = owner ? tid / tpc : 0, tt = owner ? tid - c * tpc : 0;
    const int a0 = TR * (tt / tcn), b0 = TC * (tt - (tt / tcn) * tcn);

    // the field, the uniforms and every site's delta_c (the field is the
    // slice's until the site is visited), off the sites' chain
    for (int idx = tid; idx < N; idx += nt) {
        const T s = field_in[wk * N + idx];
        fld[idx] = s;
        uni[idx] = u01[wk * N + idx];
        for (int cc = 0; cc < C; ++cc) {
            const T sgn = cc == 0 ? T(1) : T(-1);
            dlt[cc * NP + idx] = sub_rn(exp_t(mul_rn(mul_rn(mul_rn(T(-2), sgn), alpha), s)), T(1));
        }
    }
    // the tile
    T reg[TR][TC] = {};
    auto inside = [&](int p, int q) { return owner && a0 + p < N && b0 + q < N; };
#pragma unroll
    for (int p = 0; p < TR; ++p)
#pragma unroll
        for (int q = 0; q < TC; ++q)
            if (inside(p, q)) reg[p][q] = Gw[size_t(c) * NN + size_t(a0 + p) * N + b0 + q];
    // every warp keeps the diagonal of every component: lane l holds the
    // entries k = l + 32 m
    const int lane = tid & 31;
    T diag[2][kDiag];
#pragma unroll
    for (int cc = 0; cc < 2; ++cc)
#pragma unroll
        for (int m = 0; m < kDiag; ++m) {
            const int k = lane + 32 * m;
            diag[cc][m] = cc < C && k < N ? Gw[size_t(cc) * NN + size_t(k) * N + k] : T(0);
        }
    T sign = sign_in[wk], acc_n = T(0);
    int buf = 0;                            // the publish buffer in use
    probe.lap(kLoadStore);
    __syncthreads();
    probe.lap(kBarrier);

    for (int i = 0; i < N; ++i) {
        T delta[2] = {}, R[2] = {};
#pragma unroll
        for (int cc = 0; cc < 2; ++cc)
            if (cc < C) {
                T d = diag[cc][0];
#pragma unroll
                for (int m = 1; m < kDiag; ++m)
                    if (i >> 5 == m) d = diag[cc][m];
                d = __shfl_sync(0xffffffffu, d, i & 31);
                delta[cc] = dlt[cc * NP + i];
                R[cc] = add_rn(T(1), mul_rn(delta[cc], sub_rn(T(1), d)));
            }
        const T rtot = C == 1 ? div_rn(mul_rn(R[0], R[0]), add_rn(T(1), delta[0]))
                              : mul_rn(R[0], R[1]);
        const bool accept = uni[i] < abs_t(rtot);
        probe.lap(kDecide);
        if (tid == 0) field_out[wk * N + i] = accept ? -fld[i] : fld[i];
        if (!accept) continue;              // uniform: no barrier
        const T rs = rtot > T(0) ? T(1) : (rtot < T(0) ? T(-1) : T(0));
        sign = mul_rn(sign, rs);
        acc_n = acc_n + T(1);
        T coef[2] = {};
#pragma unroll
        for (int cc = 0; cc < 2; ++cc)
            if (cc < C) coef[cc] = div_rn(delta[cc], R[cc]);
        // the owners of column i and of row i publish them (u = G[:, i],
        // w = e_i - G[i, :]) into the other buffer, before the update
        buf ^= 1;
        T* po = pub + (buf * 2 * C + c * 2) * NP;
        if (owner && unsigned(i - b0) < unsigned(TC)) {
#pragma unroll
            for (int p = 0; p < TR; ++p)
#pragma unroll
                for (int q = 0; q < TC; ++q)
                    if (b0 + q == i && a0 + p < N) po[a0 + p] = reg[p][q];
        }
        if (owner && unsigned(i - a0) < unsigned(TR)) {
#pragma unroll
            for (int p = 0; p < TR; ++p)
#pragma unroll
                for (int q = 0; q < TC; ++q)
                    if (a0 + p == i && b0 + q < N)
                        po[NP + b0 + q] = sub_rn(b0 + q == i ? T(1) : T(0), reg[p][q]);
        }
        probe.lap(kPublish);
        __syncthreads();
        probe.lap(kBarrier);
        // G - (coef u) w, rounded as the plain version rounds it
        const T cf = c == 0 ? coef[0] : coef[1];
        T u[TR], w[TC];
#pragma unroll
        for (int p = 0; p < TR; ++p) u[p] = mul_rn(cf, po[min(a0 + p, NP - 1)]);
#pragma unroll
        for (int q = 0; q < TC; ++q) w[q] = po[NP + min(b0 + q, NP - 1)];
#pragma unroll
        for (int p = 0; p < TR; ++p)
#pragma unroll
            for (int q = 0; q < TC; ++q)
                reg[p][q] = sub_rn(reg[p][q], mul_rn(u[p], w[q]));
        // the warp's diagonal, with the tile entries' own operations
#pragma unroll
        for (int cc = 0; cc < 2; ++cc)
            if (cc < C) {
                const T* pc = pub + (buf * 2 * C + cc * 2) * NP;
#pragma unroll
                for (int m = 0; m < kDiag; ++m) {
                    const int k = lane + 32 * m;
                    if (k < N)
                        diag[cc][m] = sub_rn(diag[cc][m],
                                             mul_rn(mul_rn(coef[cc], pc[k]), pc[NP + k]));
                }
            }
        probe.lap(kUpdate);
    }

    T* Go = G_out + wk * C * NN;
#pragma unroll
    for (int p = 0; p < TR; ++p)
#pragma unroll
        for (int q = 0; q < TC; ++q)
            if (inside(p, q)) Go[size_t(c) * NN + size_t(a0 + p) * N + b0 + q] = reg[p][q];
    if (tid == 0) {
        sign_out[wk] = sign;
        acc_out[wk] = div_rn(acc_n, T(N));
    }
    probe.lap(kLoadStore);
    probe.store(probe_out);
}

// the plan's instance (linalg/slice_update.py plan): tile 4 x 4 or 4 x 8;
// nullptr for another tile
template <typename T, bool PROBE>
auto k1_kernel(int tr, int tc) {
    using Fn = decltype(&slice_update_kernel<T, 4, 4, PROBE>);
    Fn fn = nullptr;
    if (tr == 4 && tc == 4) fn = slice_update_kernel<T, 4, 4, PROBE>;
    else if (tr == 4 && tc == 8) fn = slice_update_kernel<T, 4, 8, PROBE>;
    return fn;
}

inline int k1_threads(int C, int N, int tr, int tc) {
    return (C * ((N + tr - 1) / tr) * ((N + tc - 1) / tc) + 31) / 32 * 32;
}

inline size_t k1_smem(int C, int N, size_t item) {
    const size_t NP = (N + 7) / 8 * 8;
    return item * (2 * NP + 5 * size_t(C) * NP);
}

template <typename T>
int slice_update(int device, const void* G, const void* field, const void* u01,
                 const void* sign, void* G_out, void* field_out, void* sign_out,
                 void* acc_out, int W, int C, int N, int tr, int tc, double alpha,
                 void* stream, long long* probe = nullptr) {
    auto fn = probe ? k1_kernel<T, true>(tr, tc) : k1_kernel<T, false>(tr, tc);
    if (!fn || C < 1 || C > 2) return static_cast<int>(cudaErrorInvalidValue);
    return launch_block(device, fn, W, k1_threads(C, N, tr, tc),
                        k1_smem(C, N, sizeof(T)), stream,
                        static_cast<const T*>(G), static_cast<const T*>(field),
                        static_cast<const T*>(u01), static_cast<const T*>(sign),
                        static_cast<T*>(G_out), static_cast<T*>(field_out),
                        static_cast<T*>(sign_out), static_cast<T*>(acc_out), C, N,
                        static_cast<T>(alpha), probe);
}

template <typename T>
int k1_blocks(int device, int C, int N, int tr, int tc) {
    auto fn = k1_kernel<T, false>(tr, tc);
    if (!fn) return -static_cast<int>(cudaErrorInvalidValue);
    return blocks_per_sm(device, fn, k1_smem(C, N, sizeof(T)),
                         k1_threads(C, N, tr, tc));
}

}  // namespace dq

extern "C" {

// tr, tc: the plan (linalg/slice_update.py plan)
int dq_slice_update_f32(int device, const void* G, const void* field,
                        const void* u01, const void* sign, void* G_out,
                        void* field_out, void* sign_out, void* acc_out, int W,
                        int C, int N, int tr, int tc, double alpha, void* stream) {
    return dq::slice_update<float>(device, G, field, u01, sign, G_out, field_out,
                                   sign_out, acc_out, W, C, N, tr, tc, alpha, stream);
}

int dq_slice_update_f64(int device, const void* G, const void* field,
                        const void* u01, const void* sign, void* G_out,
                        void* field_out, void* sign_out, void* acc_out, int W,
                        int C, int N, int tr, int tc, double alpha, void* stream) {
    return dq::slice_update<double>(device, G, field, u01, sign, G_out, field_out,
                                    sign_out, acc_out, W, C, N, tr, tc, alpha, stream);
}

// the same with the phase probe on: probe (W x 7 int64) gets each CTA's
// cycles per phase (PROBE_PHASES), its total cycles and its total ns
int dq_slice_update_probe_f32(int device, const void* G, const void* field,
                              const void* u01, const void* sign, void* G_out,
                              void* field_out, void* sign_out, void* acc_out, int W,
                              int C, int N, int tr, int tc, double alpha, void* probe,
                              void* stream) {
    return dq::slice_update<float>(device, G, field, u01, sign, G_out, field_out,
                                   sign_out, acc_out, W, C, N, tr, tc, alpha, stream,
                                   static_cast<long long*>(probe));
}

int dq_slice_update_probe_f64(int device, const void* G, const void* field,
                              const void* u01, const void* sign, void* G_out,
                              void* field_out, void* sign_out, void* acc_out, int W,
                              int C, int N, int tr, int tc, double alpha, void* probe,
                              void* stream) {
    return dq::slice_update<double>(device, G, field, u01, sign, G_out, field_out,
                                    sign_out, acc_out, W, C, N, tr, tc, alpha, stream,
                                    static_cast<long long*>(probe));
}

// CTAs per SM of the production instance at this plan (no launch)
int dq_slice_update_blocks_per_sm(int device, int f64, int C, int N, int tr, int tc) {
    return f64 ? dq::k1_blocks<double>(device, C, N, tr, tc)
               : dq::k1_blocks<float>(device, C, N, tr, tc);
}

}  // extern "C"
