// The per-site scalar chain of the SDW slice updates K4 (sdw_update.cu) and
// K5 (sdw_delayed.cu): the live gradient term, the closed-form q x q
// determinant / adjugate, the log-domain accept and the Woodbury factor T.
// Both run it in every warp, q^2 lanes a site (16 at q = 4, 4 at q = 2),
// one q x q entry a lane (site_step_warp: the plain version's operations on
// each entry, ~1500 rounded ones a site at q = 4). The scalar S is
// cplx<float> or cplx<double> (the full model's 4x4 blocks, the opdim-2
// sector's 2x2 blocks) or float or double (the real opdim-1 sector's 2x2
// blocks, no complex arithmetic at all). Every product and sum is
// explicitly rounded (cmul_rn ...) in the order of the plain PyTorch
// versions (linalg/sdw_update.py, linalg/sdw_delayed.py), so for equal
// inputs kernel and plain version agree bit for bit up to log().
#pragma once

#include "tc_blocked.cuh"   // load4, and common.cuh

namespace dq {

// the six column pairs of the 2x2 minors: s_k of rows (0, 1), c_k of
// rows (2, 3); minors[k] = s_k, minors[6 + k] = c_k
static __constant__ int kPairA[6] = {0, 0, 0, 1, 1, 2};
static __constant__ int kPairB[6] = {1, 2, 3, 2, 3, 3};
// adj(A)[e] = +-((A[p] m[x] - A[q] m[y]) + A[r] m[z]), A flat 4 r + c,
// m the twelve minors (pallas_sdw_update.py:_det_adj4)
static __constant__ int kAdjP[16] = {5, 1, 13, 9, 4, 0, 12, 8, 4, 0, 12, 8, 4, 0, 12, 8};
static __constant__ int kAdjX[16] = {11, 11, 5, 5, 11, 11, 5, 5, 10, 10, 4, 4, 9, 9, 3, 3};
static __constant__ int kAdjQ[16] = {6, 2, 14, 10, 6, 2, 14, 10, 5, 1, 13, 9, 5, 1, 13, 9};
static __constant__ int kAdjY[16] = {10, 10, 4, 4, 8, 8, 2, 2, 8, 8, 2, 2, 7, 7, 1, 1};
static __constant__ int kAdjR[16] = {7, 3, 15, 11, 7, 3, 15, 11, 7, 3, 15, 11, 6, 2, 14, 10};
static __constant__ int kAdjZ[16] = {9, 9, 3, 3, 7, 7, 1, 1, 6, 6, 0, 0, 6, 6, 0, 0};
static __constant__ int kAdjNeg[16] = {0, 1, 0, 1, 1, 0, 1, 0, 0, 1, 0, 1, 1, 0, 1, 0};

// ---- the chain's scalar operations on S = T or cplx<T> ---------------------
// the real S's products, sums and differences (the complex ones are
// common.cuh's cmul_rn ...)
__device__ __forceinline__ float cmul_rn(float a, float b) { return mul_rn(a, b); }
__device__ __forceinline__ double cmul_rn(double a, double b) { return mul_rn(a, b); }
__device__ __forceinline__ float cadd_rn(float a, float b) { return add_rn(a, b); }
__device__ __forceinline__ double cadd_rn(double a, double b) { return add_rn(a, b); }
__device__ __forceinline__ float csub_rn(float a, float b) { return sub_rn(a, b); }
__device__ __forceinline__ double csub_rn(double a, double b) { return sub_rn(a, b); }
// x - g for a real x (the imaginary part negated)
__device__ __forceinline__ float rsub_rn(float x, float g) { return sub_rn(x, g); }
__device__ __forceinline__ double rsub_rn(double x, double g) { return sub_rn(x, g); }
template <typename T>
__device__ __forceinline__ cplx<T> rsub_rn(T x, cplx<T> g) { return mk(sub_rn(x, g.re), -g.im); }
// a + x for a real x
__device__ __forceinline__ float radd_rn(float a, float x) { return add_rn(a, x); }
__device__ __forceinline__ double radd_rn(double a, double x) { return add_rn(a, x); }
template <typename T>
__device__ __forceinline__ cplx<T> radd_rn(cplx<T> a, T x) { return mk(add_rn(a.re, x), a.im); }
// |a|^2
__device__ __forceinline__ float abs2_rn(float a) { return mul_rn(a, a); }
__device__ __forceinline__ double abs2_rn(double a) { return mul_rn(a, a); }
template <typename T>
__device__ __forceinline__ T abs2_rn(cplx<T> a) {
    return add_rn(mul_rn(a.re, a.re), mul_rn(a.im, a.im));
}
// conj(a) x for a real x, each part rounded once
__device__ __forceinline__ float conj_scale_rn(float a, float x) { return mul_rn(a, x); }
__device__ __forceinline__ double conj_scale_rn(double a, double x) { return mul_rn(a, x); }
template <typename T>
__device__ __forceinline__ cplx<T> conj_scale_rn(cplx<T> a, T x) {
    return mk(mul_rn(a.re, x), mul_rn(-a.im, x));
}
// a warp shuffle of a whole scalar
__device__ __forceinline__ float shfl_c(float v, int src) { return __shfl_sync(0xffffffffu, v, src); }
__device__ __forceinline__ double shfl_c(double v, int src) { return __shfl_sync(0xffffffffu, v, src); }
template <typename T>
__device__ __forceinline__ cplx<T> shfl_c(cplx<T> v, int src) {
    return mk(__shfl_sync(0xffffffffu, v.re, src), __shfl_sync(0xffffffffu, v.im, src));
}
// q values from p: one 16-byte-aligned vector load of four (load4) or two
// plain loads
template <int Q, typename S>
__device__ __forceinline__ void load_q(const S* p, S (&v)[Q]) {
    if constexpr (Q == 4) {
        load4(p, v);
    } else {
#pragma unroll
        for (int k = 0; k < Q; ++k) v[k] = p[k];
    }
}

// live spatial-gradient term of site i through the already-updated field
// phi (N x opdim): dtau (phi_new_i - phi_old_i) . sum_d phi[nb_d]
template <typename T>
__device__ T site_live(const T* phi, const T* phin_i, const T* phi0_i,
                       const int* nb_i, int opdim, T dtau) {
    T dot = T(0);
    for (int o = 0; o < opdim; ++o) {
        T snb = add_rn(phi[nb_i[0] * opdim + o], phi[nb_i[1] * opdim + o]);
        snb = add_rn(snb, phi[nb_i[2] * opdim + o]);
        snb = add_rn(snb, phi[nb_i[3] * opdim + o]);
        const T d = sub_rn(phin_i[o], phi0_i[o]);
        dot = o == 0 ? mul_rn(d, snb) : add_rn(dot, mul_rn(d, snb));
    }
    return mul_rn(dtau, dot);
}

// The lane tables of site_step_warp: lane e = lane mod q^2 computes entry e
// of A, of adj(A) and of T (and at q = 4, e < 12, of the minors m[e]),
// and reads its operands from the lanes below
template <int Q> struct SiteLanes;

template <>
struct SiteLanes<4> {
    int e, a, b, ro, pa, pb, p, x, q, y, r, z;
    bool neg;
    __device__ SiteLanes() {
        e = threadIdx.x & 15;
        a = e >> 2;
        b = e & 3;
        const int k = e < 6 ? e : (e < 12 ? e - 6 : 0);
        ro = e < 6 ? 0 : 8;                  // the minor's rows: (0, 1) or (2, 3)
        pa = kPairA[k];
        pb = kPairB[k];
        p = kAdjP[e];
        x = kAdjX[e];
        q = kAdjQ[e];
        y = kAdjY[e];
        r = kAdjR[e];
        z = kAdjZ[e];
        neg = kAdjNeg[e] != 0;
    }
};

// q = 2: adj(A) = [[a11, -a01], [-a10, a00]]: entry e reads A[src] (negated
// off the diagonal)
template <>
struct SiteLanes<2> {
    int e, a, b, src;
    bool neg;
    __device__ SiteLanes() {
        e = threadIdx.x & 3;
        a = e >> 1;
        b = e & 1;
        neg = a != b;
        src = neg ? e : 3 - e;
    }
};

// the entries of Delta_i a lane of site_step_warp reads: its row a,
// row[k] = D[q a + k], and its column b, col[k] = D[q k + b]
template <typename S, int Q>
struct SiteDelta {
    S row[Q], col[Q];
};

template <typename S, int Q>
__device__ __forceinline__ SiteDelta<S, Q> site_delta(const S* D, const SiteLanes<Q>& L) {
    SiteDelta<S, Q> d;
#pragma unroll
    for (int k = 0; k < Q; ++k) {
        d.row[k] = D[Q * L.a + k];
        d.col[k] = D[Q * k + L.b];
    }
    return d;
}

// no phase probe in the site step (K4's probe instances pass a callable
// that charges the step's phases: 0 A, 1 det and adj, 2 the log and the
// decision, 3 T)
struct NoLap {
    __device__ __forceinline__ void operator()(int) const {}
};

// The Metropolis step of one site over a warp, from the current G_II and
// Delta_i:
//     A = 1 + Delta (1 - G_II);  accept = lhs < c_det log|det A|^2 + live
// and on accept T = adj(A) Delta / det(A) (else Te is untouched).
// Lane e (and e + q^2, ...) holds g = G_II[e] (entry q a + b, G_II[q a + b]
// = G[a N + i, b N + i]) and its entries d of Delta_i; every lane gets the
// same decision and, on accept, entry e of T in Te. Each entry is formed
// by the operations the plain version (linalg/sdw_update.py site_step)
// forms it with, in the same order, so both give the same bits. The whole
// warp calls it (the shuffles need every lane).
template <typename S, int Q, typename Lap = NoLap>
__device__ bool site_step_warp(S g, const SiteDelta<S, Q>& d, typename real_of<S>::type lhs,
                               typename real_of<S>::type live,
                               typename real_of<S>::type c_det, const SiteLanes<Q>& L,
                               S& Te, Lap lap = Lap()) {
    using T = typename real_of<S>::type;
    const S M = rsub_rn(L.a == L.b ? T(1) : T(0), g);
    S acc = cmul_rn(d.row[0], shfl_c(M, L.b));
#pragma unroll
    for (int k = 1; k < Q; ++k)
        acc = cadd_rn(acc, cmul_rn(d.row[k], shfl_c(M, Q * k + L.b)));
    const S A = radd_rn(acc, L.a == L.b ? T(1) : T(0));
    lap(0);
    S det, adj;
    if constexpr (Q == 4) {
        // the twelve minors (lanes 0-11), their six products (lanes 0-5)
        const S m = csub_rn(cmul_rn(shfl_c(A, L.ro + L.pa), shfl_c(A, L.ro + 4 + L.pb)),
                            cmul_rn(shfl_c(A, L.ro + L.pb), shfl_c(A, L.ro + 4 + L.pa)));
        const S pk = cmul_rn(m, shfl_c(m, L.e < 6 ? 11 - L.e : 0));
        det = cadd_rn(cadd_rn(csub_rn(shfl_c(pk, 0), shfl_c(pk, 1)), shfl_c(pk, 2)),
                      cadd_rn(csub_rn(shfl_c(pk, 3), shfl_c(pk, 4)), shfl_c(pk, 5)));
        const S t = cadd_rn(csub_rn(cmul_rn(shfl_c(A, L.p), shfl_c(m, L.x)),
                                    cmul_rn(shfl_c(A, L.q), shfl_c(m, L.y))),
                            cmul_rn(shfl_c(A, L.r), shfl_c(m, L.z)));
        adj = L.neg ? -t : t;
    } else {
        // a00 a11 - a01 a10 (pallas_sdw_update.py:_det2, _adj2)
        det = csub_rn(cmul_rn(shfl_c(A, 0), shfl_c(A, 3)), cmul_rn(shfl_c(A, 1), shfl_c(A, 2)));
        const S t = shfl_c(A, L.src);
        adj = L.neg ? -t : t;
    }
    lap(1);
    const T r2 = abs2_rn(det);
    const T rhs = add_rn(mul_rn(c_det, log_t(r2)), live);
    const bool accept = lhs < rhs;
    lap(2);
    if (accept) {                            // warp-uniform
        const T inv_den = div_rn(T(1), r2);
        const S rinv = conj_scale_rn(det, inv_den);
        S u = cmul_rn(shfl_c(adj, Q * L.a), d.col[0]);
#pragma unroll
        for (int k = 1; k < Q; ++k) u = cadd_rn(u, cmul_rn(shfl_c(adj, Q * L.a + k), d.col[k]));
        Te = cmul_rn(u, rinv);
        lap(3);
    }
    return accept;
}

// the same with Delta_i (q x q, row-major) read from D, and on accept all
// q^2 entries of T in Tm on every lane
template <typename S, int Q>
__device__ bool site_step_warp(S g, const S* D, typename real_of<S>::type lhs,
                               typename real_of<S>::type live,
                               typename real_of<S>::type c_det, const SiteLanes<Q>& L,
                               S* Tm) {
    S Te;
    const bool accept = site_step_warp<S, Q>(g, site_delta<S, Q>(D, L), lhs, live, c_det, L, Te);
    if (accept)                              // warp-uniform
#pragma unroll
        for (int f = 0; f < Q * Q; ++f) Tm[f] = shfl_c(Te, f);
    return accept;
}

}  // namespace dq
