// The per-site scalar chain of the SDW slice updates K4 (sdw_update.cu) and
// K5 (sdw_delayed.cu): the live gradient term, the closed-form 4x4
// determinant / adjugate, the log-domain accept and the Woodbury factor T.
// K4 runs it on one thread per site (site_step, ~1500 rounded operations);
// K5 spreads it over 16 lanes of a warp, one 4x4 entry a lane
// (site_step_warp: the same operations on each entry). Every product and sum
// is explicitly rounded (cmul_rn ...) in the order of the plain PyTorch
// versions (linalg/sdw_update.py, linalg/sdw_delayed.py), so for equal
// inputs kernel and plain version agree bit for bit up to log().
#pragma once

#include "common.cuh"

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

// det(A) and adj(A) of a complex 4x4 (A flat, row-major)
template <typename T>
__device__ cplx<T> det_adj4(const cplx<T>* A, cplx<T>* adj) {
    cplx<T> m[12];
    for (int k = 0; k < 6; ++k) {
        const int a = kPairA[k], b = kPairB[k];
        m[k] = csub_rn(cmul_rn(A[a], A[4 + b]), cmul_rn(A[b], A[4 + a]));
        m[6 + k] = csub_rn(cmul_rn(A[8 + a], A[12 + b]),
                           cmul_rn(A[8 + b], A[12 + a]));
    }
    cplx<T> p[6];
    for (int k = 0; k < 6; ++k) p[k] = cmul_rn(m[k], m[11 - k]);
    const cplx<T> det = cadd_rn(cadd_rn(csub_rn(p[0], p[1]), p[2]),
                                cadd_rn(csub_rn(p[3], p[4]), p[5]));
    for (int e = 0; e < 16; ++e) {
        const cplx<T> t = cadd_rn(csub_rn(cmul_rn(A[kAdjP[e]], m[kAdjX[e]]),
                                          cmul_rn(A[kAdjQ[e]], m[kAdjY[e]])),
                                  cmul_rn(A[kAdjR[e]], m[kAdjZ[e]]));
        adj[e] = kAdjNeg[e] ? -t : t;
    }
    return det;
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

// Metropolis step of one site from the current G_II (4x4, row-major:
// G_II[4 a + b] = G[a N + i, b N + i]) and Delta_i (4x4):
//     A = 1 + Delta (1 - G_II);  accept = lhs < c_det log|det A|^2 + live
// and on accept T = adj(A) Delta / det(A) into Tm (else Tm is untouched).
template <typename T>
__device__ bool site_step(const cplx<T>* GII, const cplx<T>* D, T lhs, T live,
                          T c_det, cplx<T>* Tm) {
    using S = cplx<T>;
    S Mm[16], A[16], adj[16];
    for (int a = 0; a < 4; ++a)
        for (int b = 0; b < 4; ++b) {
            const S g = GII[4 * a + b];
            Mm[4 * a + b] = mk(sub_rn(a == b ? T(1) : T(0), g.re), -g.im);
        }
    for (int a = 0; a < 4; ++a)
        for (int b = 0; b < 4; ++b) {
            S acc = cmul_rn(D[4 * a], Mm[b]);
            for (int k = 1; k < 4; ++k)
                acc = cadd_rn(acc, cmul_rn(D[4 * a + k], Mm[4 * k + b]));
            A[4 * a + b] = mk(add_rn(acc.re, a == b ? T(1) : T(0)), acc.im);
        }
    const S R = det_adj4(A, adj);
    const T r2 = add_rn(mul_rn(R.re, R.re), mul_rn(R.im, R.im));
    const T rhs = add_rn(mul_rn(c_det, log_t(r2)), live);
    const bool acc = lhs < rhs;
    if (acc) {
        const T inv_den = div_rn(T(1), r2);
        const S rinv = mk(mul_rn(R.re, inv_den), mul_rn(-R.im, inv_den));
        for (int a = 0; a < 4; ++a)
            for (int b = 0; b < 4; ++b) {
                S t = cmul_rn(adj[4 * a], D[b]);
                for (int k = 1; k < 4; ++k)
                    t = cadd_rn(t, cmul_rn(adj[4 * a + k], D[4 * k + b]));
                Tm[4 * a + b] = cmul_rn(t, rinv);
            }
    }
    return acc;
}

// The lane tables of site_step_warp: lane e = lane & 15 computes entry e of
// A, of the minors (e < 12; m[e]), of adj(A) and of T, and reads its
// operands from the lanes below
struct SiteLanes {
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

template <typename T>
__device__ __forceinline__ cplx<T> shfl_c(cplx<T> v, int src) {
    return mk(__shfl_sync(0xffffffffu, v.re, src), __shfl_sync(0xffffffffu, v.im, src));
}

// site_step over a warp: lane e (and e + 16) holds g = G_II[e] (entry
// 4 a + b); every lane gets the same decision and, on accept, all 16
// entries of T in Tm. Each entry is formed by the operations site_step
// forms it with, in the same order, so both give the same bits. The whole
// warp calls it (the shuffles need every lane).
template <typename T>
__device__ bool site_step_warp(cplx<T> g, const cplx<T>* D, T lhs, T live, T c_det,
                               const SiteLanes& L, cplx<T>* Tm) {
    using S = cplx<T>;
    const S M = mk(sub_rn(L.a == L.b ? T(1) : T(0), g.re), -g.im);
    S acc = cmul_rn(D[4 * L.a], shfl_c(M, L.b));
#pragma unroll
    for (int k = 1; k < 4; ++k)
        acc = cadd_rn(acc, cmul_rn(D[4 * L.a + k], shfl_c(M, 4 * k + L.b)));
    const S A = mk(add_rn(acc.re, L.a == L.b ? T(1) : T(0)), acc.im);
    // the twelve minors (lanes 0-11), their six products (lanes 0-5)
    const S m = csub_rn(cmul_rn(shfl_c(A, L.ro + L.pa), shfl_c(A, L.ro + 4 + L.pb)),
                        cmul_rn(shfl_c(A, L.ro + L.pb), shfl_c(A, L.ro + 4 + L.pa)));
    const S pk = cmul_rn(m, shfl_c(m, L.e < 6 ? 11 - L.e : 0));
    const S det = cadd_rn(cadd_rn(csub_rn(shfl_c(pk, 0), shfl_c(pk, 1)), shfl_c(pk, 2)),
                          cadd_rn(csub_rn(shfl_c(pk, 3), shfl_c(pk, 4)), shfl_c(pk, 5)));
    const S t = cadd_rn(csub_rn(cmul_rn(shfl_c(A, L.p), shfl_c(m, L.x)),
                                cmul_rn(shfl_c(A, L.q), shfl_c(m, L.y))),
                        cmul_rn(shfl_c(A, L.r), shfl_c(m, L.z)));
    const S adj = L.neg ? -t : t;
    const T r2 = add_rn(mul_rn(det.re, det.re), mul_rn(det.im, det.im));
    const T rhs = add_rn(mul_rn(c_det, log_t(r2)), live);
    const bool accept = lhs < rhs;
    if (accept) {                            // warp-uniform
        const T inv_den = div_rn(T(1), r2);
        const S rinv = mk(mul_rn(det.re, inv_den), mul_rn(-det.im, inv_den));
        S u = cmul_rn(shfl_c(adj, 4 * L.a), D[L.b]);
#pragma unroll
        for (int k = 1; k < 4; ++k)
            u = cadd_rn(u, cmul_rn(shfl_c(adj, 4 * L.a + k), D[4 * k + L.b]));
        const S Te = cmul_rn(u, rinv);
#pragma unroll
        for (int f = 0; f < 16; ++f) Tm[f] = shfl_c(Te, f);
    }
    return accept;
}

}  // namespace dq
