// The per-site scalar chain of the SDW slice updates K4 (sdw_update.cu) and
// K5 (sdw_delayed.cu): the live gradient term, the closed-form 4x4
// determinant / adjugate, the log-domain accept and the Woodbury factor T.
// Both run it in every warp, 16 lanes a site, one 4x4 entry a lane
// (site_step_warp: the plain version's operations on each entry, ~1500
// rounded ones a site). Every product and sum
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

// the entries of Delta_i a lane of site_step_warp reads: its row a,
// row[k] = D[4 a + k], and its column b, col[k] = D[4 k + b]
template <typename T>
struct SiteDelta {
    cplx<T> row[4], col[4];
};

template <typename T>
__device__ __forceinline__ SiteDelta<T> site_delta(const cplx<T>* D, const SiteLanes& L) {
    SiteDelta<T> d;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        d.row[k] = D[4 * L.a + k];
        d.col[k] = D[4 * k + L.b];
    }
    return d;
}

// The Metropolis step of one site over a warp, from the current G_II and
// Delta_i:
//     A = 1 + Delta (1 - G_II);  accept = lhs < c_det log|det A|^2 + live
// and on accept T = adj(A) Delta / det(A) (else Te is untouched).
// Lane e (and e + 16) holds g = G_II[e] (entry 4 a + b, G_II[4 a + b] =
// G[a N + i, b N + i]) and its entries d of Delta_i; every lane gets the
// same decision and, on accept, entry e of T in Te. Each entry is formed
// by the operations the plain version (linalg/sdw_update.py site_step)
// forms it with, in the same order, so both give the same bits. The whole
// warp calls it (the shuffles need every lane).
template <typename T>
__device__ bool site_step_warp(cplx<T> g, const SiteDelta<T>& d, T lhs, T live, T c_det,
                               const SiteLanes& L, cplx<T>& Te) {
    using S = cplx<T>;
    const S M = mk(sub_rn(L.a == L.b ? T(1) : T(0), g.re), -g.im);
    S acc = cmul_rn(d.row[0], shfl_c(M, L.b));
#pragma unroll
    for (int k = 1; k < 4; ++k)
        acc = cadd_rn(acc, cmul_rn(d.row[k], shfl_c(M, 4 * k + L.b)));
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
        S u = cmul_rn(shfl_c(adj, 4 * L.a), d.col[0]);
#pragma unroll
        for (int k = 1; k < 4; ++k)
            u = cadd_rn(u, cmul_rn(shfl_c(adj, 4 * L.a + k), d.col[k]));
        Te = cmul_rn(u, rinv);
    }
    return accept;
}

// the same with Delta_i (4x4, row-major) read from D, and on accept all 16
// entries of T in Tm on every lane
template <typename T>
__device__ bool site_step_warp(cplx<T> g, const cplx<T>* D, T lhs, T live, T c_det,
                               const SiteLanes& L, cplx<T>* Tm) {
    cplx<T> Te;
    const bool accept = site_step_warp(g, site_delta(D, L), lhs, live, c_det, L, Te);
    if (accept)                              // warp-uniform
#pragma unroll
        for (int f = 0; f < 16; ++f) Tm[f] = shfl_c(Te, f);
    return accept;
}

}  // namespace dq
