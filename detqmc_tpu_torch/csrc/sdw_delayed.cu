// K5: delayed SDW slice update, one chunk of Kc sites, one CTA per walker.
//
// Replaces the TPU kernel detqmc_tpu/linalg/pallas_sdw_delayed.py
// (slice_update_sdw_delayed, kernel body _kernel) in its default
// flush-each scheme (pallas_sdw_delayed.py:292-306): for every chunk the
// caller slices the chunk's column and row panels out of the current G,
// this kernel walks the chunk's sites and emits the rank-(Kc q) factors,
// and the caller flushes G -= C @ R with one batched matmul. The kernel
// never touches G. Slots are site-major: slot k = j q + b is orbital b of
// the chunk's j-th site i = i0 + j, dim index j_b = b N + i (q = 4).
//
// Inputs (walker w; h = 4 N, Kq = Kc q):
//     colT (W, Kq, h)  colT[k][r] = G[r][j_b]     (column panel, transposed)
//     rowp (W, Kq, h)  rowp[k][c] = G[j_b][c]     (row panel)
//     phi  (W, N, opdim) the slice's field after the previous chunks
// Outputs:
//     CT   (W, Kq, h)  CT[k][r] = C[r][k], C = accept ? cols . T : 0
//     R    (W, Kq, h)  R[k][c]  = e_{j_b}[c] - G_cur[j_b][c]
//     phi_out, acc_out (accepted sites of this chunk)
// Per site (pallas_sdw_delayed.py:91-216): the site's q columns and rows
// of the current G are the panel's, corrected by the chunk's earlier slots
// k < j q in ascending order,
//     col_b -= C[:, k] R[k, j_b];   row_b -= C[j_b, k] R[k, :],
// then thread 0 runs the scalar chain of K4 (sdw_site.cuh) on G_II, and
// all threads write the site's C slots (gate . sum_a col_a T_ab) and R
// slots. phi is updated by select, as in K4.
//
// What bounds it on the H100: per site, 2 q h (j q) complex products for
// the slot corrections and one single-thread scalar chain, three
// __syncthreads. Shared memory holds only the site's corrected columns and
// rows (2 q h values: 16 KB at h = 256 in complex64) and the field; CT and
// R stay in global memory (L1/L2: 2 Kq h values, 128 KB per walker at
// h = 256, K = 8 in complex64), so every dim up to 512 fits in complex64
// and complex128 alike. The O(h^2 Kq) flush is the caller's tensor-core
// matmul, not this kernel's work. Every product and sum is explicitly
// rounded in the plain version's order (linalg/sdw_delayed.py).
#include "sdw_site.cuh"

namespace dq {

template <typename T>
__global__ void __launch_bounds__(kThreads)
sdw_delayed_kernel(const cplx<T>* __restrict__ colT, const cplx<T>* __restrict__ rowp,
                   const T* __restrict__ phi_in, const T* __restrict__ phin_in,
                   const T* __restrict__ lhs_in, const cplx<T>* __restrict__ delta_in,
                   const int* __restrict__ nb, cplx<T>* CT, cplx<T>* Rb,
                   T* __restrict__ phi_out, T* __restrict__ acc_out, int N,
                   int opdim, int i0, int Kc, T dtau, T c_det) {
    using S = cplx<T>;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int h = 4 * N, Kq = 4 * Kc;
    S* ccol = reinterpret_cast<S*>(smem_raw);   // 4 x h: G_cur[:, j_b]
    S* crow = ccol + 4 * h;                      // 4 x h: G_cur[j_b, :]
    T* phi = reinterpret_cast<T*>(crow + 4 * h); // N x opdim, live
    __shared__ S Tm[16];
    __shared__ int accept_s;
    __shared__ T acc_s;

    const int tid = threadIdx.x;
    const size_t wk = blockIdx.x;
    const size_t pan = wk * size_t(Kq) * h;
    const S* colw = colT + pan;
    const S* roww = rowp + pan;
    S* Cw = CT + pan;
    S* Rw = Rb + pan;
    const T* phi0 = phi_in + wk * N * opdim;
    const T* phin = phin_in + wk * N * opdim;
    for (int idx = tid; idx < N * opdim; idx += kThreads) phi[idx] = phi0[idx];
    if (tid == 0) acc_s = T(0);
    __syncthreads();

    for (int j = 0; j < Kc; ++j) {
        const int i = i0 + j, jq = 4 * j;
        // the site's columns and rows of the current G: panel minus the
        // chunk's earlier slots (C of a rejected slot is exactly 0)
        for (int idx = tid; idx < 4 * h; idx += kThreads) {
            const int b = idx / h, r = idx - b * h, jb = b * N + i;
            S cc = colw[(jq + b) * h + r];
            S cr = roww[(jq + b) * h + r];
            for (int k = 0; k < jq; ++k) {
                cc = csub_rn(cc, cmul_rn(Cw[k * h + r], Rw[k * h + jb]));
                cr = csub_rn(cr, cmul_rn(Cw[k * h + jb], Rw[k * h + r]));
            }
            ccol[idx] = cc;
            crow[idx] = cr;
        }
        __syncthreads();
        if (tid == 0) {
            const T live = site_live(phi, phin + i * opdim, phi0 + i * opdim,
                                     nb + 4 * i, opdim, dtau);
            S GII[16];
            for (int a = 0; a < 4; ++a)
                for (int b = 0; b < 4; ++b)
                    GII[4 * a + b] = ccol[b * h + a * N + i];
            const bool acc = site_step(GII, delta_in + (wk * N + i) * 16,
                                       lhs_in[wk * N + i], live, c_det, Tm);
            accept_s = acc;
            if (acc) {
                for (int o = 0; o < opdim; ++o) phi[i * opdim + o] = phin[i * opdim + o];
                acc_s = add_rn(acc_s, T(1));
            }
        }
        __syncthreads();
        const bool accept = accept_s;
        for (int idx = tid; idx < 4 * h; idx += kThreads) {
            const int b = idx / h, r = idx - b * h, jb = b * N + i;
            S c = mk(T(0), T(0));
            if (accept) {
                c = cmul_rn(ccol[r], Tm[b]);
                for (int a = 1; a < 4; ++a)
                    c = cadd_rn(c, cmul_rn(ccol[a * h + r], Tm[4 * a + b]));
            }
            Cw[(jq + b) * h + r] = c;
            const S g = crow[idx];
            Rw[(jq + b) * h + r] = mk(sub_rn(r == jb ? T(1) : T(0), g.re), -g.im);
        }
        __syncthreads();
    }
    for (int idx = tid; idx < N * opdim; idx += kThreads)
        phi_out[wk * N * opdim + idx] = phi[idx];
    if (tid == 0) acc_out[wk] = acc_s;
}

template <typename T>
int sdw_delayed(int device, const void* colT, const void* rowp, const void* phi,
                const void* phin, const void* lhs, const void* delta,
                const void* nb, void* CT, void* R, void* phi_out, void* acc_out,
                int W, int N, int opdim, int i0, int Kc, double dtau,
                double c_det, void* stream) {
    const size_t h = 4 * size_t(N);
    const size_t smem = sizeof(cplx<T>) * 8 * h + sizeof(T) * size_t(N) * opdim;
    return launch_smem(device, sdw_delayed_kernel<T>, W, smem, stream,
                       static_cast<const cplx<T>*>(colT),
                       static_cast<const cplx<T>*>(rowp), static_cast<const T*>(phi),
                       static_cast<const T*>(phin), static_cast<const T*>(lhs),
                       static_cast<const cplx<T>*>(delta), static_cast<const int*>(nb),
                       static_cast<cplx<T>*>(CT), static_cast<cplx<T>*>(R),
                       static_cast<T*>(phi_out), static_cast<T*>(acc_out), N, opdim,
                       i0, Kc, static_cast<T>(dtau), static_cast<T>(c_det));
}

}  // namespace dq

extern "C" {

int dq_sdw_delayed_c64(int device, const void* colT, const void* rowp,
                       const void* phi, const void* phin, const void* lhs,
                       const void* delta, const void* nb, void* CT, void* R,
                       void* phi_out, void* acc_out, int W, int N, int opdim,
                       int i0, int Kc, double dtau, double c_det, void* stream) {
    return dq::sdw_delayed<float>(device, colT, rowp, phi, phin, lhs, delta, nb,
                                  CT, R, phi_out, acc_out, W, N, opdim, i0, Kc,
                                  dtau, c_det, stream);
}

int dq_sdw_delayed_c128(int device, const void* colT, const void* rowp,
                        const void* phi, const void* phin, const void* lhs,
                        const void* delta, const void* nb, void* CT, void* R,
                        void* phi_out, void* acc_out, int W, int N, int opdim,
                        int i0, int Kc, double dtau, double c_det, void* stream) {
    return dq::sdw_delayed<double>(device, colT, rowp, phi, phin, lhs, delta,
                                   nb, CT, R, phi_out, acc_out, W, N, opdim, i0,
                                   Kc, dtau, c_det, stream);
}

}  // extern "C"
