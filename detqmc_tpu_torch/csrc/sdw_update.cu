// K4: SDW slice update (O(3), full 4x4 complex site blocks), one CTA per
// walker.
//
// Replaces the TPU kernel detqmc_tpu/linalg/pallas_sdw_update.py
// (slice_update_sdw, kernel body _kernel), which keeps 128 walkers in the
// vector lanes and G as (re, im) f32 planes in VMEM. Here one CTA holds
// one walker's complex G (h x h, h = 4N, row stride h+1: 33 KB at h=64 in
// complex64, 66 KB in complex128) in shared memory, with the live field
// slice, and walks the N sites in order. Per site i (orbital-major
// indices j_b = b N + i, pallas_sdw_update.py:197-331):
//     live  = dtau * (phi_new_i - phi_old_i) . sum_d phi[nb_d]   (live phi)
//     M     = 1 - G[j_a, j_b];   A = 1 + Delta_i M     (4 x 4 complex)
//     R, adj(A)  closed form from the 12 2x2 minors (det_adj4 below)
//     accept     = lhs_i < c_det log|R|^2 + live
//     T     = adj(A) Delta_i / R
//     G    -= sum_b (sum_a G[:, j_a] T_ab) (x) (e_{j_b} - G[j_b, :])
//     phi_i = accept ? phi_new_i : phi_old_i
// Thread 0 computes the scalar chain (sdw_site.cuh, ~700 flops); all
// threads stage the four columns and rows, form the four combined columns
// and apply the rank-4 update, one element per thread. A rejected site
// skips the update. What bounds it: the N dependent site steps, four
// __syncthreads each, the single-thread scalar chain, and the h^2
// shared-memory read-modify-write of an accepted site.
// Every product and sum is explicitly rounded (cmul_rn ...) in the plain
// PyTorch version's order (linalg/sdw_update.py), so for equal inputs the
// kernel reproduces it bit for bit up to log(), and the accept decisions
// agree.
#include "sdw_site.cuh"

namespace dq {

template <typename T>
__global__ void __launch_bounds__(kThreads)
sdw_update_kernel(const cplx<T>* __restrict__ G_in, const T* __restrict__ phi_in,
                  const T* __restrict__ phin_in, const T* __restrict__ lhs_in,
                  const cplx<T>* __restrict__ delta_in, const int* __restrict__ nb,
                  cplx<T>* __restrict__ G_out, T* __restrict__ phi_out,
                  T* __restrict__ acc_out, int N, int opdim, T dtau, T c_det) {
    using S = cplx<T>;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int h = 4 * N, ld = h + 1;
    S* G = reinterpret_cast<S*>(smem_raw);   // h x ld
    S* cols = G + h * ld;                    // 4 x h: G[:, j_b] (pre-update)
    S* rows = cols + 4 * h;                  // 4 x h: e_{j_b} - G[j_b, :]
    S* comb = rows + 4 * h;                  // 4 x h: sum_a cols_a T_ab
    T* phi = reinterpret_cast<T*>(comb + 4 * h);   // N x opdim, live
    __shared__ S Tm[16];
    __shared__ int accept_s;
    __shared__ T acc_s;

    const int tid = threadIdx.x;
    const size_t wk = blockIdx.x;
    const S* Gw = G_in + wk * h * h;
    for (int idx = tid; idx < h * h; idx += kThreads) {
        const int r = idx / h, c = idx - r * h;
        G[r * ld + c] = Gw[idx];
    }
    const T* phi0 = phi_in + wk * N * opdim;
    const T* phin = phin_in + wk * N * opdim;
    for (int idx = tid; idx < N * opdim; idx += kThreads) phi[idx] = phi0[idx];
    if (tid == 0) acc_s = T(0);
    __syncthreads();

    for (int i = 0; i < N; ++i) {
        if (tid == 0) {
            const T live = site_live(phi, phin + i * opdim, phi0 + i * opdim,
                                     nb + 4 * i, opdim, dtau);
            S GII[16];
            for (int a = 0; a < 4; ++a)
                for (int b = 0; b < 4; ++b)
                    GII[4 * a + b] = G[(a * N + i) * ld + b * N + i];
            const bool acc = site_step(GII, delta_in + (wk * N + i) * 16,
                                       lhs_in[wk * N + i], live, c_det, Tm);
            accept_s = acc;
            if (acc) {
                for (int o = 0; o < opdim; ++o) phi[i * opdim + o] = phin[i * opdim + o];
                acc_s = add_rn(acc_s, T(1));
            }
        }
        __syncthreads();
        if (accept_s) {   // block-uniform
            for (int idx = tid; idx < 4 * h; idx += kThreads) {
                const int b = idx / h, r = idx - b * h, j = b * N + i;
                cols[idx] = G[r * ld + j];
                const S g = G[j * ld + r];
                rows[idx] = mk(sub_rn(r == j ? T(1) : T(0), g.re), -g.im);
            }
            __syncthreads();
            for (int idx = tid; idx < 4 * h; idx += kThreads) {
                const int b = idx / h, r = idx - b * h;
                S acc = cmul_rn(cols[r], Tm[b]);
                for (int a = 1; a < 4; ++a)
                    acc = cadd_rn(acc, cmul_rn(cols[a * h + r], Tm[4 * a + b]));
                comb[idx] = acc;
            }
            __syncthreads();
            for (int idx = tid; idx < h * h; idx += kThreads) {
                const int r = idx / h, c = idx - r * h;
                S u = cmul_rn(comb[r], rows[c]);
                for (int b = 1; b < 4; ++b)
                    u = cadd_rn(u, cmul_rn(comb[b * h + r], rows[b * h + c]));
                G[r * ld + c] = csub_rn(G[r * ld + c], u);
            }
        }
        __syncthreads();
    }

    S* Go = G_out + wk * h * h;
    for (int idx = tid; idx < h * h; idx += kThreads) {
        const int r = idx / h, c = idx - r * h;
        Go[idx] = G[r * ld + c];
    }
    for (int idx = tid; idx < N * opdim; idx += kThreads)
        phi_out[wk * N * opdim + idx] = phi[idx];
    if (tid == 0) acc_out[wk] = acc_s;
}

template <typename T>
int sdw_update(int device, const void* G, const void* phi, const void* phin,
               const void* lhs, const void* delta, const void* nb, void* G_out,
               void* phi_out, void* acc_out, int W, int N, int opdim,
               double dtau, double c_det, void* stream) {
    const size_t h = 4 * size_t(N);
    const size_t smem = sizeof(cplx<T>) * (h * (h + 1) + 12 * h)
                        + sizeof(T) * size_t(N) * opdim;
    return launch_smem(device, sdw_update_kernel<T>, W, smem, stream,
                       static_cast<const cplx<T>*>(G), static_cast<const T*>(phi),
                       static_cast<const T*>(phin), static_cast<const T*>(lhs),
                       static_cast<const cplx<T>*>(delta), static_cast<const int*>(nb),
                       static_cast<cplx<T>*>(G_out), static_cast<T*>(phi_out),
                       static_cast<T*>(acc_out), N, opdim, static_cast<T>(dtau),
                       static_cast<T>(c_det));
}

}  // namespace dq

extern "C" {

int dq_sdw_update_c64(int device, const void* G, const void* phi,
                      const void* phin, const void* lhs, const void* delta,
                      const void* nb, void* G_out, void* phi_out, void* acc_out,
                      int W, int N, int opdim, double dtau, double c_det,
                      void* stream) {
    return dq::sdw_update<float>(device, G, phi, phin, lhs, delta, nb, G_out,
                                 phi_out, acc_out, W, N, opdim, dtau, c_det,
                                 stream);
}

int dq_sdw_update_c128(int device, const void* G, const void* phi,
                       const void* phin, const void* lhs, const void* delta,
                       const void* nb, void* G_out, void* phi_out,
                       void* acc_out, int W, int N, int opdim, double dtau,
                       double c_det, void* stream) {
    return dq::sdw_update<double>(device, G, phi, phin, lhs, delta, nb, G_out,
                                  phi_out, acc_out, W, N, opdim, dtau, c_det,
                                  stream);
}

}  // extern "C"
