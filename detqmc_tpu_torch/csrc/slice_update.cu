// K1: Hubbard Metropolis slice update, one CTA per walker.
//
// Replaces the TPU kernel detqmc_tpu/linalg/pallas_update_lanes.py
// (slice_update, kernel body _kernel), which keeps 128 walkers in the
// vector lanes and G in VMEM. Here one CTA holds one walker's G for all C
// spin components in shared memory (C N^2 values: 16 KB at N=64 in f32,
// 64 KB for C=2 in f64) and runs the sequential loop over the N sites
// inside the block. Per site i (pallas_update_lanes.py:17-23):
//     delta_c = exp(-2 sgn_c alpha s_i) - 1
//     R_c     = 1 + delta_c (1 - G_c[i,i])
//     R_tot   = R^2 / (1 + delta)  (C == 1, particle-hole mode) | R_0 R_1
//     accept  = u_i < |R_tot|
//     G_c    -= (delta_c / R_c) G_c[:, i] (x) (e_i - G_c[i, :])
//     s_i -> -s_i, sign *= sign(R_tot), acc += 1   (on accept)
// What bounds it: the N dependent steps, two __syncthreads each; the
// rank-1 update is N^2 shared-memory read-modify-writes over 256 threads.
// A rejected site skips the update. The ratios and the update use
// explicitly rounded operations (mul_rn/add_rn...) in the plain version's
// order, so for equal inputs the kernel reproduces the plain PyTorch
// version bit for bit up to exp(), and the accept decisions agree.
#include "common.cuh"

namespace dq {

template <typename T>
__global__ void __launch_bounds__(kThreads)
slice_update_kernel(const T* __restrict__ G_in, const T* __restrict__ field_in,
                    const T* __restrict__ u01, const T* __restrict__ sign_in,
                    T* __restrict__ G_out, T* __restrict__ field_out,
                    T* __restrict__ sign_out, T* __restrict__ acc_out,
                    int C, int N, T alpha) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* G = reinterpret_cast<T*>(smem_raw);   // C*N*N, row-major per comp
    T* u = G + C * N * N;                    // C*N: column i (pre-update)
    T* w = u + C * N;                        // C*N: e_i - row i
    T* fld = w + C * N;                      // N
    __shared__ T coef_s[2];
    __shared__ T sign_s, acc_s;
    __shared__ int accept_s;

    const int tid = threadIdx.x;
    const size_t wk = blockIdx.x;
    const int NN = N * N;
    const T* Gw = G_in + wk * C * NN;
    for (int idx = tid; idx < C * NN; idx += kThreads) G[idx] = Gw[idx];
    for (int idx = tid; idx < N; idx += kThreads) fld[idx] = field_in[wk * N + idx];
    if (tid == 0) { sign_s = sign_in[wk]; acc_s = T(0); }
    __syncthreads();

    for (int i = 0; i < N; ++i) {
        // every thread: stage column i and e_i - row i of each component
        for (int idx = tid; idx < C * N; idx += kThreads) {
            const int c = idx / N, a = idx - c * N;
            const T* Gc = G + c * NN;
            u[idx] = Gc[a * N + i];
            w[idx] = sub_rn(a == i ? T(1) : T(0), Gc[i * N + a]);
        }
        if (tid == 0) {
            const T s_i = fld[i];
            T delta[2], R[2];
            for (int c = 0; c < C; ++c) {
                const T sgn = c == 0 ? T(1) : T(-1);
                delta[c] = sub_rn(exp_t(mul_rn(mul_rn(mul_rn(T(-2), sgn), alpha), s_i)), T(1));
                R[c] = add_rn(T(1), mul_rn(delta[c], sub_rn(T(1), G[c * NN + i * N + i])));
            }
            const T rtot = C == 1 ? div_rn(mul_rn(R[0], R[0]), add_rn(T(1), delta[0]))
                                  : mul_rn(R[0], R[1]);
            const bool acc = u01[wk * N + i] < abs_t(rtot);
            accept_s = acc;
            if (acc) {
                for (int c = 0; c < C; ++c) coef_s[c] = div_rn(delta[c], R[c]);
                fld[i] = -s_i;
                const T rs = rtot > T(0) ? T(1) : (rtot < T(0) ? T(-1) : T(0));
                sign_s = mul_rn(sign_s, rs);
                acc_s = acc_s + T(1);
            }
        }
        __syncthreads();
        if (accept_s) {
            for (int idx = tid; idx < C * NN; idx += kThreads) {
                const int c = idx / NN, r = idx - c * NN;
                const int a = r / N, b = r - a * N;
                // G - (coef * u) * w, rounded as the plain version rounds
                G[idx] = sub_rn(G[idx], mul_rn(mul_rn(coef_s[c], u[c * N + a]), w[c * N + b]));
            }
        }
        __syncthreads();
    }

    T* Go = G_out + wk * C * NN;
    for (int idx = tid; idx < C * NN; idx += kThreads) Go[idx] = G[idx];
    for (int idx = tid; idx < N; idx += kThreads) field_out[wk * N + idx] = fld[idx];
    if (tid == 0) {
        sign_out[wk] = sign_s;
        acc_out[wk] = div_rn(acc_s, T(N));
    }
}

template <typename T>
int slice_update(int device, const void* G, const void* field, const void* u01,
                 const void* sign, void* G_out, void* field_out, void* sign_out,
                 void* acc_out, int W, int C, int N, double alpha, void* stream) {
    const size_t smem = sizeof(T) * (size_t(C) * N * N + 2 * size_t(C) * N + N);
    return launch_smem(device, slice_update_kernel<T>, W, smem, stream,
                       static_cast<const T*>(G), static_cast<const T*>(field),
                       static_cast<const T*>(u01), static_cast<const T*>(sign),
                       static_cast<T*>(G_out), static_cast<T*>(field_out),
                       static_cast<T*>(sign_out), static_cast<T*>(acc_out),
                       C, N, static_cast<T>(alpha));
}

}  // namespace dq

extern "C" {

int dq_slice_update_f32(int device, const void* G, const void* field,
                        const void* u01, const void* sign, void* G_out,
                        void* field_out, void* sign_out, void* acc_out,
                        int W, int C, int N, double alpha, void* stream) {
    return dq::slice_update<float>(device, G, field, u01, sign, G_out, field_out,
                                   sign_out, acc_out, W, C, N, alpha, stream);
}

int dq_slice_update_f64(int device, const void* G, const void* field,
                        const void* u01, const void* sign, void* G_out,
                        void* field_out, void* sign_out, void* acc_out,
                        int W, int C, int N, double alpha, void* stream) {
    return dq::slice_update<double>(device, G, field, u01, sign, G_out, field_out,
                                    sign_out, acc_out, W, C, N, alpha, stream);
}

}  // extern "C"
