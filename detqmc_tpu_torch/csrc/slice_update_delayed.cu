// K1b: the delayed (rank-k) Hubbard Metropolis slice update, one CTA per
// walker, for G beyond one block's shared memory.
//
// Replaces the TPU kernel detqmc_tpu/linalg/pallas_update.py
// (slice_update, make_slice_update, kernel body _kernel): walker tiles in
// the grid, the N sites in chunks of k, accepted rank-1 updates kept in
// (k, N) buffers and flushed into G by one contraction per chunk inside
// the kernel's own body. A 256 x 256 f32 G is 256 KB (512 KB in f64),
// beyond a block's 227 KB, so G stays in global memory (the output buffer
// G_out is the working copy: the CTA copies its walker's G into it first)
// and only the buffers live in dynamic shared memory:
//     U  C x k x N   slot j: the scaled effective column coef_c g_col
//     Wb C x k x N   slot j: e_i - the effective row
//     fld, uni N     the field and the uniforms of the slice
// 2 C k N + 2 N values: 34 KB at C = 1, k = 16, N = 256 in f32. Per site i
// (pallas_update.py:109-139, HubbardModel._update_slice_delayed):
//     g_col_c = G_c[:, i] + sum_{slots} U_c[slot] Wb_c[slot][i]
//     g_row_c = G_c[i, :] + sum_{slots} U_c[slot][i] Wb_c[slot]
//     delta_c = exp(-2 sgn_c alpha s_i) - 1,  R_c = 1 + delta_c (1 - g_ii)
//     R_tot   = R^2 / (1 + delta)  (C == 1, particle-hole mode) | R_0 R_1
//     accept  = u_i < |R_tot|
//     on accept: U_c[slot] = (-delta_c / R_c) g_col_c, Wb_c[slot] = e_i -
//                g_row_c, s_i -> -s_i, sign *= sign(R_tot), acc += 1
// and after every chunk of k sites G_c += sum_{slots} U_c[slot] (x)
// Wb_c[slot], each thread owning a set of G's entries. Only accepted
// sites take a slot: a rejected site's slot of the plain version is zero
// and adds exact zeros to every sum, so skipping it changes no value. The
// tail chunk of a ragged N (N % k != 0) runs its N % k sites; the plain
// version's pad slots never accept (u = +inf) and are skipped likewise.
// Column i is read with stride N from global memory, not from a kept
// transposed copy as on the TPU (pallas_update.py:31-33): a walker's G
// stays in L2 at the main shape (128 walkers x 256 KB = 32 MB of 50 MB),
// and a kept G^T would double the flush, which moves the most bytes.
// What bounds it: the N dependent site steps (three __syncthreads each,
// one strided column read from L2: each thread issues its column and row
// loads together, and the accept test reads its uniform from shared
// memory) and the flushes, N/k read-modify-write passes over G per slice,
// latency-bound: each thread keeps kUnroll of its G entries' loads in
// flight at once. Every product and sum uses
// explicitly rounded operations in the plain version's order (sums over
// the slots in slot order, the flush slot by slot), so for equal inputs
// the kernel reproduces the plain PyTorch version bit for bit up to
// exp().
#include "common.cuh"

namespace dq {

constexpr int kUnroll = 8;   // G entries per thread in flight in the flush

template <typename T>
__global__ void __launch_bounds__(kThreads)
slice_update_delayed_kernel(const T* __restrict__ G_in, const T* __restrict__ field_in,
                            const T* __restrict__ u01, const T* __restrict__ sign_in,
                            T* G_out, T* __restrict__ field_out,
                            T* __restrict__ sign_out, T* __restrict__ acc_out,
                            int C, int N, int k, T alpha) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* U = reinterpret_cast<T*>(smem_raw);   // C*k*N
    T* Wb = U + size_t(C) * k * N;           // C*k*N
    T* fld = Wb + size_t(C) * k * N;         // N
    T* uni = fld + N;                        // N
    __shared__ T coef_s[2];
    __shared__ T sign_s, acc_s;
    __shared__ int accept_s;

    const int tid = threadIdx.x;
    const size_t wk = blockIdx.x;
    const size_t NN = size_t(N) * N;
    const size_t kN = size_t(k) * N;
    T* G = G_out + wk * C * NN;
    const T* Gw = G_in + wk * C * NN;
    for (size_t base = tid; base < C * NN; base += kThreads * kUnroll) {
        T v[kUnroll];
#pragma unroll
        for (int q = 0; q < kUnroll; ++q) {
            const size_t idx = base + size_t(q) * kThreads;
            if (idx < C * NN) v[q] = Gw[idx];
        }
#pragma unroll
        for (int q = 0; q < kUnroll; ++q) {
            const size_t idx = base + size_t(q) * kThreads;
            if (idx < C * NN) G[idx] = v[q];
        }
    }
    for (int idx = tid; idx < N; idx += kThreads) {
        fld[idx] = field_in[wk * N + idx];
        uni[idx] = u01[wk * N + idx];
    }
    if (tid == 0) { sign_s = sign_in[wk]; acc_s = T(0); }
    __syncthreads();

    for (int i0 = 0; i0 < N; i0 += k) {
        const int kc = min(k, N - i0);
        int nk = 0;                          // accepted slots of this chunk
        for (int i = i0; i < i0 + kc; ++i) {
            // effective column i into U's slot nk, effective row i into
            // Wb's: entry a of both per thread, the two loads issued first
            for (int idx = tid; idx < C * N; idx += kThreads) {
                const int c = idx / N, a = idx - c * N;
                const T* Gc = G + c * NN;
                T* Uc = U + c * kN;
                T* Wc = Wb + c * kN;
                T col = Gc[size_t(a) * N + i];
                T row = Gc[size_t(i) * N + a];
                for (int s = 0; s < nk; ++s) {
                    col = add_rn(col, mul_rn(Uc[s * N + a], Wc[s * N + i]));
                    row = add_rn(row, mul_rn(Uc[s * N + i], Wc[s * N + a]));
                }
                Uc[nk * N + a] = col;
                Wc[nk * N + a] = row;
            }
            __syncthreads();
            if (tid == 0) {
                const T s_i = fld[i];
                T delta[2], R[2];
                for (int c = 0; c < C; ++c) {
                    const T sgn = c == 0 ? T(1) : T(-1);
                    const T gii = U[c * kN + nk * N + i];
                    delta[c] = sub_rn(exp_t(mul_rn(mul_rn(mul_rn(T(-2), sgn), alpha), s_i)), T(1));
                    R[c] = add_rn(T(1), mul_rn(delta[c], sub_rn(T(1), gii)));
                }
                const T rtot = C == 1 ? div_rn(mul_rn(R[0], R[0]), add_rn(T(1), delta[0]))
                                      : mul_rn(R[0], R[1]);
                const bool acc = uni[i] < abs_t(rtot);
                accept_s = acc;
                if (acc) {
                    for (int c = 0; c < C; ++c) coef_s[c] = div_rn(-delta[c], R[c]);
                    fld[i] = -s_i;
                    const T rs = rtot > T(0) ? T(1) : (rtot < T(0) ? T(-1) : T(0));
                    sign_s = mul_rn(sign_s, rs);
                    acc_s = acc_s + T(1);
                }
            }
            __syncthreads();
            if (accept_s) {                  // block-uniform
                for (int idx = tid; idx < C * N; idx += kThreads) {
                    const int c = idx / N, a = idx - c * N;
                    T* Uc = U + c * kN + nk * N;
                    T* Wc = Wb + c * kN + nk * N;
                    Uc[a] = mul_rn(coef_s[c], Uc[a]);
                    Wc[a] = a == i ? add_rn(-Wc[a], T(1)) : -Wc[a];
                }
                ++nk;
                __syncthreads();
            }
        }
        // flush: G_c += sum_slots U_c[slot] (x) Wb_c[slot], slot by slot;
        // kUnroll entries per thread at a time, their loads issued
        // together (one L2 round trip per kUnroll entries, not per entry)
        if (nk > 0) {
            for (size_t base = tid; base < C * NN; base += kThreads * kUnroll) {
                T v[kUnroll];
#pragma unroll
                for (int q = 0; q < kUnroll; ++q) {
                    const size_t idx = base + size_t(q) * kThreads;
                    if (idx < C * NN) v[q] = G[idx];
                }
#pragma unroll
                for (int q = 0; q < kUnroll; ++q) {
                    const size_t idx = base + size_t(q) * kThreads;
                    if (idx >= C * NN) break;
                    const int c = int(idx / NN);
                    const size_t r = idx - c * NN;
                    const int a = int(r / N), b = int(r - size_t(a) * N);
                    const T* Uc = U + c * kN;
                    const T* Wc = Wb + c * kN;
                    for (int s = 0; s < nk; ++s)
                        v[q] = add_rn(v[q], mul_rn(Uc[s * N + a], Wc[s * N + b]));
                    G[idx] = v[q];
                }
            }
            __syncthreads();
        }
    }

    for (int idx = tid; idx < N; idx += kThreads) field_out[wk * N + idx] = fld[idx];
    if (tid == 0) {
        sign_out[wk] = sign_s;
        acc_out[wk] = div_rn(acc_s, T(N));
    }
}

template <typename T>
int slice_update_delayed(int device, const void* G, const void* field, const void* u01,
                         const void* sign, void* G_out, void* field_out, void* sign_out,
                         void* acc_out, int W, int C, int N, int k, double alpha,
                         void* stream) {
    const size_t smem = sizeof(T) * (2 * size_t(C) * k * N + 2 * size_t(N));
    return launch_smem(device, slice_update_delayed_kernel<T>, W, smem, stream,
                       static_cast<const T*>(G), static_cast<const T*>(field),
                       static_cast<const T*>(u01), static_cast<const T*>(sign),
                       static_cast<T*>(G_out), static_cast<T*>(field_out),
                       static_cast<T*>(sign_out), static_cast<T*>(acc_out),
                       C, N, k, static_cast<T>(alpha));
}

}  // namespace dq

extern "C" {

int dq_slice_update_delayed_f32(int device, const void* G, const void* field,
                                const void* u01, const void* sign, void* G_out,
                                void* field_out, void* sign_out, void* acc_out,
                                int W, int C, int N, int k, double alpha, void* stream) {
    return dq::slice_update_delayed<float>(device, G, field, u01, sign, G_out, field_out,
                                           sign_out, acc_out, W, C, N, k, alpha, stream);
}

int dq_slice_update_delayed_f64(int device, const void* G, const void* field,
                                const void* u01, const void* sign, void* G_out,
                                void* field_out, void* sign_out, void* acc_out,
                                int W, int C, int N, int k, double alpha, void* stream) {
    return dq::slice_update_delayed<double>(device, G, field, u01, sign, G_out, field_out,
                                            sign_out, acc_out, W, C, N, k, alpha, stream);
}

}  // extern "C"
