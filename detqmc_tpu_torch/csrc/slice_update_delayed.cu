// K1b: the delayed (rank-k) Hubbard Metropolis slice update, one CTA per
// walker, for G beyond one block's shared memory.
//
// Replaces the TPU kernel detqmc_tpu/linalg/pallas_update.py
// (slice_update, make_slice_update, kernel body _kernel): walker tiles in
// the grid, the N sites in chunks of k, accepted rank-1 updates kept in
// (k, N) buffers and flushed into G by one contraction per chunk inside
// the kernel's own body. A 256 x 256 f32 G is 256 KB (512 KB in f64),
// beyond a block's 227 KB, so G stays in global memory (the output buffer
// G_out is the working copy: the first chunk reads G_in, and its flush
// writes G_out, so there is no separate copy pass)
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
// What bounds it (NVIDIA H100 80GB HBM3, 700 W; solve_timing.py's probe):
// the first design spent 85 % of its 2.7 ms (f32 W=128 N=256 k=16) in
// the flushes, whose every multiply-add read both operands from shared
// memory (a four-way bank conflict on one) behind a 64-bit index
// division per entry; the site steps, three barriers each with one
// thread deciding, took the rest (1.3 us per site). This design:
//   - the flush is register-tiled: each thread owns 4 x 4 tiles of G,
//     loads a slot's 4 U and 4 Wb entries once per tile as 16-byte
//     vectors and does 16 products from registers; its next tile's
//     global loads are in flight while it computes;
//   - every thread forms g_ii, the ratio and the decision itself with the
//     same operations in the same order, so all agree bit for bit and no
//     thread waits on another; a rejected site writes nothing and takes
//     no barrier; an accepted one writes its slot already scaled and
//     takes one;
//   - no global read on a site step's critical path: G does not change
//     inside a chunk, so each thread loads the column, row and diagonal
//     entries of the site two ahead into registers (a ring of two, the
//     loop unrolled by two so that the ring's slots stay registers)
//     while it decides the current one (the first sites of a chunk wait
//     for its flush).
// Every product and sum uses explicitly rounded operations in the plain
// version's order (sums over the slots in slot order, the flush slot by
// slot), so for equal inputs the kernel reproduces the plain PyTorch
// version bit for bit up to exp(), which every thread computes alike.
#include "common.cuh"

namespace dq {

// the phase probe's phases (Probe, common.cuh), mirrored by
// linalg/slice_update.py DELAYED_PROBE_PHASES (set-up: the field and the
// uniforms to shared memory; the first flush copies G_in to G_out)
enum { kGather, kDecide, kSlot, kBarrier, kFlush, kSetup, kPhases };

// A thread's flush tile of G: 4 x 4 entries (one 16-byte load per tile
// row in float32, two in float64). 4 x 8 tiles in float32 measured slower
// (NVIDIA H100 80GB HBM3, 700 W: the flush 463 against 386 us per CTA at
// W=128 N=256 k=16, solve_timing.py's probe)
constexpr int kRows = 4, kCols = 4;

// 4 consecutive entries from src + b0 (a tile row of G, or of a slot in
// shared memory): a vector load where the rows are 16-byte aligned (vec:
// N % 4 == 0), else scalar loads, those from b0 + q >= N as 0
template <typename T>
__device__ __forceinline__ void load4(T* v, const T* src, int b0, int N, bool vec) {
    if (vec) {
        if constexpr (sizeof(T) == 4) {
            const float4 x = *reinterpret_cast<const float4*>(src + b0);
            v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
        } else {
            const double2 x = *reinterpret_cast<const double2*>(src + b0);
            const double2 y = *reinterpret_cast<const double2*>(src + b0 + 2);
            v[0] = x.x; v[1] = x.y; v[2] = y.x; v[3] = y.y;
        }
    } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = b0 + q < N ? src[b0 + q] : T(0);
    }
}

template <typename T>
__device__ __forceinline__ void store4(T* dst, const T* v, int b0, int N, bool vec) {
    if (vec) {
        if constexpr (sizeof(T) == 4) {
            *reinterpret_cast<float4*>(dst + b0) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
            *reinterpret_cast<double2*>(dst + b0) = make_double2(v[0], v[1]);
            *reinterpret_cast<double2*>(dst + b0 + 2) = make_double2(v[2], v[3]);
        }
    } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
            if (b0 + q < N) dst[b0 + q] = v[q];
    }
}

// G_out_c = G_src_c + sum_{s < nk} U_c[s] (x) Wb_c[s], slot by slot, each
// entry rounded as the plain version rounds it. Thread t takes the tiles
// t, t + kThreads, ... (kRows x kCols entries, the tiles of a row band on
// neighbouring threads); the next tile's loads are issued before the
// current tile's products. nk = 0 copies.
template <typename T>
__device__ void flush(const T* Gsrc, T* Gdst, const T* U, const T* Wb, int C, int N, int k,
                      int nk) {
    const int tc = (N + kCols - 1) / kCols, per_c = tc * ((N + kRows - 1) / kRows);
    const int tiles = C * per_c;
    const bool vec = N % 4 == 0;
    const size_t NN = size_t(N) * N, kN = size_t(k) * N;
    T cur[kRows][kCols] = {}, nxt[kRows][kCols] = {};
    auto load_tile = [&](int t, T (&v)[kRows][kCols]) {
        const int c = t / per_c, r = t - c * per_c;
        const int a0 = kRows * (r / tc), b0 = kCols * (r % tc);
#pragma unroll
        for (int p = 0; p < kRows; ++p)
            if (a0 + p < N) load4(v[p], Gsrc + c * NN + size_t(a0 + p) * N, b0, N, vec);
    };
    int t = threadIdx.x;
    if (t < tiles) load_tile(t, cur);
    for (; t < tiles; t += kThreads) {
        if (t + kThreads < tiles) load_tile(t + kThreads, nxt);
        const int c = t / per_c, r = t - c * per_c;
        const int a0 = kRows * (r / tc), b0 = kCols * (r % tc);
        const T* Uc = U + c * kN;
        const T* Wc = Wb + c * kN;
        for (int s = 0; s < nk; ++s) {
            // U and Wb entries beyond N are other slots' (finite or not):
            // they meet only masked-out entries
            T u[kRows], w[kCols];
            load4(u, Uc + s * N, a0, N + kCols, vec);
            load4(w, Wc + s * N, b0, N + kCols, vec);
#pragma unroll
            for (int p = 0; p < kRows; ++p)
#pragma unroll
                for (int q = 0; q < kCols; ++q)
                    cur[p][q] = add_rn(cur[p][q], mul_rn(u[p], w[q]));
        }
#pragma unroll
        for (int p = 0; p < kRows; ++p)
            if (a0 + p < N) store4(Gdst + c * NN + size_t(a0 + p) * N, cur[p], b0, N, vec);
#pragma unroll
        for (int p = 0; p < kRows; ++p)
#pragma unroll
            for (int q = 0; q < kCols; ++q) cur[p][q] = nxt[p][q];
    }
}

// EPT: entries of the effective column and row per thread (C N <= EPT
// kThreads). Thread tid owns entries e = tid + m kThreads (component
// c = e / N, site a = e % N) of every slot.
template <typename T, int EPT, bool PROBE>
__global__ void __launch_bounds__(kThreads)
slice_update_delayed_kernel(const T* __restrict__ G_in, const T* __restrict__ field_in,
                            const T* __restrict__ u01, const T* __restrict__ sign_in,
                            T* G_out, T* __restrict__ field_out,
                            T* __restrict__ sign_out, T* __restrict__ acc_out,
                            int C, int N, int k, T alpha, long long* probe_out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* U = reinterpret_cast<T*>(smem_raw);   // C*k*N
    T* Wb = U + size_t(C) * k * N;           // C*k*N
    T* fld = Wb + size_t(C) * k * N;         // N (read only: the flips go
    T* uni = fld + N;                        // N  straight to field_out)
    Probe<PROBE, kPhases> probe;
    probe.start();

    const int tid = threadIdx.x;
    const size_t wk = blockIdx.x;
    const size_t NN = size_t(N) * N;
    const size_t kN = size_t(k) * N;
    T* G = G_out + wk * C * NN;
    const T* Gw = G_in + wk * C * NN;
    for (int idx = tid; idx < N; idx += kThreads) {
        fld[idx] = field_in[wk * N + idx];
        uni[idx] = u01[wk * N + idx];
    }
    int ce[EPT], ae[EPT];
    bool own[EPT];
#pragma unroll
    for (int m = 0; m < EPT; ++m) {
        const int e = tid + m * kThreads;
        own[m] = e < C * N;
        ce[m] = own[m] ? e / N : 0;
        ae[m] = own[m] ? e - ce[m] * N : 0;
    }
    // a site's G entries in registers: the column and row entries of the
    // owned entries, the diagonal of every component
    struct Site {
        T col[EPT], row[EPT], diag[2];
    };
    auto prefetch = [&](Site& f, const T* Gs, int i) {
#pragma unroll
        for (int m = 0; m < EPT; ++m)
            if (own[m]) {
                const T* Gc = Gs + ce[m] * NN;
                f.col[m] = Gc[size_t(ae[m]) * N + i];
                f.row[m] = Gc[size_t(i) * N + ae[m]];
            }
#pragma unroll
        for (int c = 0; c < 2; ++c)
            if (c < C) f.diag[c] = Gs[c * NN + size_t(i) * N + i];
    };
    T sign = sign_in[wk], acc_n = T(0);
    int nk = 0;                              // accepted slots of the chunk
    // site i from the entries in f, whose loads for site i + 2 (if it is
    // in the chunk ending at end) are issued first: a two-deep ring
    auto site = [&](Site& f, const T* Gs, int i, int end) {
        Site g = f;
        if (i + 2 < end) prefetch(f, Gs, i + 2);
        // every thread forms g_ii, the ratio and the decision with the
        // same operations in the same order: all agree bit for bit. The
        // effective column and row entries of its own entries go in the
        // same loop (independent chains; the slot of an accepted site
        // needs them, and most sites accept)
        for (int s = 0; s < nk; ++s) {
#pragma unroll
            for (int c = 0; c < 2; ++c)
                if (c < C)
                    g.diag[c] = add_rn(g.diag[c], mul_rn(U[c * kN + s * N + i],
                                                         Wb[c * kN + s * N + i]));
#pragma unroll
            for (int m = 0; m < EPT; ++m)
                if (own[m]) {
                    const T* Uc = U + ce[m] * kN + s * N;
                    const T* Wc = Wb + ce[m] * kN + s * N;
                    g.col[m] = add_rn(g.col[m], mul_rn(Uc[ae[m]], Wc[i]));
                    g.row[m] = add_rn(g.row[m], mul_rn(Uc[i], Wc[ae[m]]));
                }
        }
        probe.lap(kGather);
        const T s_i = fld[i];
        T delta[2] = {}, R[2] = {};
#pragma unroll
        for (int c = 0; c < 2; ++c)
            if (c < C) {
                const T sgn = c == 0 ? T(1) : T(-1);
                delta[c] = sub_rn(exp_t(mul_rn(mul_rn(mul_rn(T(-2), sgn), alpha), s_i)), T(1));
                R[c] = add_rn(T(1), mul_rn(delta[c], sub_rn(T(1), g.diag[c])));
            }
        const T rtot = C == 1 ? div_rn(mul_rn(R[0], R[0]), add_rn(T(1), delta[0]))
                              : mul_rn(R[0], R[1]);
        const bool accept = uni[i] < abs_t(rtot);
        probe.lap(kDecide);
        if (tid == 0) field_out[wk * N + i] = accept ? -s_i : s_i;
        if (!accept) return;                 // uniform: no barrier
        const T coef0 = div_rn(-delta[0], R[0]);
        const T coef1 = C == 2 ? div_rn(-delta[1], R[1]) : T(0);
        const T rs = rtot > T(0) ? T(1) : (rtot < T(0) ? T(-1) : T(0));
        sign = mul_rn(sign, rs);
        acc_n = acc_n + T(1);
        // the slot, scaled
#pragma unroll
        for (int m = 0; m < EPT; ++m)
            if (own[m]) {
                const int a = ae[m];
                U[ce[m] * kN + nk * N + a] = mul_rn(ce[m] == 0 ? coef0 : coef1, g.col[m]);
                Wb[ce[m] * kN + nk * N + a] = a == i ? add_rn(-g.row[m], T(1)) : -g.row[m];
            }
        ++nk;
        probe.lap(kSlot);
        __syncthreads();
        probe.lap(kBarrier);
    };
    probe.lap(kSetup);
    __syncthreads();
    probe.lap(kBarrier);

    Site fa = {}, fb = {};
    for (int i0 = 0; i0 < N; i0 += k) {
        const int end = min(i0 + k, N);
        const T* Gs = i0 == 0 ? Gw : G;      // the first chunk reads G_in
        nk = 0;
        prefetch(fa, Gs, i0);
        if (i0 + 1 < end) prefetch(fb, Gs, i0 + 1);
        for (int i = i0; i < end; i += 2) {
            site(fa, Gs, i, end);
            if (i + 1 < end) site(fb, Gs, i + 1, end);
        }
        // flush: the first chunk also copies G_in to G_out. A later
        // chunk's flush writes the G its sites read: every warp's loads
        // of this chunk must have landed first
        if (nk > 0 || i0 == 0) {
            if (i0 > 0) {
                __syncthreads();
                probe.lap(kBarrier);
            }
            flush(Gs, G, U, Wb, C, N, k, nk);
            probe.lap(kFlush);
            __syncthreads();
            probe.lap(kBarrier);
        }
    }

    if (tid == 0) {
        sign_out[wk] = sign;
        acc_out[wk] = div_rn(acc_n, T(N));
    }
    probe.store(probe_out);
}

template <typename T, bool PROBE>
int launch_delayed(int device, int ept, size_t smem, void* stream, const T* G,
                   const T* field, const T* u01, const T* sign, T* G_out, T* field_out,
                   T* sign_out, T* acc_out, int W, int C, int N, int k, T alpha,
                   long long* probe) {
    auto go = [&](auto kernel) {
        return launch_smem(device, kernel, W, smem, stream, G, field, u01, sign, G_out,
                           field_out, sign_out, acc_out, C, N, k, alpha, probe);
    };
    switch (ept) {
        case 1: return go(slice_update_delayed_kernel<T, 1, PROBE>);
        case 2: return go(slice_update_delayed_kernel<T, 2, PROBE>);
        case 4: return go(slice_update_delayed_kernel<T, 4, PROBE>);
        case 8: return go(slice_update_delayed_kernel<T, 8, PROBE>);
        case 16: return go(slice_update_delayed_kernel<T, 16, PROBE>);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// the entries per thread for C N entries (linalg/slice_update.py
// MAX_DELAYED_ENTRIES = 16 kThreads)
inline int delayed_ept(int C, int N) {
    for (int ept = 1; ept <= 16; ept *= 2)
        if (C * N <= ept * kThreads) return ept;
    return 0;
}

template <typename T>
int slice_update_delayed(int device, const void* G, const void* field, const void* u01,
                         const void* sign, void* G_out, void* field_out, void* sign_out,
                         void* acc_out, int W, int C, int N, int k, double alpha,
                         void* stream, long long* probe = nullptr) {
    const size_t smem = sizeof(T) * (2 * size_t(C) * k * N + 2 * size_t(N));
    const int ept = delayed_ept(C, N);
    auto args = [&](auto launch) {
        return launch(device, ept, smem, stream, static_cast<const T*>(G),
                      static_cast<const T*>(field), static_cast<const T*>(u01),
                      static_cast<const T*>(sign), static_cast<T*>(G_out),
                      static_cast<T*>(field_out), static_cast<T*>(sign_out),
                      static_cast<T*>(acc_out), W, C, N, k, static_cast<T>(alpha), probe);
    };
    return probe ? args(launch_delayed<T, true>) : args(launch_delayed<T, false>);
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

// the same with the phase probe on: probe (W x 8 int64) gets each CTA's
// cycles per phase (gather, decision, slot write, barriers, flush, copy),
// its total cycles and its total ns
int dq_slice_update_delayed_probe_f32(int device, const void* G, const void* field,
                                      const void* u01, const void* sign, void* G_out,
                                      void* field_out, void* sign_out, void* acc_out,
                                      int W, int C, int N, int k, double alpha,
                                      void* probe, void* stream) {
    return dq::slice_update_delayed<float>(device, G, field, u01, sign, G_out, field_out,
                                           sign_out, acc_out, W, C, N, k, alpha, stream,
                                           static_cast<long long*>(probe));
}

int dq_slice_update_delayed_probe_f64(int device, const void* G, const void* field,
                                      const void* u01, const void* sign, void* G_out,
                                      void* field_out, void* sign_out, void* acc_out,
                                      int W, int C, int N, int k, double alpha,
                                      void* probe, void* stream) {
    return dq::slice_update_delayed<double>(device, G, field, u01, sign, G_out, field_out,
                                            sign_out, acc_out, W, C, N, k, alpha, stream,
                                            static_cast<long long*>(probe));
}

}  // extern "C"
