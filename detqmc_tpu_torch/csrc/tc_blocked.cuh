// Device code of the Hopper redesign of K8 (green_solve_big.cu) and K9
// (trinv_big.cu): FP64 tensor-core products held in registers, cp.async
// tile loads, and a blocked Householder QR whose shared memory fits twice
// on an SM. K7 (qr_big.cu) does not use it yet: K7 runs
// householder_blocked (common.cuh), whose products are one output per
// thread with both operands read from shared memory.
//
// ---- the FP64 tensor-core product -----------------------------------------
// Hopper has no f64 wgmma; its FP64 tensor cores are reached by
// mma.sync.m8n8k4 with .f64 operands. PTX ISA fragment layout, with lane =
// threadIdx.x % 32, g = lane >> 2 and q = lane & 3:
//     A (8 x 4, row-major)   a  = A[g][q]
//     B (4 x 8, col-major)   b  = B[q][g]
//     C, D (8 x 8)           c0 = C[g][2q],  c1 = C[g][2q + 1]
// A complex128 product is four real ones on the real and imaginary parts
// of the same 16-byte operands (Re = ar br - ai bi, Im = ar bi + ai br):
// Gauss's three-product form saves a quarter of the products but adds
// operands (ar + ai, br + bi) whose rounding is relative to the sum, not
// to each part, and the backward-error gate (1e-13) is what the chain
// needs; the FP64 pipe is not the bound of these kernels (their note).
//
// Shared-memory rows of an mma operand have a stride ld = w + pad(S) with
// ld = 4 (mod 8) doubles: then both access patterns, a[g][q] (rows g) and
// a[q][g] (rows q), hit 16 distinct 8-byte bank pairs in each half-warp.
// For complex128 (16-byte elements, quarter-warp phases) ld = 2 (mod 8)
// keeps a[q][g] free of conflicts and a[g][q] at two-way.
#pragma once

#include "common.cuh"

namespace dq {

template <typename S> struct pad_of { static constexpr int value = 4; };
template <> struct pad_of<cplx<float>> { static constexpr int value = 4; };
template <> struct pad_of<cplx<double>> { static constexpr int value = 2; };

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

__device__ __forceinline__ void mma884(double& d0, double& d1, double a, double b) {
#if defined(__CUDA_ARCH__)
    asm volatile(
        "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, "
        "{%0, %1};\n"
        : "+d"(d0), "+d"(d1)
        : "d"(a), "d"(b));
#elif defined(DQ_HOST_EMULATION)
    host_mma884(d0, d1, a, b);   // a C++ stand-in with the same lane mapping
#endif
}

// an 8 x 8 accumulator fragment: this lane's C[g][2q], C[g][2q + 1]
template <typename S>
struct Acc {
    S c[2];
};

__device__ __forceinline__ void mma_acc(Acc<double>& d, double a, double b) {
    mma884(d.c[0], d.c[1], a, b);
}
__device__ __forceinline__ void mma_acc(Acc<cplx<double>>& d, cplx<double> a,
                                        cplx<double> b) {
    mma884(d.c[0].re, d.c[1].re, a.re, b.re);
    mma884(d.c[0].re, d.c[1].re, -a.im, b.im);
    mma884(d.c[0].im, d.c[1].im, a.re, b.im);
    mma884(d.c[0].im, d.c[1].im, a.im, b.re);
}

template <typename S>
__device__ __forceinline__ Acc<S> acc_zero() {
    using R = typename real_of<S>::type;
    return Acc<S>{{from_real<S>(R(0)), from_real<S>(R(0))}};
}

// ---- asynchronous copies global -> shared ---------------------------------
__device__ __forceinline__ void cp_async(double* dst, const double* src) {
#if defined(__CUDA_ARCH__)
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
#else
    *dst = *src;
#endif
}
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
#if defined(__CUDA_ARCH__)
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
#else
    *dst = *src;
#endif
}
__device__ __forceinline__ void cp_async(cplx<float>* dst, const cplx<float>* src) {
#if defined(__CUDA_ARCH__)
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
#else
    *dst = *src;
#endif
}
__device__ __forceinline__ void cp_async(cplx<double>* dst, const cplx<double>* src) {
#if defined(__CUDA_ARCH__)
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
#else
    *dst = *src;
#endif
}
__device__ __forceinline__ void cp_async_commit() {
#if defined(__CUDA_ARCH__)
    asm volatile("cp.async.commit_group;\n" ::);
#endif
}
// wait for every group this thread committed (a __syncthreads must follow
// before other threads read the data)
__device__ __forceinline__ void cp_async_wait_all() {
#if defined(__CUDA_ARCH__)
    asm volatile("cp.async.wait_group 0;\n" ::);
#endif
}

// ---- V^H M on the tensor cores, split over the CTA's warps ----------------
// part[s][i][c] = sum over the rows r of k-slice s of conj(V[r][i]) M[r][c]
// for i < BP, c < w (V: ldv, M: ldm, rows 0..mr, mr a multiple of 4; rows
// beyond the data must be zero in V or in M). The (BP/8) (w/8) output
// fragments go one per warp when there are at least 8 of them (ks = 1),
// else the rows split into ks = 8 / fragments slices and part holds ks
// partial sums; the caller adds them. Each warp keeps its fragment in
// registers through the whole k-loop (two accumulators, even and odd
// k-steps, for two independent chains) and writes it once.
__host__ __device__ constexpr int vh_slices(int bp, int w) {
    return (bp / 8) * (w / 8) >= 8 ? 1 : 8 / ((bp / 8) * (w / 8));
}

template <typename S, int BP, int W>
__device__ void vh_product(const S* V, int ldv, const S* M, int ldm, int mr, S* part,
                           int ldp) {
    constexpr int FC = W / 8, F = (BP / 8) * FC, KS = vh_slices(BP, W);
    constexpr int FPW = F >= 8 ? F / 8 : 1;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, q = lane & 3;
    const int slice = F >= 8 ? 0 : warp / F;
    const int chunk = round_up((mr + KS - 1) / KS, 4);
    const int kb = slice * chunk, ke = min(mr, kb + chunk);
#pragma unroll
    for (int u = 0; u < FPW; ++u) {
        const int f = F >= 8 ? warp + 8 * u : warp % F;
        const int i0 = 8 * (f / FC), c0 = 8 * (f % FC);
        Acc<S> acc[2] = {acc_zero<S>(), acc_zero<S>()};
        int k = kb;
        for (; k + 8 <= ke; k += 8) {
            mma_acc(acc[0], conj_(V[(k + q) * ldv + i0 + g]), M[(k + q) * ldm + c0 + g]);
            mma_acc(acc[1], conj_(V[(k + 4 + q) * ldv + i0 + g]),
                    M[(k + 4 + q) * ldm + c0 + g]);
        }
        if (k < ke)
            mma_acc(acc[0], conj_(V[(k + q) * ldv + i0 + g]), M[(k + q) * ldm + c0 + g]);
        S* out = part + size_t(slice) * BP * ldp + (i0 + g) * ldp + c0 + 2 * q;
        out[0] = acc[0].c[0] + acc[1].c[0];
        out[1] = acc[0].c[1] + acc[1].c[1];
    }
}

// ---- K8's factorization: blocked Householder QR on the tensor cores -------
// Shared memory (elements of S unless noted; np = n rounded up to 8, pad =
// pad_of<S>):
//     V      np x (BP + pad)         the panel's reflectors
//     X      nbuf x np x (TC + pad)  column tiles (nbuf = 2: double buffer);
//                                    first the panel, np x (BP + 1), so
//                                    nbuf (TC + pad) >= BP + 1
//     part   max(ks(BP, TC) BP (TC + pad), ks(BP, BP) BP (BP + pad))
//     Y      BP x (TC + pad)         -T^H V^H X of the tile
//     T      BP x BP                 the compact-WY factor
//     vhead, alpha, s  BP each;  beta  BP (real)
// tc_smem_bytes is mirrored by linalg/green_solve.py big_smem_bytes.
template <typename S>
struct TcSmem {
    S *V, *X, *part, *Y, *T, *vhead, *alpha, *s;
    typename real_of<S>::type* beta;
};

template <typename S>
__host__ __device__ inline size_t tc_smem_elems(int n, int bp, int tc, int nbuf) {
    const size_t np = round_up(n, 8), pad = pad_of<S>::value;
    const size_t partw = size_t(vh_slices(bp, tc)) * bp * (tc + pad);
    const size_t parts = size_t(vh_slices(bp, bp)) * bp * (bp + pad);
    return np * (bp + pad) + nbuf * np * (tc + pad) + (partw > parts ? partw : parts)
           + size_t(bp) * (tc + pad) + size_t(bp) * bp + 3 * size_t(bp);
}

template <typename S>
__host__ __device__ inline size_t tc_smem_bytes(int n, int bp, int tc, int nbuf) {
    return sizeof(S) * tc_smem_elems<S>(n, bp, tc, nbuf)
           + sizeof(typename real_of<S>::type) * size_t(bp);
}

template <typename S>
__device__ TcSmem<S> tc_smem(unsigned char* raw, int n, int bp, int tc, int nbuf) {
    const int np = round_up(n, 8), pad = pad_of<S>::value;
    const int partw = vh_slices(bp, tc) * bp * (tc + pad);
    const int parts = vh_slices(bp, bp) * bp * (bp + pad);
    TcSmem<S> sm;
    sm.V = reinterpret_cast<S*>(raw);
    sm.X = sm.V + np * (bp + pad);
    sm.part = sm.X + nbuf * np * (tc + pad);
    sm.Y = sm.part + (partw > parts ? partw : parts);
    sm.T = sm.Y + bp * (tc + pad);
    sm.vhead = sm.T + bp * bp;
    sm.alpha = sm.vhead + bp;
    sm.s = sm.alpha + bp;
    sm.beta = reinterpret_cast<typename real_of<S>::type*>(sm.s + bp);
    return sm;
}

// Blocked Householder QR of the n x n matrix in A_in (global, row-major,
// stride n), every reflector applied to the companion in C_in as it goes:
//     on exit  A = R  (upper triangle, R_jj = alpha_j of householder_alpha;
//              strict lower triangle exactly zero),  C = Q^H C_in.
// The first panel reads A_in and C_in, every later one A and C (A_in may
// be A, C_in may be C). The reflectors are those of householder_apply
// (common.cuh) up to rounding. Per panel of BP columns at j0 (mp = n - j0
// rows):
//   1. the panel in shared memory, column by column, two barriers a
//      column: every warp forms ||x|| itself (the same sum in the same
//      order, so all agree bitwise), alpha and beta = 2 / v^H v with
//      v^H v = 2 ||x|| (||x|| + |x_0|), and its share of the products
//      x^H a_c; s_c = beta (x^H a_c - conj(alpha) a_c[0]) is v^H a_c
//      times beta (v = x - alpha e_0); then the rank-1 update of the
//      panel's trailing columns, v's head kept apart until it lands;
//   2. R's panel rows to A (strict lower part 0); V keeps the reflectors;
//   3. SV = V^H V on the tensor cores, then T row by row (lane r of warp
//      0): T_rr = beta_r, T_ri = -beta_i sum_{r <= k < i} T_rk SV_ki;
//   4. every tile of TC columns (A's trailing columns, then all of C's),
//      rows j0..n: X <- X - V (T^H (V^H X)), with the next tile's cp.async
//      copy in flight (nbuf = 2). V^H X and V (-Y) + X are register-tiled
//      tensor-core products; the result goes from registers to global
//      memory. Rows beyond mp and columns beyond the panel are zero in V,
//      so ragged n, panels and tiles need no masks inside the products.
template <typename S, int BP, int TC>
__device__ void householder_tc(const S* A_in, S* A, const S* C_in, S* C, int n,
                               int nbuf, const TcSmem<S>& sm) {
    using R = typename real_of<S>::type;
    constexpr int PAD = pad_of<S>::value, LDV = BP + PAD, LDX = TC + PAD;
    constexpr int LDT = TC + PAD, LDS = BP + PAD, LDP = BP + 1, CF = TC / 8;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, q = lane & 3;
    const int np = round_up(n, 8);
    const S zero = from_real<S>(R(0));
    S *V = sm.V, *T = sm.T, *Y = sm.Y;
    // stale rows of a tile buffer must be finite: they meet V's zero rows
    for (int idx = tid; idx < nbuf * np * LDX; idx += kThreads) sm.X[idx] = zero;
    __syncthreads();
    for (int j0 = 0; j0 < n; j0 += BP) {
        const int bw = min(BP, n - j0), mp = n - j0;
        const int mr4 = round_up(mp, 4), mr8 = round_up(mp, 8);
        const S* Asrc = j0 == 0 ? A_in : A;
        const S* Csrc = j0 == 0 ? C_in : C;
        // the panel is factored in the tile buffers with an odd row stride
        // (its column walks then hit distinct banks), then copied to V
        S* P = sm.X;
        for (int idx = tid; idx < mp * bw; idx += kThreads) {
            const int r = idx / bw, c = idx - r * bw;
            P[r * LDP + c] = Asrc[size_t(j0 + r) * n + j0 + c];
        }
        __syncthreads();
        // 1. the panel
        for (int jj = 0; jj < bw; ++jj) {
            R p = 0;
            for (int k = jj + lane; k < mp; k += 32) p += abs2(P[k * LDP + jj]);
            const R norm = sqrt_t(warp_sum(p));
            const S x0 = P[jj * LDP + jj];
            const S alpha = householder_alpha(x0, norm);
            const R vtv = R(2) * norm * (norm + sqrt_t(abs2(x0)));
            // a zero column (v == 0) leaves everything unchanged
            const R beta = R(2) / (vtv == R(0) ? R(1) : vtv);
            const S vh = x0 - alpha;
            for (int c = jj + 1 + warp; c < bw; c += kWarps) {
                S d = zero;
                for (int k = jj + 1 + lane; k < mp; k += 32)
                    d += conj_(P[k * LDP + jj]) * P[k * LDP + c];
                d = warp_sum(d);
                if (lane == 0) sm.s[c] = beta * (d + conj_(vh) * P[jj * LDP + c]);
            }
            if (tid == 0) {
                sm.alpha[jj] = alpha;
                sm.beta[jj] = beta;
                sm.vhead[jj] = vh;
            }
            __syncthreads();
            const int na = bw - jj - 1;
            for (int idx = tid; idx < (mp - jj) * na; idx += kThreads) {
                const int k = jj + idx / na, c = jj + 1 + idx % na;
                const S vk = k == jj ? sm.vhead[jj] : P[k * LDP + jj];
                P[k * LDP + c] -= vk * sm.s[c];
            }
            if (tid == 0) P[jj * LDP + jj] = sm.vhead[jj];
            __syncthreads();
        }
        // 2. R's panel rows to A (strict lower part 0); V = the reflectors,
        //    zero above the diagonal, beyond bw columns and beyond mp rows
        for (int idx = tid; idx < np * LDV; idx += kThreads) {
            const int r = idx / LDV, c = idx - r * LDV;
            const bool in = r < mp && c < bw;
            const S val = in ? P[r * LDP + c] : zero;
            V[idx] = r < c ? zero : val;
            if (in) A[size_t(j0 + r) * n + j0 + c] = r < c ? val : r == c ? sm.alpha[c] : zero;
        }
        __syncthreads();
        // 3. SV = V^H V (partial sums over k-slices), then T
        vh_product<S, BP, BP>(V, LDV, V, LDV, mr4, sm.part, LDS);
        __syncthreads();
        if (warp == 0) {
            constexpr int KSS = vh_slices(BP, BP);
            const int r = lane;
            if (r < BP) {
                for (int i = 0; i < BP; ++i) T[r * BP + i] = zero;
                if (r < bw) {
                    T[r * BP + r] = from_real<S>(sm.beta[r]);
                    for (int i = r + 1; i < bw; ++i) {
                        S acc = zero;
                        for (int k = r; k < i; ++k) {
                            S sv = zero;
                            for (int sl = 0; sl < KSS; ++sl)
                                sv += sm.part[sl * BP * LDS + k * LDS + i];
                            acc += T[r * BP + k] * sv;
                        }
                        T[r * BP + i] = (-sm.beta[i]) * acc;
                    }
                }
            }
        }
        // 4. the tiles
        const int ta = (n - j0 - bw + TC - 1) / TC, nt = ta + (n + TC - 1) / TC;
        auto tile_of = [&](int t, S*& M, const S*& Msrc, int& c0, int& tw) {
            M = t < ta ? A : C;
            Msrc = t < ta ? Asrc : Csrc;
            c0 = t < ta ? j0 + bw + t * TC : (t - ta) * TC;
            tw = min(TC, n - c0);
        };
        auto issue = [&](int t, int buf) {
            S* M;
            const S* Msrc;
            int c0, tw;
            tile_of(t, M, Msrc, c0, tw);
            S* Xb = sm.X + size_t(buf) * np * LDX;
            for (int idx = tid; idx < mp * tw; idx += kThreads) {
                const int r = idx / tw, c = idx - r * tw;
                cp_async(Xb + r * LDX + c, Msrc + size_t(j0 + r) * n + c0 + c);
            }
            cp_async_commit();
        };
        if (nt > 0) issue(0, 0);
        for (int t = 0; t < nt; ++t) {
            const int buf = nbuf == 2 ? (t & 1) : 0;
            if (nbuf == 1 && t > 0) {
                __syncthreads();   // every warp is done with tile t - 1
                issue(t, 0);
            }
            cp_async_wait_all();
            __syncthreads();       // tile t landed; tile t - 1 is done
            if (nbuf == 2 && t + 1 < nt) issue(t + 1, (t + 1) & 1);
            S* M;
            const S* Msrc;
            int c0, tw;
            tile_of(t, M, Msrc, c0, tw);
            const S* Xb = sm.X + size_t(buf) * np * LDX;
            // W = V^H X, partial sums over k-slices
            vh_product<S, BP, TC>(V, LDV, Xb, LDX, mr4, sm.part, LDT);
            __syncthreads();
            // Y = -T^H W
            constexpr int KSW = vh_slices(BP, TC);
            for (int idx = tid; idx < BP * TC; idx += kThreads) {
                const int i = idx / TC, c = idx - i * TC;
                S acc = zero;
                for (int k = 0; k <= i; ++k) {
                    S w = zero;
                    for (int sl = 0; sl < KSW; ++sl) w += sm.part[sl * BP * LDT + k * LDT + c];
                    acc += conj_(T[k * BP + i]) * w;
                }
                Y[i * LDT + c] = -acc;
            }
            __syncthreads();
            // X + V Y, row fragments warp, warp + 8, ..., straight to M
            for (int f = warp; f < mr8 / 8; f += kWarps) {
                const int r0 = 8 * f;
                Acc<S> acc[CF];
#pragma unroll
                for (int cf = 0; cf < CF; ++cf) {
                    acc[cf].c[0] = Xb[(r0 + g) * LDX + 8 * cf + 2 * q];
                    acc[cf].c[1] = Xb[(r0 + g) * LDX + 8 * cf + 2 * q + 1];
                }
#pragma unroll
                for (int k = 0; k < BP; k += 4) {
                    const S a = V[(r0 + g) * LDV + k + q];
#pragma unroll
                    for (int cf = 0; cf < CF; ++cf)
                        mma_acc(acc[cf], a, Y[(k + q) * LDT + 8 * cf + g]);
                }
                const int r = r0 + g;
                if (r < mp) {
#pragma unroll
                    for (int cf = 0; cf < CF; ++cf)
#pragma unroll
                        for (int j = 0; j < 2; ++j) {
                            const int c = 8 * cf + 2 * q + j;
                            if (c < tw) M[size_t(j0 + r) * n + c0 + c] = acc[cf].c[j];
                        }
                }
            }
        }
        __syncthreads();   // the panel's tiles are in global memory
    }
}

// Launch `kernel` (grid x kThreads) with `smem` bytes of dynamic shared
// memory, asking for the largest shared-memory carveout so that two CTAs
// whose smem fits 113 KB each share an SM. Returns cudaGetLastError().
template <typename Kernel, typename... Args>
int launch_tc(int device, Kernel kernel, int grid, size_t smem, void* stream,
              Args... args) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const void* fn = reinterpret_cast<const void*>(kernel);
    err = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    return launch_smem(device, kernel, grid, smem, stream, args...);
}

// CTAs of `kernel` one SM holds at `smem` bytes (after the attributes that
// launch_tc sets), or -(cudaError) on a failure.
template <typename Kernel>
int blocks_per_sm(int device, Kernel kernel, size_t smem) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return -static_cast<int>(err);
    const void* fn = reinterpret_cast<const void*>(kernel);
    err = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem));
    int blocks = 0;
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads, smem);
    return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

}  // namespace dq
