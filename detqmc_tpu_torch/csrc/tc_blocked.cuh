// Device code of the Hopper designs of K7 (qr_big.cu), K8
// (green_solve_big.cu) and K9 (trinv_big.cu): FP64 tensor-core products
// held in registers, register-tiled FP32 products on the CUDA cores,
// cp.async tile loads, and a blocked Householder QR (householder_tc) whose
// shared memory fits twice on an SM in float64. K8 runs it with M = diag(r1)
// or a dense right-hand side as the companion; K7 without one, keeping the
// reflectors to form Q afterwards (apply_reflectors both times).
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

#include <type_traits>

#include "common.cuh"

namespace dq {

template <typename S> struct pad_of { static constexpr int value = 4; };
template <> struct pad_of<cplx<float>> { static constexpr int value = 4; };
template <> struct pad_of<cplx<double>> { static constexpr int value = 2; };

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// float64 and complex128 products run on the FP64 tensor cores; float32 and
// complex64 ones on the CUDA cores' FP32 pipe (no TF32: one TF32 pass loses
// the float32 tolerances)
template <typename S>
__host__ __device__ constexpr bool on_tensor_cores() {
    return std::is_same<S, double>::value || std::is_same<S, cplx<double>>::value;
}

// acc += a b and acc += conj(a) b as fused multiply-adds (four for a complex
// product), for the register-tiled FP32 products
__device__ __forceinline__ void mac(float& acc, float a, float b) { acc = fmaf(a, b, acc); }
__device__ __forceinline__ void mac(cplx<float>& acc, cplx<float> a, cplx<float> b) {
    acc.re = fmaf(a.re, b.re, acc.re);
    acc.re = fmaf(-a.im, b.im, acc.re);
    acc.im = fmaf(a.re, b.im, acc.im);
    acc.im = fmaf(a.im, b.re, acc.im);
}
__device__ __forceinline__ void mac_conj(float& acc, float a, float b) { acc = fmaf(a, b, acc); }
__device__ __forceinline__ void mac_conj(cplx<float>& acc, cplx<float> a, cplx<float> b) {
    acc.re = fmaf(a.re, b.re, acc.re);
    acc.re = fmaf(a.im, b.im, acc.re);
    acc.im = fmaf(a.re, b.im, acc.im);
    acc.im = fmaf(-a.im, b.re, acc.im);
}

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

// ---- vector loads from shared memory (16-byte aligned) --------------------
// four consecutive values
__device__ __forceinline__ void load4(const float* p, float* v) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
}
__device__ __forceinline__ void load4(const double* p, double* v) {
    const double2 a = reinterpret_cast<const double2*>(p)[0];
    const double2 b = reinterpret_cast<const double2*>(p)[1];
    v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}
__device__ __forceinline__ void load4(const cplx<float>* p, cplx<float>* v) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = mk(a.x, a.y), v[1] = mk(a.z, a.w), v[2] = mk(b.x, b.y), v[3] = mk(b.z, b.w);
}
__device__ __forceinline__ void load4(const cplx<double>* p, cplx<double>* v) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const double2 a = reinterpret_cast<const double2*>(p)[i];
        v[i] = mk(a.x, a.y);
    }
}
// two consecutive values (8-byte aligned for float, 16 for complex64)
__device__ __forceinline__ void load2(const float* p, float* v) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x, v[1] = a.y;
}
__device__ __forceinline__ void load2(const cplx<float>* p, cplx<float>* v) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = mk(a.x, a.y), v[1] = mk(a.z, a.w);
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
// 16 bytes (16-byte aligned at both ends)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
#if defined(__CUDA_ARCH__)
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
#else
    *static_cast<uint4*>(dst) = *static_cast<const uint4*>(src);
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

// The FP32 product on the CUDA cores: a 4 x 2 block of (i, c) per thread,
// its 8 accumulators in registers through the k-loop, the rows split into
// fma_slices k-slices so that every thread has a block (at most 8 slices)
__host__ __device__ constexpr int fma_slices(int bp, int w) {
    return 2048 / (bp * w) > 8 ? 8 : 2048 / (bp * w) < 1 ? 1 : 2048 / (bp * w);
}

template <typename S>
__host__ __device__ constexpr int slices_of(int bp, int w) {
    return on_tensor_cores<S>() ? vh_slices(bp, w) : fma_slices(bp, w);
}

template <typename S, int BP, int W>
__device__ void vh_product_fma(const S* V, int ldv, const S* M, int ldm, int mr, S* part,
                               int ldp) {
    using R = typename real_of<S>::type;
    constexpr int KS = fma_slices(BP, W), TPS = kThreads / KS, CB = W / 2;
    constexpr int NB = (BP / 4) * CB;
    const int slice = threadIdx.x / TPS;
    const int chunk = (mr + KS - 1) / KS;
    const int kb = slice * chunk, ke = min(mr, kb + chunk);
    for (int blk = threadIdx.x % TPS; blk < NB; blk += TPS) {
        const int i0 = 4 * (blk / CB), c0 = 2 * (blk % CB);
        S acc[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = from_real<S>(R(0));
#pragma unroll 4
        for (int k = kb; k < ke; ++k) {
            S m[2], v[4];
            load2(M + k * ldm + c0, m);
            load4(V + k * ldv + i0, v);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                mac_conj(acc[i][0], v[i], m[0]);
                mac_conj(acc[i][1], v[i], m[1]);
            }
        }
        S* out = part + size_t(slice) * BP * ldp;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            out[(i0 + i) * ldp + c0] = acc[i][0];
            out[(i0 + i) * ldp + c0 + 1] = acc[i][1];
        }
    }
}

template <typename S, int BP, int W>
__device__ void vh_product_tc(const S* V, int ldv, const S* M, int ldm, int mr, S* part,
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

// part[s][i][c] = sum over the rows r of k-slice s (slices_of<S>(BP, W) of
// them) of conj(V[r][i]) M[r][c]: on the tensor cores or the FP32 pipe
template <typename S, int BP, int W>
__device__ void vh_product(const S* V, int ldv, const S* M, int ldm, int mr, S* part,
                           int ldp) {
    if constexpr (on_tensor_cores<S>())
        vh_product_tc<S, BP, W>(V, ldv, M, ldm, mr, part, ldp);
    else
        vh_product_fma<S, BP, W>(V, ldv, M, ldm, mr, part, ldp);
}

// Y = -op(T) W on the tensor cores, op(T) = T^H (HERM) or T: T (BP x BP,
// stride BP) upper triangular, W the k-slices of V^H X in part (stride
// TC + pad); one 8 x 8 fragment of Y (stride TC + pad) per warp
template <typename S, int BP, int TC, bool HERM>
__device__ void ty_product_tc(const S* T, const S* part, S* Y) {
    constexpr int LDT = TC + pad_of<S>::value, FC = TC / 8, F = (BP / 8) * FC;
    constexpr int KSW = vh_slices(BP, TC);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, q = lane & 3;
    for (int f = warp; f < F; f += kWarps) {
        const int i0 = 8 * (f / FC), c0 = 8 * (f % FC);
        Acc<S> acc = acc_zero<S>();
        for (int sl = 0; sl < KSW; ++sl) {
            const S* W = part + size_t(sl) * BP * LDT;
#pragma unroll
            for (int k = 0; k < BP; k += 4)
                mma_acc(acc, HERM ? conj_(T[(k + q) * BP + i0 + g]) : T[(i0 + g) * BP + k + q],
                        W[(k + q) * LDT + c0 + g]);
        }
        S* out = Y + (i0 + g) * LDT + c0 + 2 * q;
        out[0] = -acc.c[0];
        out[1] = -acc.c[1];
    }
}

// M[j0 + r][c0 + c] = X[r][c] + sum_k V[r][k] Y[k][c] for r < mp, c < tw
// (V: LDV, X, Y: TC + pad), rows beyond mp zero in V
template <typename S, int BP, int TC>
__device__ void add_v_times_tc(const S* V, const S* Y, const S* Xb, S* M, int n, int j0,
                               int c0, int tw, int mp) {
    constexpr int PAD = pad_of<S>::value, LDV = BP + PAD, LDX = TC + PAD, CF = TC / 8;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, q = lane & 3;
    // row fragments warp, warp + 8, ..., straight to M
    for (int f = warp; f < round_up(mp, 8) / 8; f += kWarps) {
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
                mma_acc(acc[cf], a, Y[(k + q) * LDX + 8 * cf + g]);
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

// the same on the FP32 pipe: a 4 x 4 block of (r, c) per thread
template <typename S, int BP, int TC>
__device__ void add_v_times_fma(const S* V, const S* Y, const S* Xb, S* M, int n, int j0,
                                int c0, int tw, int mp) {
    constexpr int PAD = pad_of<S>::value, LDV = BP + PAD, LDX = TC + PAD, CG = TC / 4;
    const int nblk = round_up(mp, 4) / 4 * CG;
    for (int blk = threadIdx.x; blk < nblk; blk += kThreads) {
        const int r0 = 4 * (blk / CG), cc = 4 * (blk % CG);
        S acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) load4(Xb + (r0 + i) * LDX + cc, acc[i]);
#pragma unroll 4
        for (int k = 0; k < BP; ++k) {
            S y[4];
            load4(Y + k * LDX + cc, y);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const S v = V[(r0 + i) * LDV + k];
#pragma unroll
                for (int j = 0; j < 4; ++j) mac(acc[i][j], v, y[j]);
            }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int r = r0 + i;
            if (r >= mp) continue;
#pragma unroll
            for (int j = 0; j < 4; ++j)
                if (cc + j < tw) M[size_t(j0 + r) * n + c0 + cc + j] = acc[i][j];
        }
    }
}

// ---- blocked Householder QR with a companion (K7, K8) ----------------------
// Shared memory (elements of S unless noted; np = n rounded up to 8, pad =
// pad_of<S>, ks(b, w) = slices_of<S>(b, w)):
//     V      np x (BP + pad)         the panel's reflectors
//     X      nbuf x np x (TC + pad)  column tiles (nbuf = 2: double buffer);
//                                    first the panel, np x (BP + 1), so
//                                    nbuf (TC + pad) >= BP + 1
//     part   max(ks(BP, TC) BP (TC + pad), ks(BP, BP) BP (BP + pad))
//     Y      BP x (TC + pad)         -T^H V^H X of the tile
//     T      BP x BP                 the compact-WY factor
//     vhead, alpha, s  BP each;  beta  BP (real)
// tc_smem_bytes is mirrored by linalg/qr.py tc_smem_bytes.
template <typename S>
struct TcSmem {
    S *V, *X, *part, *Y, *T, *vhead, *alpha, *s;
    typename real_of<S>::type* beta;
};

template <typename S>
__host__ __device__ inline size_t tc_part_elems(int bp, int tc) {
    const size_t pad = pad_of<S>::value;
    const size_t partw = size_t(slices_of<S>(bp, tc)) * bp * (tc + pad);
    const size_t parts = size_t(slices_of<S>(bp, bp)) * bp * (bp + pad);
    return partw > parts ? partw : parts;
}

template <typename S>
__host__ __device__ inline size_t tc_smem_elems(int n, int bp, int tc, int nbuf) {
    const size_t np = round_up(n, 8), pad = pad_of<S>::value;
    return np * (bp + pad) + nbuf * np * (tc + pad) + tc_part_elems<S>(bp, tc)
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
    TcSmem<S> sm;
    sm.V = reinterpret_cast<S*>(raw);
    sm.X = sm.V + np * (bp + pad);
    sm.part = sm.X + nbuf * np * (tc + pad);
    sm.Y = sm.part + tc_part_elems<S>(bp, tc);
    sm.T = sm.Y + bp * (tc + pad);
    sm.vhead = sm.T + bp * bp;
    sm.alpha = sm.vhead + bp;
    sm.s = sm.alpha + bp;
    sm.beta = reinterpret_cast<typename real_of<S>::type*>(sm.s + bp);
    return sm;
}

// The phase probe's phases of K7 (qr_big.cu), in the order of its per-CTA
// record (linalg/qr.py BIG_PROBE_PHASES)
enum { kQrPanel, kQrT, kQrUpdateA, kQrUpdateQ, kQrLoadStore, kQrPhases };

// A tile of apply_reflectors: TC columns from c0 (tw of them real) of the
// rows j0 .. j0 + mp, read from src and written to dst (global, stride
// n); elements whose row or column lies below id_lim are the identity's,
// formed in shared memory instead of read.
template <typename S>
struct TileRef {
    S* dst;
    const S* src;
    int c0, tw, id_lim;
};

// X <- X - V op(T) V^H X for the nt tiles tile(t) names, op(T) = T^H
// (HERM: the reflectors' H^H, householder_tc) or T (H itself,
// form_q_backward, qr_big.cu); V and T in sm. Tile t + 1 is copied by
// cp.async while tile t is computed (nbuf = 2). V^H X, Y = -op(T) W and
// V Y + X are register-tiled products, on the FP64 tensor cores (float64,
// complex128) or the FP32 pipe (float32, complex64; Y there element by
// element); the result goes from registers to global memory. The probe
// charges tiles t < ta to A's update, the others to Q's.
template <typename S, int BP, int TC, bool HERM, typename TileOf, typename PR>
__device__ void apply_reflectors(const TcSmem<S>& sm, int n, int j0, int mp, int nbuf,
                                 int nt, int ta, TileOf tile_of, PR& probe) {
    using R = typename real_of<S>::type;
    constexpr int PAD = pad_of<S>::value, LDV = BP + PAD, LDX = TC + PAD, LDT = TC + PAD;
    constexpr int KSW = slices_of<S>(BP, TC);
    // the FP32 path adds the k-slices of V^H X up before Y (one barrier more)
    constexpr bool SUM_FIRST = !on_tensor_cores<S>() && KSW > 1;
    const int tid = threadIdx.x, np = round_up(n, 8), mr4 = round_up(mp, 4);
    const S zero = from_real<S>(R(0)), one = from_real<S>(R(1));
    const S *V = sm.V, *T = sm.T;
    S* Y = sm.Y;
    auto issue = [&](int t, int buf) {
        const TileRef<S> tl = tile_of(t);
        S* Xb = sm.X + size_t(buf) * np * LDX;
        for (int idx = tid; idx < mp * TC; idx += kThreads) {
            const int r = idx / TC, c = idx % TC;
            if (c >= tl.tw) continue;
            const int gr = j0 + r, gc = tl.c0 + c;
            if (gr < tl.id_lim || gc < tl.id_lim) Xb[r * LDX + c] = gr == gc ? one : zero;
            else cp_async(Xb + r * LDX + c, tl.src + size_t(gr) * n + gc);
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
        probe.lap(kQrLoadStore);
        const TileRef<S> tl = tile_of(t);
        const S* Xb = sm.X + size_t(buf) * np * LDX;
        // W = V^H X, partial sums over k-slices
        vh_product<S, BP, TC>(V, LDV, Xb, LDX, mr4, sm.part, LDT);
        __syncthreads();
        if constexpr (SUM_FIRST) {
            for (int idx = tid; idx < BP * TC; idx += kThreads) {
                const int i = idx / TC, c = idx - i * TC;
                S w = sm.part[i * LDT + c];
                for (int sl = 1; sl < KSW; ++sl) w += sm.part[sl * BP * LDT + i * LDT + c];
                sm.part[i * LDT + c] = w;
            }
            __syncthreads();
        }
        // Y = -op(T) W
        if constexpr (on_tensor_cores<S>()) {
            ty_product_tc<S, BP, TC, HERM>(T, sm.part, Y);
        } else {
            for (int idx = tid; idx < BP * TC; idx += kThreads) {
                const int i = idx / TC, c = idx - i * TC;
                S acc = zero;
                if (HERM) {
                    for (int k = 0; k <= i; ++k)
                        acc += conj_(T[k * BP + i]) * sm.part[k * LDT + c];
                } else {
                    for (int k = i; k < BP; ++k) acc += T[i * BP + k] * sm.part[k * LDT + c];
                }
                Y[i * LDT + c] = -acc;
            }
        }
        __syncthreads();
        // X + V Y, straight to the tile's destination
        if constexpr (on_tensor_cores<S>())
            add_v_times_tc<S, BP, TC>(V, Y, Xb, tl.dst, n, j0, tl.c0, tl.tw, mp);
        else
            add_v_times_fma<S, BP, TC>(V, Y, Xb, tl.dst, n, j0, tl.c0, tl.tw, mp);
        probe.lap(t < ta ? kQrUpdateA : kQrUpdateQ);
    }
    __syncthreads();   // the tiles are in global memory
    probe.lap(kQrLoadStore);
}

// Where householder_tc keeps panel j0's T (row r, column i) for a later
// pass, in vt (n x n) whose lower triangle holds the panels' V: above the
// diagonal, right of the panel's own block, or, for the last panels, in
// rows 0 .. bw (their j0 >= n - 2 BP lies beyond panel 0's own T there for
// every n K7 takes)
__host__ __device__ inline size_t vt_t_index(int n, int j0, int bw, int r, int i) {
    return j0 + 2 * bw <= n ? size_t(j0 + r) * n + j0 + bw + i : size_t(r) * n + j0 + i;
}

// Blocked Householder QR of the n x n matrix in A_in (global, row-major,
// stride n), every reflector applied to the companion in C_in as it goes
// (C == nullptr: none):
//     on exit  A = R  (upper triangle, R_jj = alpha_j of householder_alpha;
//              strict lower triangle exactly zero),  C = Q^H C_in,
// and, given vt, every panel's V (v's head on the diagonal) in vt's lower
// triangle and its T where vt_t_index says (form_q_backward, qr_big.cu).
// The first panel reads A_in and C_in, every later one A and C (A_in may
// be A, C_in may be C). The reflectors are those of the one-CTA bodies
// (f64_tc.cuh, cplx_tc.cuh) up to rounding. Per panel of BP columns at j0
// (mp = n - j0 rows):
//   1. the panel in shared memory, column by column, two barriers a
//      column: every warp forms ||x|| itself (the same sum in the same
//      order, so all agree bitwise), alpha and beta = 2 / v^H v with
//      v^H v = 2 ||x|| (||x|| + |x_0|), and its share of the products
//      x^H a_c (its columns' sums interleaved); s_c = beta (x^H a_c -
//      conj(alpha) a_c[0]) is v^H a_c times beta (v = x - alpha e_0);
//      then the rank-1 update of the panel's trailing columns (each
//      thread one column and several rows), v's head kept apart until it
//      lands;
//   2. R's panel rows to A (strict lower part 0); V keeps the reflectors;
//   3. SV = V^H V (vh_product), then T row by row (lane r of warp 0):
//      T_rr = beta_r, T_ri = -beta_i sum_{r <= k < i} T_rk SV_ki;
//   4. every tile of TC columns (A's trailing columns, then all of C's),
//      rows j0..n: X <- X - V (T^H (V^H X)) (apply_reflectors). Rows
//      beyond mp and columns beyond the panel are zero in V, so ragged n,
//      panels and tiles need no masks inside the products.
// The probe (Probe, common.cuh) charges thread 0's cycles to the panel,
// SV and T, A's and C's tile products, and the loads and stores.
template <typename S, int BP, int TC, typename PR>
__device__ void householder_tc(const S* A_in, S* A, const S* C_in, S* C, int n,
                               int nbuf, const TcSmem<S>& sm, PR& probe,
                               S* vt = nullptr) {
    using R = typename real_of<S>::type;
    constexpr int PAD = pad_of<S>::value, LDV = BP + PAD, LDX = TC + PAD;
    constexpr int LDS = BP + PAD, LDP = BP + 1;
    constexpr int KSS = slices_of<S>(BP, BP);
    constexpr int CPW = (BP + kWarps - 1) / kWarps;   // panel columns per warp
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int np = round_up(n, 8);
    const S zero = from_real<S>(R(0));
    S *V = sm.V, *T = sm.T;
    // stale rows of a tile buffer must be finite: they meet V's zero rows
    for (int idx = tid; idx < nbuf * np * LDX; idx += kThreads) sm.X[idx] = zero;
    __syncthreads();
    for (int j0 = 0; j0 < n; j0 += BP) {
        const int bw = min(BP, n - j0), mp = n - j0;
        const int mr4 = round_up(mp, 4);
        const S* Asrc = j0 == 0 ? A_in : A;
        const S* Csrc = j0 == 0 ? C_in : C;
        // the panel is factored in the tile buffers with an odd row stride
        // (its column walks then hit distinct banks), then copied to V
        S* P = sm.X;
        for (int idx = tid; idx < mp * BP; idx += kThreads) {
            const int r = idx / BP, c = idx % BP;
            if (c < bw) cp_async(P + r * LDP + c, Asrc + size_t(j0 + r) * n + j0 + c);
        }
        cp_async_commit();
        cp_async_wait_all();
        __syncthreads();
        probe.lap(kQrLoadStore);
        // 1. the panel
        for (int jj = 0; jj < bw; ++jj) {
            R p = 0;
#pragma unroll 4
            for (int k = jj + lane; k < mp; k += 32) p += abs2(P[k * LDP + jj]);
            const R norm = sqrt_t(warp_sum(p));
            const S x0 = P[jj * LDP + jj];
            const S alpha = householder_alpha(x0, norm);
            const R vtv = R(2) * norm * (norm + sqrt_t(abs2(x0)));
            // a zero column (v == 0) leaves everything unchanged
            const R beta = R(2) / (vtv == R(0) ? R(1) : vtv);
            const S vh = x0 - alpha;
            // warp w takes columns w, w + 8, ... together (independent
            // chains, each summed in the same order as one at a time)
            S d[CPW];
#pragma unroll
            for (int u = 0; u < CPW; ++u) d[u] = zero;
#pragma unroll 2
            for (int k = jj + 1 + lane; k < mp; k += 32) {
                const S x = conj_(P[k * LDP + jj]);
#pragma unroll
                for (int u = 0; u < CPW; ++u) {
                    const int c = jj + 1 + warp + u * kWarps;
                    if (c < bw) d[u] += x * P[k * LDP + c];
                }
            }
#pragma unroll
            for (int u = 0; u < CPW; ++u) {
                const int c = jj + 1 + warp + u * kWarps;
                const S du = warp_sum(d[u]);
                if (c < bw && lane == 0) sm.s[c] = beta * (du + conj_(vh) * P[jj * LDP + c]);
            }
            if (tid == 0) {
                sm.alpha[jj] = alpha;
                sm.beta[jj] = beta;
                sm.vhead[jj] = vh;
            }
            __syncthreads();
            // the na trailing columns in groups of the next power of two
            // (1 << sh threads a row): a thread keeps one column c and its
            // s_c through its rows, and no thread divides
            const int na = bw - jj - 1;
            const int sh = na > 1 ? 32 - __clz(na - 1) : 0;
            const int c = jj + 1 + (tid & ((1 << sh) - 1));
            if (c < bw) {
                const S sc = sm.s[c];
#pragma unroll 4
                for (int k = jj + (tid >> sh); k < mp; k += kThreads >> sh) {
                    const S vk = k == jj ? sm.vhead[jj] : P[k * LDP + jj];
                    P[k * LDP + c] -= vk * sc;
                }
            }
            if (tid == 0) P[jj * LDP + jj] = sm.vhead[jj];
            __syncthreads();
        }
        probe.lap(kQrPanel);
        // 2. R's panel rows to A (strict lower part 0); V = the reflectors,
        //    zero above the diagonal, beyond bw columns and beyond mp rows
        for (int idx = tid; idx < np * LDV; idx += kThreads) {
            const int r = idx / LDV, c = idx - r * LDV;
            const bool in = r < mp && c < bw;
            const S val = in ? P[r * LDP + c] : zero;
            V[idx] = r < c ? zero : val;
            if (in) A[size_t(j0 + r) * n + j0 + c] = r < c ? val : r == c ? sm.alpha[c] : zero;
            if (vt && in && r >= c) vt[size_t(j0 + r) * n + j0 + c] = val;
        }
        __syncthreads();
        probe.lap(kQrLoadStore);
        // 3. SV = V^H V (partial sums over k-slices), then T
        vh_product<S, BP, BP>(V, LDV, V, LDV, mr4, sm.part, LDS);
        __syncthreads();
        if (warp == 0) {
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
                    if (vt)
                        for (int i = r; i < bw; ++i)
                            vt[vt_t_index(n, j0, bw, r, i)] = T[r * BP + i];
                }
            }
        }
        probe.lap(kQrT);
        // 4. the tiles: A's trailing columns, then all of C's
        const int ta = (n - j0 - bw + TC - 1) / TC;
        const int nt = ta + (C ? (n + TC - 1) / TC : 0);
        apply_reflectors<S, BP, TC, true>(sm, n, j0, mp, nbuf, nt, ta, [&](int t) {
            const int c0 = t < ta ? j0 + bw + t * TC : (t - ta) * TC;
            return TileRef<S>{t < ta ? A : C, t < ta ? Asrc : Csrc, c0, min(TC, n - c0), 0};
        }, probe);
    }
}

template <typename S, int BP, int TC>
__device__ void householder_tc(const S* A_in, S* A, const S* C_in, S* C, int n,
                               int nbuf, const TcSmem<S>& sm) {
    Probe<false, 1> none;
    householder_tc<S, BP, TC>(A_in, A, C_in, C, n, nbuf, sm, none);
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

}  // namespace dq
