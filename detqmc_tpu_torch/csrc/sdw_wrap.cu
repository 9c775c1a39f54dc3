// K6: fused SDW wrap and one-sided B apply, complex64 / complex128.
//
// Replaces the TPU kernels detqmc_tpu/linalg/pallas_sdw_wrap.py
// (fused_wrap, kernel body _kernel; fused_apply_left, kernel body
// _apply_kernel). In the model's layout (dim index = orbital * N + site,
// h = 4 N; E (4, N, N) the per-orbital dense kinetic factor, real, stored
// complex: only its real part is read; D (W, N, 4, 4) the per-site
// potential blocks):
//     wrap up:    G' = D . (E @ ((G @ E^-1) . D^-1))
//     wrap down:  G' = E^-1 @ (D^-1 . ((G . D) @ E))
//     apply:      X' = D . (E @ X)                    (B X, B = D_V expK)
//     apply-H:    X' = E^T @ (D^H . X)                (B^H X)
// The TPU kernel keeps a walker's whole G (512 KB at h = 256 in complex64)
// plus a temporary in VMEM. A block here has 227 KB, so the work is split
// by the structure of the factors: right factors (@ E, . D) mix columns
// within a row, left factors mix rows within a column. One launch
// ("line pass") takes a tile of TL rows (right pass) or TL columns (left
// pass) of one walker into shared memory as TL lines of h values, applies
// a kinetic step and a potential step in either order, and writes the
// lines back. A wrap is a right pass into a scratch buffer in global
// memory (the TPU kernel's t_ref) and a left pass from it: two launches
// from one entry point; an apply is one left pass.
// Per line, the kinetic step is out[o N + n] = sum_m in[o N + m] F_o[m][n]
// with F_o staged orbital by orbital into shared memory from E's real part
// (F = E or E^T by the side), each thread accumulating RT = 4 lines for
// one n (one F load per 4 real x complex products, the line values
// broadcast); the potential step is out[b N + i] = sum_a in[a N + i]
// Dm_i[a][b] with the walker's blocks staged once (Dm = D, D^T or conj D).
// What bounds it on the H100: the kinetic steps, 2 h^2 N real x complex
// products per walker and wrap (4.2 M at h = 256) on the FP32/FP64 pipes
// out of shared memory; global traffic is one read and one write of G
// per pass (plus the scratch), and the staging of F (4 N^2 values) per
// block.
#include "common.cuh"

namespace dq {

constexpr int kRT = 4;   // lines per thread in the kinetic step

struct PassFlags {
    int left;       // lines are columns (left factors) instead of rows
    int kin_first;  // kinetic step before the potential step
    int e_trans;    // F_o[m][n] = E_o[n][m] (left kinetic: E @ X)
    int d_trans;    // Dm_i[a][b] = D_i[b][a] (left potential: D . X)
    int d_conj;     // Dm = conj(D) (D^H . X together with d_trans = 0)
};

template <typename T>
__device__ void kin_step(const cplx<T>* in, cplx<T>* out, T* Fs, const cplx<T>* E,
                         int N, int TL, int ldl, int e_trans) {
    const int tid = threadIdx.x, ldf = N + 1;
    for (int o = 0; o < 4; ++o) {
        const cplx<T>* Eo = E + size_t(o) * N * N;
        for (int idx = tid; idx < N * N; idx += kThreads) {
            const int r = idx / N, c = idx - r * N;   // E_o[r][c]
            if (e_trans) Fs[c * ldf + r] = Eo[idx].re;
            else         Fs[r * ldf + c] = Eo[idx].re;
        }
        __syncthreads();
        for (int p = tid; p < (TL / kRT) * N; p += kThreads) {
            const int tg = p / N, n = p - tg * N;
            cplx<T> acc[kRT];
#pragma unroll
            for (int r = 0; r < kRT; ++r) acc[r] = mk(T(0), T(0));
            const cplx<T>* src = in + (tg * kRT) * ldl + o * N;
            for (int m = 0; m < N; ++m) {
                const T f = Fs[m * ldf + n];
#pragma unroll
                for (int r = 0; r < kRT; ++r) {
                    const cplx<T> x = src[r * ldl + m];
                    acc[r].re += f * x.re;
                    acc[r].im += f * x.im;
                }
            }
#pragma unroll
            for (int r = 0; r < kRT; ++r) out[(tg * kRT + r) * ldl + o * N + n] = acc[r];
        }
        __syncthreads();
    }
}

template <typename T>
__device__ void dv_step(const cplx<T>* in, cplx<T>* out, const cplx<T>* Ds, int N,
                        int TL, int ldl) {
    const int h = 4 * N;
    for (int p = threadIdx.x; p < TL * h; p += kThreads) {
        const int t = p / h, k = p - t * h, b = k / N, i = k - b * N;
        const cplx<T>* x = in + t * ldl + i;
        const cplx<T>* d = Ds + i * 16 + b;
        cplx<T> acc = x[0] * d[0];
        for (int a = 1; a < 4; ++a) acc += x[a * N] * d[4 * a];
        out[t * ldl + k] = acc;
    }
    __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
line_pass_kernel(const cplx<T>* X_in, cplx<T>* X_out, const cplx<T>* __restrict__ E,
                 const cplx<T>* __restrict__ D, int N, int TL, PassFlags fl) {
    using S = cplx<T>;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int h = 4 * N, ldl = h + 1, tiles = (h + TL - 1) / TL;
    S* bufA = reinterpret_cast<S*>(smem_raw);   // TL x ldl lines
    S* bufB = bufA + TL * ldl;
    S* Ds = bufB + TL * ldl;                      // N x 16: Dm_i[a][b]
    T* Fs = reinterpret_cast<T*>(Ds + 16 * N);   // N x (N + 1)
    const int tid = threadIdx.x;
    const size_t w = blockIdx.x / tiles;
    const int l0 = (blockIdx.x - w * tiles) * TL;
    const size_t off = w * size_t(h) * h;

    const S* Dw = D + w * size_t(N) * 16;
    for (int idx = tid; idx < 16 * N; idx += kThreads) {
        const int i = idx >> 4, a = (idx >> 2) & 3, b = idx & 3;
        S d = fl.d_trans ? Dw[i * 16 + 4 * b + a] : Dw[idx];
        if (fl.d_conj) d = conj_(d);
        Ds[idx] = d;
    }
    for (int idx = tid; idx < TL * h; idx += kThreads) {
        int t, k;
        if (fl.left) { k = idx / TL; t = idx - k * TL; }   // X[k][l0 + t]
        else         { t = idx / h; k = idx - t * h; }     // X[l0 + t][k]
        const int l = l0 + t;
        bufA[t * ldl + k] = l >= h ? mk(T(0), T(0))
                          : fl.left ? X_in[off + size_t(k) * h + l]
                                    : X_in[off + size_t(l) * h + k];
    }
    __syncthreads();
    if (fl.kin_first) {
        kin_step(bufA, bufB, Fs, E, N, TL, ldl, fl.e_trans);
        dv_step(bufB, bufA, Ds, N, TL, ldl);
    } else {
        dv_step(bufA, bufB, Ds, N, TL, ldl);
        kin_step(bufB, bufA, Fs, E, N, TL, ldl, fl.e_trans);
    }
    for (int idx = tid; idx < TL * h; idx += kThreads) {
        int t, k;
        if (fl.left) { k = idx / TL; t = idx - k * TL; }
        else         { t = idx / h; k = idx - t * h; }
        const int l = l0 + t;
        if (l >= h) continue;
        if (fl.left) X_out[off + size_t(k) * h + l] = bufA[t * ldl + k];
        else         X_out[off + size_t(l) * h + k] = bufA[t * ldl + k];
    }
}

template <typename T>
int line_pass(int device, const void* X_in, void* X_out, const void* E, const void* D,
              int W, int N, int TL, PassFlags fl, void* stream) {
    const size_t h = 4 * size_t(N), ldl = h + 1;
    const size_t smem = sizeof(cplx<T>) * (2 * size_t(TL) * ldl + 16 * size_t(N))
                        + sizeof(T) * size_t(N) * (N + 1);
    const int tiles = static_cast<int>((h + TL - 1) / TL);
    return launch_smem(device, line_pass_kernel<T>, W * tiles, smem, stream,
                       static_cast<const cplx<T>*>(X_in), static_cast<cplx<T>*>(X_out),
                       static_cast<const cplx<T>*>(E), static_cast<const cplx<T>*>(D),
                       N, TL, fl);
}

template <typename T>
int sdw_wrap(int device, const void* G, void* Tmp, void* G_out, const void* E,
             const void* Einv, const void* D, const void* Dinv, int W, int N,
             int up, int TL, void* stream) {
    // right pass on rows into Tmp, then left pass on columns into G_out
    const PassFlags right{0, up, 0, 0, 0}, left{1, up, 1, 1, 0};
    int err = line_pass<T>(device, G, Tmp, up ? Einv : E, up ? Dinv : D, W, N, TL,
                           right, stream);
    if (err) return err;
    return line_pass<T>(device, Tmp, G_out, up ? E : Einv, up ? D : Dinv, W, N, TL,
                        left, stream);
}

template <typename T>
int sdw_apply(int device, const void* X, void* X_out, const void* E, const void* D,
              int W, int N, int herm, int TL, void* stream) {
    // B X: E @ X then D . ;  B^H X: D^H . X then E^T @
    const PassFlags fl = herm ? PassFlags{1, 0, 0, 0, 1} : PassFlags{1, 1, 1, 1, 0};
    return line_pass<T>(device, X, X_out, E, D, W, N, TL, fl, stream);
}

}  // namespace dq

extern "C" {

int dq_sdw_wrap_c64(int device, const void* G, void* Tmp, void* G_out, const void* E,
                    const void* Einv, const void* D, const void* Dinv, int W, int N,
                    int up, int TL, void* stream) {
    return dq::sdw_wrap<float>(device, G, Tmp, G_out, E, Einv, D, Dinv, W, N, up,
                               TL, stream);
}

int dq_sdw_wrap_c128(int device, const void* G, void* Tmp, void* G_out, const void* E,
                     const void* Einv, const void* D, const void* Dinv, int W, int N,
                     int up, int TL, void* stream) {
    return dq::sdw_wrap<double>(device, G, Tmp, G_out, E, Einv, D, Dinv, W, N, up,
                                TL, stream);
}

int dq_sdw_apply_c64(int device, const void* X, void* X_out, const void* E,
                     const void* D, int W, int N, int herm, int TL, void* stream) {
    return dq::sdw_apply<float>(device, X, X_out, E, D, W, N, herm, TL, stream);
}

int dq_sdw_apply_c128(int device, const void* X, void* X_out, const void* E,
                      const void* D, int W, int N, int herm, int TL, void* stream) {
    return dq::sdw_apply<double>(device, X, X_out, E, D, W, N, herm, TL, stream);
}

}  // extern "C"
