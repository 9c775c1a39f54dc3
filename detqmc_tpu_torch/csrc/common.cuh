// Shared device helpers of the detqmc_tpu_torch kernels (sm_90a).
//
// Every kernel here is one CTA per matrix (or walker) with the matrix
// resident in dynamic shared memory. Above 48 KB a kernel may use dynamic
// shared memory only after cudaFuncSetAttribute(...MaxDynamicSharedMemory
// Size...); without it the launch is refused and only cudaGetLastError()
// tells. So every entry point goes through launch_smem() below.
#pragma once

#include <cuda_runtime.h>

namespace dq {

constexpr int kThreads = 256;   // threads per CTA for every kernel
constexpr int kWarps = kThreads / 32;

// Explicitly rounded arithmetic: nvcc contracts a*b+c into an FMA, the
// plain PyTorch version does not. Where the kernel must reproduce the
// plain version's rounding (the Metropolis ratios and rank-1 updates of
// the slice update, whose accept decisions must match), it uses these.
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float exp_t(float a) { return expf(a); }
__device__ __forceinline__ double exp_t(double a) { return exp(a); }
__device__ __forceinline__ float abs_t(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_t(double a) { return fabs(a); }
__device__ __forceinline__ float sqrt_t(float a) { return sqrtf(a); }
__device__ __forceinline__ double sqrt_t(double a) { return sqrt(a); }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// Householder QR of the n x n matrix A (shared memory, row stride ld),
// applying every reflector H_j = I - beta v v^T from the left to the
// companion matrix C (n x n, stride ld) as it goes:
//     on exit  triu(A) = R  (R_jj = alpha_j = -sign(x_j) ||x||),
//              C       = H_{n-1} ... H_0 C_in = Q^T C_in.
// Strictly-lower A entries are left stale (callers read triu only).
// v (n) and s (2n) are shared scratch. All threads of the CTA call it.
//
// Per step: warp 0 forms v and beta; the dot products v^T A[:, c] (the
// trailing columns c > j) and v^T C[:, c] (all columns) go one warp per
// column, lanes striding the rows; the rank-1 updates go one thread per
// element, a row's columns on neighbouring threads. Row stride ld = n+1
// keeps the column walks free of shared-memory bank conflicts.
template <typename T>
__device__ void householder_apply(T* A, T* C, T* v, T* s, int n, int ld) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    __shared__ T alpha_s, beta_s;
    for (int j = 0; j < n; ++j) {
        for (int k = tid; k < n; k += kThreads)
            v[k] = k >= j ? A[k * ld + j] : T(0);
        __syncthreads();
        if (warp == 0) {
            T p = 0;
            for (int k = j + lane; k < n; k += 32) p += v[k] * v[k];
            const T norm = sqrt_t(warp_sum(p));
            const T x0 = v[j];
            const T alpha = x0 >= T(0) ? -norm : norm;
            __syncwarp();
            if (lane == 0) v[j] = x0 - alpha;
            __syncwarp();
            T q = 0;
            for (int k = j + lane; k < n; k += 32) q += v[k] * v[k];
            const T vtv = warp_sum(q);
            if (lane == 0) {
                alpha_s = alpha;
                // a zero column (v == 0) leaves everything unchanged
                beta_s = T(2) / (vtv == T(0) ? T(1) : vtv);
            }
        }
        __syncthreads();
        const T beta = beta_s;
        const int na = n - j - 1;          // trailing columns of A
        for (int col = warp; col < na + n; col += kWarps) {
            const T* M = col < na ? A : C;
            const int c = col < na ? j + 1 + col : col - na;
            T p = 0;
            for (int k = j + lane; k < n; k += 32) p += v[k] * M[k * ld + c];
            p = warp_sum(p);
            if (lane == 0) s[col] = beta * p;
        }
        __syncthreads();
        const int width = na + n, rows = n - j;
        for (int idx = tid; idx < rows * width; idx += kThreads) {
            const int k = j + idx / width, col = idx % width;
            if (col < na) A[k * ld + j + 1 + col] -= v[k] * s[col];
            else          C[k * ld + col - na] -= v[k] * s[col];
        }
        if (tid == 0) A[j * ld + j] = alpha_s;
        __syncthreads();
    }
}

// Launch `kernel` with `smem` bytes of dynamic shared memory on `stream`
// of `device`, raising the kernel's dynamic shared-memory cap first.
// Returns cudaGetLastError().
template <typename Kernel, typename... Args>
int launch_smem(int device, Kernel kernel, int grid, size_t smem,
                void* stream, Args... args) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const void* fn = reinterpret_cast<const void*>(kernel);
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (grid > 0) {
        void* params[] = {static_cast<void*>(&args)...};
        err = cudaLaunchKernel(fn, dim3(grid), dim3(kThreads), params, smem,
                               static_cast<cudaStream_t>(stream));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace dq
