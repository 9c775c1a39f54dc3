// Shared device helpers of the detqmc_tpu_torch kernels (sm_90a).
//
// Every kernel here is one CTA per matrix (or walker) with the matrix
// resident in dynamic shared memory. Above 48 KB a kernel may use dynamic
// shared memory only after cudaFuncSetAttribute(...MaxDynamicSharedMemory
// Size...); without it the launch is refused and only cudaGetLastError()
// tells. So every entry point goes through launch_smem() below.
//
// Scalars: the real kernels run on float / double, the complex ones on
// cplx<float> / cplx<double>, laid out as PyTorch's complex64 / complex128
// (re, im). The one-CTA Householder bodies are written once over both
// through the small overload set below (abs2, conj_, householder_alpha, ...).
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
__device__ __forceinline__ float log_t(float a) { return logf(a); }
__device__ __forceinline__ double log_t(double a) { return log(a); }
__device__ __forceinline__ float abs_t(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_t(double a) { return fabs(a); }
__device__ __forceinline__ float sqrt_t(float a) { return sqrtf(a); }
__device__ __forceinline__ double sqrt_t(double a) { return sqrt(a); }

// ---- complex scalars ------------------------------------------------------
// An aggregate (no constructors), so it may live in __shared__ memory.
template <typename T>
struct alignas(2 * sizeof(T)) cplx {
    T re, im;
};

template <typename T>
__device__ __forceinline__ cplx<T> mk(T re, T im) { return cplx<T>{re, im}; }

template <typename T>
__device__ __forceinline__ cplx<T> operator+(cplx<T> a, cplx<T> b) {
    return mk(a.re + b.re, a.im + b.im);
}
template <typename T>
__device__ __forceinline__ cplx<T> operator-(cplx<T> a, cplx<T> b) {
    return mk(a.re - b.re, a.im - b.im);
}
template <typename T>
__device__ __forceinline__ cplx<T> operator-(cplx<T> a) { return mk(-a.re, -a.im); }
template <typename T>
__device__ __forceinline__ cplx<T> operator*(cplx<T> a, cplx<T> b) {
    return mk(a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re);
}
template <typename T>
__device__ __forceinline__ cplx<T> operator*(T a, cplx<T> b) { return mk(a * b.re, a * b.im); }
template <typename T>
__device__ __forceinline__ cplx<T>& operator+=(cplx<T>& a, cplx<T> b) { a = a + b; return a; }
template <typename T>
__device__ __forceinline__ cplx<T>& operator-=(cplx<T>& a, cplx<T> b) { a = a - b; return a; }

// the same products, rounded operation by operation in the order
// (ar br - ai bi, ar bi + ai br), as the plain PyTorch versions compute
// them on separate real and imaginary planes
template <typename T>
__device__ __forceinline__ cplx<T> cmul_rn(cplx<T> a, cplx<T> b) {
    return mk(sub_rn(mul_rn(a.re, b.re), mul_rn(a.im, b.im)),
              add_rn(mul_rn(a.re, b.im), mul_rn(a.im, b.re)));
}
template <typename T>
__device__ __forceinline__ cplx<T> cadd_rn(cplx<T> a, cplx<T> b) {
    return mk(add_rn(a.re, b.re), add_rn(a.im, b.im));
}
template <typename T>
__device__ __forceinline__ cplx<T> csub_rn(cplx<T> a, cplx<T> b) {
    return mk(sub_rn(a.re, b.re), sub_rn(a.im, b.im));
}

// ---- the overload set the Householder code is written in ------------------
template <typename S> struct real_of { using type = S; };
template <typename T> struct real_of<cplx<T>> { using type = T; };

template <typename S> __device__ __forceinline__ S from_real(typename real_of<S>::type x) { return x; }
template <> __device__ __forceinline__ cplx<float> from_real<cplx<float>>(float x) { return mk(x, 0.0f); }
template <> __device__ __forceinline__ cplx<double> from_real<cplx<double>>(double x) { return mk(x, 0.0); }

__device__ __forceinline__ float abs2(float a) { return a * a; }
__device__ __forceinline__ double abs2(double a) { return a * a; }
template <typename T>
__device__ __forceinline__ T abs2(cplx<T> a) { return a.re * a.re + a.im * a.im; }

__device__ __forceinline__ float conj_(float a) { return a; }
__device__ __forceinline__ double conj_(double a) { return a; }
template <typename T>
__device__ __forceinline__ cplx<T> conj_(cplx<T> a) { return mk(a.re, -a.im); }

// a / b: real division, or a conj(b) / |b|^2
__device__ __forceinline__ float div_s(float a, float b) { return a / b; }
__device__ __forceinline__ double div_s(double a, double b) { return a / b; }
template <typename T>
__device__ __forceinline__ cplx<T> div_s(cplx<T> a, cplx<T> b) {
    const T inv = T(1) / abs2(b);
    const cplx<T> p = a * conj_(b);
    return mk(p.re * inv, p.im * inv);
}

// R_jj of the reflector that zeroes x below x_j: -sign(x_j) ||x|| for
// real x (LAPACK's convention, sign(0) = +1), -(x_j / |x_j|) ||x|| for
// complex x (phase 1 at x_j = 0)
__device__ __forceinline__ float householder_alpha(float x0, float norm) {
    return x0 >= 0.0f ? -norm : norm;
}
__device__ __forceinline__ double householder_alpha(double x0, double norm) {
    return x0 >= 0.0 ? -norm : norm;
}
template <typename T>
__device__ __forceinline__ cplx<T> householder_alpha(cplx<T> x0, T norm) {
    const T a0 = sqrt_t(abs2(x0));
    if (a0 == T(0)) return mk(-norm, T(0));
    return mk(-(x0.re / a0) * norm, -(x0.im / a0) * norm);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}
template <typename T>
__device__ __forceinline__ cplx<T> warp_sum(cplx<T> v) {
    return mk(warp_sum(v.re), warp_sum(v.im));
}

// v += v of lane (lane ^ o), each part: one butterfly step
template <typename T>
__device__ __forceinline__ void add_xor(T& v, int o) {
    v += __shfl_xor_sync(0xffffffffu, v, o);
}
template <typename T>
__device__ __forceinline__ void add_xor(cplx<T>& v, int o) {
    add_xor(v.re, o);
    add_xor(v.im, o);
}

// ---- the phase probe ------------------------------------------------------
// A kernel instantiated with a probe on (ON = true) sums clock64() deltas
// per phase as thread 0 of each CTA sees them and writes, per CTA, the P
// phase sums, the CTA's total cycles and its total nanoseconds on the
// global timer (so the host converts cycles to time at the clock the run
// had). With ON = false every member is empty: the production instance
// carries no stamps.
template <bool ON, int P>
struct Probe {
    long long t = 0, t0 = 0, ns0 = 0, acc[ON ? P : 1] = {};
    __device__ __forceinline__ static long long globaltimer() {
        long long ns = 0;
#if defined(__CUDA_ARCH__)
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
#endif
        return ns;
    }
    __device__ __forceinline__ void start() {
        if constexpr (ON) {
            ns0 = globaltimer();
            t0 = t = clock64();
        }
    }
    // close the current phase, charging its cycles to `phase`
    __device__ __forceinline__ void lap(int phase) {
        if constexpr (ON) {
            const long long now = clock64();
            acc[phase] += now - t;
            t = now;
        }
    }
    // out: per CTA P + 2 values (phases, total cycles, total ns)
    __device__ __forceinline__ void store(long long* out) {
        if constexpr (ON) {
            const long long now = clock64(), ns = globaltimer();
            if (threadIdx.x == 0) {
                long long* o = out + size_t(blockIdx.x) * (P + 2);
                for (int p = 0; p < P; ++p) o[p] = acc[p];
                o[P] = now - t0;
                o[P + 1] = ns - ns0;
            }
        }
    }
};

// Launch `kernel` on `grid` CTAs of `block` threads with `smem` bytes of
// dynamic shared memory on `stream` of `device`, raising the kernel's
// dynamic shared-memory cap first. Returns cudaGetLastError().
template <typename Kernel, typename... Args>
int launch_block(int device, Kernel kernel, int grid, int block, size_t smem,
                 void* stream, Args... args) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const void* fn = reinterpret_cast<const void*>(kernel);
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (grid > 0) {
        void* params[] = {static_cast<void*>(&args)...};
        err = cudaLaunchKernel(fn, dim3(grid), dim3(block), params, smem,
                               static_cast<cudaStream_t>(stream));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    return static_cast<int>(cudaGetLastError());
}

// the same with kThreads threads per CTA
template <typename Kernel, typename... Args>
int launch_smem(int device, Kernel kernel, int grid, size_t smem,
                void* stream, Args... args) {
    return launch_block(device, kernel, grid, kThreads, smem, stream, args...);
}

// CTAs of `kernel` (`threads` per CTA) one SM holds at `smem` bytes with
// the largest shared-memory carveout (as launch_tc asks), or -(cudaError)
// on a failure.
template <typename Kernel>
int blocks_per_sm(int device, Kernel kernel, size_t smem, int threads = kThreads) {
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
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, smem);
    return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

}  // namespace dq
