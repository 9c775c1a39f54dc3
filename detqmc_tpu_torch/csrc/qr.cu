// K2 / K2c: batched Householder QR with Q formed explicitly, one CTA per
// matrix, real (K2) or complex (K2c).
//
// Replaces the TPU kernels detqmc_tpu/linalg/pallas_qr_lanes.py (qr_lanes,
// kernel body _kernel), the refactor QR of udv_decompose, and
// pallas_cqr_lanes.py (cqr_lanes, the complex refactor QR of the SDW
// chain, cudv.py:54-67). There 128 matrices ride the vector lanes in VMEM,
// the complex ones as (re, im) f32 planes; here one CTA keeps A and Q^H in
// shared memory in the native type (2 n (n+1) values: 33 KB at n=64 in
// f32 or complex64, 66 KB in f64, 133 KB in complex128) and runs the n
// reflector steps of householder_apply (common.cuh), applying each
// reflector to Q^H (started as I) as it goes. On exit R = triu(A) with its
// strict lower triangle exactly zero, and Q = (Q^H)^H. R's diagonal is
// -sign(x_j)||x|| (real) or -(x_j/|x_j|)||x|| (complex, not real, unlike
// LAPACK's); udv_decompose folds the phase into U.
// What bounds it: n dependent steps with three __syncthreads each; per
// step 2n dot products (one warp each) and a rank-1 update of the active
// rows of A and Q^H in shared memory.
#include "common.cuh"

namespace dq {

template <typename S>
__global__ void __launch_bounds__(kThreads)
qr_kernel(const S* __restrict__ A_in, S* __restrict__ Q_out,
          S* __restrict__ R_out, int n) {
    using R = typename real_of<S>::type;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int ld = n + 1;
    S* A = reinterpret_cast<S*>(smem_raw);   // n x ld
    S* Qh = A + n * ld;                      // n x ld
    S* v = Qh + n * ld;                      // n
    S* s = v + n;                            // 2n
    const int tid = threadIdx.x;
    const size_t off = size_t(blockIdx.x) * n * n;
    for (int idx = tid; idx < n * n; idx += kThreads) {
        const int r = idx / n, c = idx - r * n;
        A[r * ld + c] = A_in[off + idx];
        Qh[r * ld + c] = from_real<S>(r == c ? R(1) : R(0));
    }
    __syncthreads();
    householder_apply(A, Qh, v, s, n, ld);
    for (int idx = tid; idx < n * n; idx += kThreads) {
        const int r = idx / n, c = idx - r * n;
        R_out[off + idx] = c >= r ? A[r * ld + c] : from_real<S>(R(0));
        Q_out[off + idx] = conj_(Qh[c * ld + r]);
    }
}

template <typename S>
int qr(int device, const void* A, void* Q, void* R, int batch, int n,
       void* stream) {
    const size_t smem = sizeof(S) * (2 * size_t(n) * (n + 1) + 3 * size_t(n));
    return launch_smem(device, qr_kernel<S>, batch, smem, stream,
                       static_cast<const S*>(A), static_cast<S*>(Q),
                       static_cast<S*>(R), n);
}

}  // namespace dq

extern "C" {

int dq_qr_f32(int device, const void* A, void* Q, void* R, int batch, int n,
              void* stream) {
    return dq::qr<float>(device, A, Q, R, batch, n, stream);
}

int dq_qr_f64(int device, const void* A, void* Q, void* R, int batch, int n,
              void* stream) {
    return dq::qr<double>(device, A, Q, R, batch, n, stream);
}

int dq_qr_c64(int device, const void* A, void* Q, void* R, int batch, int n,
              void* stream) {
    return dq::qr<dq::cplx<float>>(device, A, Q, R, batch, n, stream);
}

int dq_qr_c128(int device, const void* A, void* Q, void* R, int batch, int n,
               void* stream) {
    return dq::qr<dq::cplx<double>>(device, A, Q, R, batch, n, stream);
}

}  // extern "C"
