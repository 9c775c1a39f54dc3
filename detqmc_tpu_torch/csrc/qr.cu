// K2: batched Householder QR with Q formed explicitly, one CTA per matrix.
//
// Replaces the TPU kernel detqmc_tpu/linalg/pallas_qr_lanes.py (qr_lanes,
// kernel body _kernel), the refactor QR of udv_decompose: there 128
// matrices ride the vector lanes in VMEM; here one CTA keeps A and Q^T in
// shared memory (2 n (n+1) values: 33 KB at n=64 in f32, 66 KB in f64) and
// runs the n reflector steps of householder_apply (common.cuh), applying
// each reflector to Q^T (started as I) as it goes. On exit R = triu(A)
// with its strict lower triangle exactly zero, and Q = (Q^T)^T. The sign
// convention (R_jj = -sign(x_j) ||x||) is LAPACK's; udv_decompose
// normalizes it away.
// What bounds it: n dependent steps with three __syncthreads each; per
// step 2n dot products (one warp each) and a rank-1 update of the active
// rows of A and Q^T in shared memory.
#include "common.cuh"

namespace dq {

template <typename T>
__global__ void __launch_bounds__(kThreads)
qr_kernel(const T* __restrict__ A_in, T* __restrict__ Q_out,
          T* __restrict__ R_out, int n) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int ld = n + 1;
    T* A = reinterpret_cast<T*>(smem_raw);   // n x ld
    T* Qt = A + n * ld;                      // n x ld
    T* v = Qt + n * ld;                      // n
    T* s = v + n;                            // 2n
    const int tid = threadIdx.x;
    const size_t off = size_t(blockIdx.x) * n * n;
    for (int idx = tid; idx < n * n; idx += kThreads) {
        const int r = idx / n, c = idx - r * n;
        A[r * ld + c] = A_in[off + idx];
        Qt[r * ld + c] = r == c ? T(1) : T(0);
    }
    __syncthreads();
    householder_apply(A, Qt, v, s, n, ld);
    for (int idx = tid; idx < n * n; idx += kThreads) {
        const int r = idx / n, c = idx - r * n;
        R_out[off + idx] = c >= r ? A[r * ld + c] : T(0);
        Q_out[off + idx] = Qt[c * ld + r];
    }
}

template <typename T>
int qr(int device, const void* A, void* Q, void* R, int batch, int n,
       void* stream) {
    const size_t smem = sizeof(T) * (2 * size_t(n) * (n + 1) + 3 * size_t(n));
    return launch_smem(device, qr_kernel<T>, batch, smem, stream,
                       static_cast<const T*>(A), static_cast<T*>(Q),
                       static_cast<T*>(R), n);
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

}  // extern "C"
