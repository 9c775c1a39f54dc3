// K7: batched Householder QR with Q formed explicitly, for n beyond the
// one-CTA kernels K2 / K2c (qr.cu), one CTA per matrix; real (float32,
// float64) and complex (complex64, complex128).
//
// Replaces the TPU kernels detqmc_tpu/linalg/pallas_cqr_wy.py (cqr_wy, the
// compact-WY layout, kernel body _kernel) and pallas_cqr.py (cqr_big, the
// rank-1 column-lane layout of the same factorization), which cudv.py
// sends every complex refactor QR with n > 128 to (cudv.py:38-67): the SDW
// chain at L = 8 (n = 256); and their real twins pallas_qr_wy.py (qr_wy)
// and pallas_qr_big.py (qr_big), the refactor QR of the Hubbard chain at
// N > 128 (udv._big_qr_impl, udv.py:80-104): L = 16, n = 256. One Hopper
// kernel, one template, replaces all four layouts.
// A complex64 256 x 256 matrix is 512 KB (1 MB in complex128), beyond a
// block's 227 KB, so A and the Q^H accumulator stay in global memory (the
// output buffers R and Q serve as the work arrays) and only a panel of b
// columns, one column tile and the compact-WY factors live in shared
// memory (householder_blocked, common.cuh: panel factorization, T, and
// the trailing update X <- X - V T^H V^H X tile by tile, all in the
// kernel's own loops). At the end Q^H is conjugate-transposed in place.
// Contract as K2 / K2c: A = Q R, Q orthogonal / unitary, R's strict lower
// triangle exactly zero, R_jj = -sign(x_j)||x|| (real, sign(0) = +1, as
// pallas_qr_big.py:22-23) or -(x_j/|x_j|)||x|| (complex; not normalized:
// udv._sign_fix folds the sign or phase). What bounds it on the H100: one CTA per matrix (128 matrices on
// 132 SMs at the main path), n / b panels of b dependent column steps
// (three __syncthreads each), and the trailing updates, ~(4/3 + 2) n^3 / 2
// complex products per matrix read from shared memory, their tiles moving
// through L2.
#include "common.cuh"

namespace dq {

template <typename S>
__global__ void __launch_bounds__(kThreads)
qr_big_kernel(const S* __restrict__ A_in, S* Q_out, S* R_out, int n, int b, int tc) {
    using R = typename real_of<S>::type;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const BlockedSmem<S> sm = blocked_smem<S>(smem_raw, n, b, tc);
    const int tid = threadIdx.x;
    const size_t off = size_t(blockIdx.x) * n * n;
    S* A = R_out + off;
    S* C = Q_out + off;
    for (int idx = tid; idx < n * n; idx += kThreads) {
        const int r = idx / n, c = idx - r * n;
        A[idx] = A_in[off + idx];
        C[idx] = from_real<S>(r == c ? R(1) : R(0));
    }
    __syncthreads();
    householder_blocked(A, C, n, b, tc, sm);
    // Q = (Q^H)^H in place: each thread swaps the pairs (r, c), r < c
    for (int idx = tid; idx < n * n; idx += kThreads) {
        const int r = idx / n, c = idx - r * n;
        if (r < c) {
            const S u = C[idx], l = C[size_t(c) * n + r];
            C[idx] = conj_(l);
            C[size_t(c) * n + r] = conj_(u);
        } else if (r == c) {
            C[idx] = conj_(C[idx]);
        }
    }
}

template <typename S>
int qr_big(int device, const void* A, void* Q, void* R, int batch, int n, int b,
           int tc, void* stream) {
    return launch_smem(device, qr_big_kernel<S>, batch, blocked_smem_bytes<S>(n, b, tc),
                       stream, static_cast<const S*>(A), static_cast<S*>(Q),
                       static_cast<S*>(R), n, b, tc);
}

}  // namespace dq

extern "C" {

int dq_qr_big_f32(int device, const void* A, void* Q, void* R, int batch, int n,
                  int b, int tc, void* stream) {
    return dq::qr_big<float>(device, A, Q, R, batch, n, b, tc, stream);
}

int dq_qr_big_f64(int device, const void* A, void* Q, void* R, int batch, int n,
                  int b, int tc, void* stream) {
    return dq::qr_big<double>(device, A, Q, R, batch, n, b, tc, stream);
}

int dq_qr_big_c64(int device, const void* A, void* Q, void* R, int batch, int n,
                  int b, int tc, void* stream) {
    return dq::qr_big<dq::cplx<float>>(device, A, Q, R, batch, n, b, tc, stream);
}

int dq_qr_big_c128(int device, const void* A, void* Q, void* R, int batch, int n,
                   int b, int tc, void* stream) {
    return dq::qr_big<dq::cplx<double>>(device, A, Q, R, batch, n, b, tc, stream);
}

}  // extern "C"
