// One FP64 tensor-core product, D = A B + C with A 8 x 4, B 4 x 8 and C, D
// 8 x 8 (row-major float64, one matrix each), computed by warp 0 through
// the fragments of tc_blocked.cuh: it holds the lane -> (row, col) mapping
// that K8 and K9 are written in (tc_blocked.cuh's note) against
// torch.matmul on the card (linalg/tensor_core.py).
#include "tc_blocked.cuh"

namespace dq {

__global__ void __launch_bounds__(kThreads)
mma884_check_kernel(const double* A, const double* B, const double* C, double* D) {
    if (threadIdx.x >= 32) return;   // warp-uniform: warp 0 alone
    const int lane = threadIdx.x, g = lane >> 2, q = lane & 3;
    Acc<double> acc;
    acc.c[0] = C[g * 8 + 2 * q];
    acc.c[1] = C[g * 8 + 2 * q + 1];
    mma_acc(acc, A[g * 4 + q], B[q * 8 + g]);
    D[g * 8 + 2 * q] = acc.c[0];
    D[g * 8 + 2 * q + 1] = acc.c[1];
}

}  // namespace dq

extern "C" int dq_mma884_check(int device, const void* A, const void* B, const void* C,
                               void* D, void* stream) {
    return dq::launch_smem(device, dq::mma884_check_kernel, 1, 0, stream,
                           static_cast<const double*>(A), static_cast<const double*>(B),
                           static_cast<const double*>(C), static_cast<double*>(D));
}
