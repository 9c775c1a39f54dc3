"""K2 / K2c / K7: batched Householder QR with explicit Q — wrapper and
plain version, for real (K2, K7) and complex (K2c, K7) matrices.

Replaces detqmc_tpu/linalg/pallas_qr_lanes.py (``qr_lanes``, Pallas
kernel ``_kernel``) and, for the complex SDW chain,
pallas_cqr_lanes.py (``cqr_lanes``) on the card with ``csrc/qr.cu``: one
CTA per matrix, A and Q^H in shared memory (see the source's note for
what bounds it). Matrices beyond that kernel's shared memory (n > 128 in
float32, n > 119 in float64 and complex64, n > 83 in complex128) go to
K7, ``csrc/qr_big.cu``, the counterpart of pallas_qr_wy.py (``qr_wy``)
and pallas_qr_big.py (``qr_big``) for real matrices and of
pallas_cqr_wy.py (``cqr_wy``) and pallas_cqr.py (``cqr_big``) for complex
ones: blocked Householder with the matrices in global memory and a panel
of b columns, a column tile of tc columns and the compact-WY factors in
shared memory (``big_plan`` picks b and tc). ``qr_plain`` is
``torch.linalg.qr``, what a CPU tensor runs.

Contract: qr(A (B, n, n)) -> (Q, R), A = Q R, Q unitary, R upper
triangular with its strict lower triangle exactly zero. The diagonal
phases are not normalized (the kernel's R_jj = -sign(x_j)||x|| or
-(x_j/|x_j|)||x|| differs from LAPACK's real positive diagonal);
``udv.udv_decompose`` folds them into U.
"""

from __future__ import annotations

import torch

from detqmc_tpu_torch.linalg import _kernels

MAX_N = 128
MAX_N_BIG = 512
_ENTRIES = {torch.float32: ("qr", "dq_qr_f32"),
            torch.float64: ("qr", "dq_qr_f64"),
            torch.complex64: ("qr_complex", "dq_qr_c64"),
            torch.complex128: ("qr_complex", "dq_qr_c128")}
_BIG_ENTRIES = {torch.float32: "dq_qr_big_f32",
                torch.float64: "dq_qr_big_f64",
                torch.complex64: "dq_qr_big_c64",
                torch.complex128: "dq_qr_big_c128"}
# (panel width b, tile width tc), widest first
_BIG_PLANS = ((32, 16), (16, 16), (16, 8))


def qr_plain(A):
    return torch.linalg.qr(A)


def smem_bytes(n: int, dtype) -> int:
    """Dynamic shared memory of the kernel (csrc/qr.cu)."""
    item = torch.empty((), dtype=dtype).element_size()
    return item * (2 * n * (n + 1) + 3 * n)


def big_smem_bytes(n: int, dtype, b: int, tc: int) -> int:
    """Dynamic shared memory of K7 (common.cuh
    blocked_smem_bytes: the reflectors' beta are real)."""
    item, real_item = dtype.itemsize, dtype.to_real().itemsize
    return item * (n * (b + 1) + n * (tc + 1) + 2 * b * tc + 2 * b * b
                   + 2 * b) + real_item * b


def big_plan(n: int, dtype):
    """(b, tc) of the blocked kernel K7 at this n and dtype: the
    widest panel and tile within the shared-memory budget (every
    n <= MAX_N_BIG fits one of them)."""
    for b, tc in _BIG_PLANS:
        if big_smem_bytes(n, dtype, b, tc) <= _kernels.MAX_SMEM_BYTES - 1024:
            return b, tc
    raise ValueError(f"n={n} {dtype} exceeds the blocked kernels' "
                     "shared-memory budget")


def kernel_for(n: int, dtype) -> str:
    """The kernel a CUDA tensor of this size and dtype goes to:
    "qr"/"qr_complex" (K2/K2c, one CTA in shared memory) when it fits,
    else "qr_big"/"qr_complex_big" (K7) up to MAX_N_BIG; raises
    beyond."""
    kernel = _ENTRIES[dtype][0]
    if n <= MAX_N and smem_bytes(n, dtype) <= _kernels.MAX_SMEM_BYTES - 1024:
        return kernel
    if n <= MAX_N_BIG:
        return kernel + "_big"
    raise ValueError(f"qr: n={n} {dtype} exceeds the shared-memory budget "
                     f"of K2 / K2c and n > {MAX_N_BIG} (K7)")


def qr(A):
    """K2 (float32/float64), K2c (complex64/complex128) or K7 (all four):
    CPU tensors run ``qr_plain``; CUDA tensors launch the kernel
    ``kernel_for`` names (contiguous (B, n, n)) or raise."""
    if A.device.type == "cpu":
        return qr_plain(A)
    _kernels.check_cuda_tensor("A", A, tuple(_ENTRIES), 3)
    B, n, n2 = A.shape
    if n2 != n:
        raise ValueError(f"qr: A shape {tuple(A.shape)} must be square")
    kernel = kernel_for(n, A.dtype)
    Q = torch.empty_like(A)
    R = torch.empty_like(A)
    if kernel.endswith("_big"):
        _kernels.launch(kernel, _BIG_ENTRIES[A.dtype], A, Q, R, B, n,
                        *big_plan(n, A.dtype))
    else:
        _kernels.launch(kernel, _ENTRIES[A.dtype][1], A, Q, R, B, n)
    return Q, R
