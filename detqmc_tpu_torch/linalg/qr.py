"""K2 / K2c: batched Householder QR with explicit Q — wrapper and plain
version, for real (K2) and complex (K2c) matrices.

Replaces detqmc_tpu/linalg/pallas_qr_lanes.py (``qr_lanes``, Pallas
kernel ``_kernel``) and, for the complex SDW chain,
pallas_cqr_lanes.py (``cqr_lanes``) on the card with ``csrc/qr.cu``: one
CTA per matrix, A and Q^H in shared memory (see the source's note for
what bounds it). ``qr_plain`` is ``torch.linalg.qr``, what a CPU tensor
runs.

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
_ENTRIES = {torch.float32: ("qr", "dq_qr_f32"),
            torch.float64: ("qr", "dq_qr_f64"),
            torch.complex64: ("qr_complex", "dq_qr_c64"),
            torch.complex128: ("qr_complex", "dq_qr_c128")}


def qr_plain(A):
    return torch.linalg.qr(A)


def smem_bytes(n: int, dtype) -> int:
    """Dynamic shared memory of the kernel (csrc/qr.cu)."""
    item = torch.empty((), dtype=dtype).element_size()
    return item * (2 * n * (n + 1) + 3 * n)


def qr(A):
    """K2 (float32/float64) or K2c (complex64/complex128): CPU tensors run
    ``qr_plain``; CUDA tensors launch the kernel (contiguous (B, n, n),
    n <= 128 within the shared-memory budget: float64 and complex64 stop
    near n = 119, complex128 near n = 83) or raise."""
    if A.device.type == "cpu":
        return qr_plain(A)
    _kernels.check_cuda_tensor("A", A, tuple(_ENTRIES), 3)
    B, n, n2 = A.shape
    if n2 != n or n > MAX_N:
        raise ValueError(f"qr: A shape {tuple(A.shape)} must be square "
                         f"with n <= {MAX_N}")
    if smem_bytes(n, A.dtype) > _kernels.MAX_SMEM_BYTES - 1024:
        raise ValueError(f"qr: n={n} {A.dtype} exceeds the shared-memory "
                         "budget")
    Q = torch.empty_like(A)
    R = torch.empty_like(A)
    kernel, entry = _ENTRIES[A.dtype]
    _kernels.launch(kernel, entry, A, Q, R, B, n)
    return Q, R
