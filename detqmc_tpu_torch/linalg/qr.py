"""K2: batched Householder QR with explicit Q — wrapper and plain version.

Replaces detqmc_tpu/linalg/pallas_qr_lanes.py (``qr_lanes``, Pallas
kernel ``_kernel``) on the card with ``csrc/qr.cu``: one CTA per matrix,
A and Q^T in shared memory (see the source's note for what bounds it).
``qr_plain`` is ``torch.linalg.qr``, what a CPU tensor runs.

Contract: qr(A (B, n, n)) -> (Q, R), A = Q R, Q orthogonal, R upper
triangular with its strict lower triangle exactly zero. The column signs
are not normalized (the kernel's R_jj = -sign(x_j)||x|| is LAPACK's
convention); ``udv.udv_decompose`` normalizes them.
"""

from __future__ import annotations

import torch

from detqmc_tpu_torch.linalg import _kernels

MAX_N = 128


def qr_plain(A):
    return torch.linalg.qr(A)


def smem_bytes(n: int, dtype) -> int:
    """Dynamic shared memory of the kernel (csrc/qr.cu)."""
    item = torch.empty((), dtype=dtype).element_size()
    return item * (2 * n * (n + 1) + 3 * n)


def qr(A):
    """K2: CPU tensors run ``qr_plain``; CUDA tensors launch the kernel
    (float32 or float64, contiguous (B, n, n), n <= 128 within the
    shared-memory budget: float64 stops near n = 119) or raise."""
    if A.device.type == "cpu":
        return qr_plain(A)
    _kernels.check_cuda_tensor("A", A, (torch.float32, torch.float64), 3)
    B, n, n2 = A.shape
    if n2 != n or n > MAX_N:
        raise ValueError(f"qr: A shape {tuple(A.shape)} must be square "
                         f"with n <= {MAX_N}")
    if smem_bytes(n, A.dtype) > _kernels.MAX_SMEM_BYTES - 1024:
        raise ValueError(f"qr: n={n} {A.dtype} exceeds the shared-memory "
                         "budget")
    Q = torch.empty_like(A)
    R = torch.empty_like(A)
    entry = "dq_qr_f32" if A.dtype == torch.float32 else "dq_qr_f64"
    _kernels.launch("qr", entry, A, Q, R, B, n)
    return Q, R
