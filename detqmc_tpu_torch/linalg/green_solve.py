"""K3: the stabilized inner solve — wrapper and plain version.

Replaces the dispatcher detqmc_tpu/linalg/pallas_green.py
(``solve_inner``) and the kernel it sends n <= 128 to,
detqmc_tpu/linalg/pallas_green_lanes.py (``solve_inner_lanes``), with
``csrc/green_solve.cu``: Householder QR of the inner matrix applied to
diag(r1), then back-substitution, one CTA per matrix.

The TPU kernel works in df32 — (hi, lo) f32 pairs emulating ~48-bit
mantissas — because the chip has no f64 (detqmc_tpu/linalg/df32.py). The
H100 has native f64, so the port takes the f64 inner matrix as it is and
keeps every intermediate in f64: df32 is not ported. The inner matrix of
the range-split Green formula reaches condition ~1e6 at beta = 8, so an
f32 step anywhere in here would cost the stabilized G its accuracy.

Contract: solve_inner(inner (B, n, n) f64, r1 (B, n) f64)
    -> mid = inner^{-1} diag(r1)  (B, n, n) f64.
``solve_inner_plain`` (what a CPU tensor runs) is torch.linalg.qr +
solve_triangular, as detqmc_tpu/linalg/udv.green_from_two_udv does it.
"""

from __future__ import annotations

import torch

from detqmc_tpu_torch.linalg import _kernels

MAX_N = 128


def solve_inner_plain(inner, r1):
    Q, R = torch.linalg.qr(inner)
    rhs = Q.transpose(-1, -2) * r1[..., None, :]
    return torch.linalg.solve_triangular(R, rhs, upper=True)


def smem_bytes(n: int) -> int:
    """Dynamic shared memory of the kernel (csrc/green_solve.cu)."""
    return 8 * (2 * n * (n + 1) + 3 * n)


def solve_inner(inner, r1):
    """K3: CPU tensors run ``solve_inner_plain``; CUDA tensors launch the
    kernel (float64 only, contiguous, n within the shared-memory budget:
    n <= 119) or raise."""
    if inner.device.type == "cpu":
        return solve_inner_plain(inner, r1)
    _kernels.check_cuda_tensor("inner", inner, (torch.float64,), 3)
    _kernels.check_cuda_tensor("r1", r1, (torch.float64,), 2)
    B, n, n2 = inner.shape
    if n2 != n or n > MAX_N or tuple(r1.shape) != (B, n):
        raise ValueError(f"solve_inner: shapes {tuple(inner.shape)}, "
                         f"{tuple(r1.shape)}: need (B, n, n), (B, n), "
                         f"n <= {MAX_N}")
    if smem_bytes(n) > _kernels.MAX_SMEM_BYTES - 1024:
        raise ValueError(f"solve_inner: n={n} exceeds the shared-memory "
                         "budget")
    mid = torch.empty_like(inner)
    _kernels.launch("solve_inner", "dq_solve_inner_f64", inner, r1, mid,
                    B, n)
    return mid
