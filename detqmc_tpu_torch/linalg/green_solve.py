"""K3 / K3c: the stabilized inner solve — wrapper and plain version, for
the real (K3, float64) and the complex (K3c, complex128) chain.

Replaces the dispatcher detqmc_tpu/linalg/pallas_green.py
(``solve_inner``) and the kernel it sends n <= 128 to,
detqmc_tpu/linalg/pallas_green_lanes.py (``solve_inner_lanes``), and for
the complex SDW chain pallas_cgreen_lanes.py (``solve_inner_complex``),
with ``csrc/green_solve.cu``: Householder QR of the inner matrix applied
to diag(r1), then back-substitution, one CTA per matrix.

The TPU kernels work in df32 — (hi, lo) f32 pairs emulating ~48-bit
mantissas, four planes for a complex matrix — because the chip has no f64
(detqmc_tpu/linalg/df32.py). The H100 has native f64 and complex128, so
the port takes the inner matrix as it is and keeps every intermediate in
that type: df32 is not ported. The inner matrix of the range-split Green
formula reaches condition ~1e6 at beta = 8, so an f32 step anywhere in
here would cost the stabilized G its accuracy.

Contract: solve_inner(inner (B, n, n) f64 or c128, r1 (B, n) f64)
    -> mid = inner^{-1} diag(r1)  (B, n, n), inner's dtype.
``solve_inner_plain`` (what a CPU tensor runs) is torch.linalg.qr +
solve_triangular, as detqmc_tpu/linalg/udv.green_from_two_udv does it.
"""

from __future__ import annotations

import torch

from detqmc_tpu_torch.linalg import _kernels

MAX_N = 128
_ENTRIES = {torch.float64: ("solve_inner", "dq_solve_inner_f64"),
            torch.complex128: ("solve_inner_complex", "dq_solve_inner_c128")}


def solve_inner_plain(inner, r1):
    Q, R = torch.linalg.qr(inner)
    rhs = Q.mH * r1[..., None, :]
    return torch.linalg.solve_triangular(R, rhs, upper=True)


def smem_bytes(n: int, dtype=torch.float64) -> int:
    """Dynamic shared memory of the kernel (csrc/green_solve.cu)."""
    item = torch.empty((), dtype=dtype).element_size()
    return item * (2 * n * (n + 1) + 3 * n)


def solve_inner(inner, r1):
    """K3 (float64) or K3c (complex128): CPU tensors run
    ``solve_inner_plain``; CUDA tensors launch the kernel (contiguous, r1
    float64, n within the shared-memory budget: n <= 119 in float64,
    n <= 83 in complex128) or raise."""
    if inner.device.type == "cpu":
        return solve_inner_plain(inner, r1)
    _kernels.check_cuda_tensor("inner", inner, tuple(_ENTRIES), 3)
    _kernels.check_cuda_tensor("r1", r1, (torch.float64,), 2)
    B, n, n2 = inner.shape
    if n2 != n or n > MAX_N or tuple(r1.shape) != (B, n):
        raise ValueError(f"solve_inner: shapes {tuple(inner.shape)}, "
                         f"{tuple(r1.shape)}: need (B, n, n), (B, n), "
                         f"n <= {MAX_N}")
    if smem_bytes(n, inner.dtype) > _kernels.MAX_SMEM_BYTES - 1024:
        raise ValueError(f"solve_inner: n={n} {inner.dtype} exceeds the "
                         "shared-memory budget")
    mid = torch.empty_like(inner)
    kernel, entry = _ENTRIES[inner.dtype]
    _kernels.launch(kernel, entry, inner, r1, mid, B, n)
    return mid
