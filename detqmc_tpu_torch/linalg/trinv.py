"""K9: the blocked upper-triangular inverse, applied to a right-hand side —
wrapper and plain version.

Replaces detqmc_tpu/linalg/pallas_trinv_common.py (``call_batched``,
Pallas kernel ``_kernel``), which the JAX package reaches through
pallas_ctrinv.py (``ctrinv_big``) and pallas_trinv.py (``trinv_big``) on
its refine route (cudv.cinv_refined: QR, then R^{-1}, then R^{-1} Q^H),
with ``csrc/trinv_big.cu``: the same descending panels of b columns, one
CTA per tile of tc columns of X (see the source's note). ``X = None``
gives the TPU kernel's contract, R^{-1}. K8 (``green_solve.solve_inner``
beyond one block) hands it Q^H diag(r1): the port's inner solve forms
R^{-1} Q^H diag(r1) in native complex128 directly, where the refine route
forms R^{-1} and multiplies (ROADMAP.md Queue 3).

Contract: trinv(R (B, n, n), X (B, n, n) or None) -> R^{-1} X, R's upper
triangle read (diagonal included), its strict lower triangle ignored;
float32, float64, complex64 or complex128. ``trinv_plain`` (what a CPU
tensor runs) is ``torch.linalg.solve_triangular``.
"""

from __future__ import annotations

import torch

from detqmc_tpu_torch.linalg import _kernels

MAX_N = 512
_ENTRIES = {torch.float32: "dq_trinv_big_f32",
            torch.float64: "dq_trinv_big_f64",
            torch.complex64: "dq_trinv_big_c64",
            torch.complex128: "dq_trinv_big_c128"}
# (panel width b <= 32, tile width tc), widest first
_PLANS = ((32, 16), (16, 8))


def _eye_like(R):
    B, n, _ = R.shape
    return torch.eye(n, dtype=R.dtype, device=R.device).expand(B, n, n)


def trinv_plain(R, X=None):
    return torch.linalg.solve_triangular(
        R, _eye_like(R) if X is None else X, upper=True)


def smem_bytes(n: int, dtype, b: int, tc: int) -> int:
    """Dynamic shared memory of the kernel (csrc/trinv_big.cu)."""
    item = torch.empty((), dtype=dtype).element_size()
    return item * (n * (b + 1) + n * (tc + 1) + b)


def plan(n: int, dtype):
    """(b, tc) at this n and dtype: the widest panel and tile within the
    shared-memory budget; raises beyond MAX_N."""
    if n <= MAX_N:
        for b, tc in _PLANS:
            if smem_bytes(n, dtype, b, tc) <= _kernels.MAX_SMEM_BYTES - 1024:
                return b, tc
    raise ValueError(f"trinv: n={n} {dtype} exceeds the kernel's "
                     f"shared-memory budget or n > {MAX_N}")


def trinv_(R, X) -> None:
    """X <- R^{-1} X in place on CUDA tensors (contiguous (B, n, n), one
    dtype): one K9 launch, or raise."""
    _kernels.check_cuda_tensor("R", R, tuple(_ENTRIES), 3)
    _kernels.check_cuda_tensor("X", X, (R.dtype,), 3)
    B, n, n2 = R.shape
    if n2 != n or tuple(X.shape) != (B, n, n):
        raise ValueError(f"trinv: shapes {tuple(R.shape)}, {tuple(X.shape)}: "
                         "need (B, n, n) twice")
    _kernels.launch("trinv_big", _ENTRIES[R.dtype], R, X, B, n,
                    *plan(n, R.dtype))


def trinv(R, X=None):
    """K9: CPU tensors run ``trinv_plain``; CUDA tensors launch the kernel
    on a copy of X (the identity if None) or raise."""
    if R.device.type == "cpu":
        return trinv_plain(R, X)
    out = (_eye_like(R) if X is None else X).contiguous().clone()
    trinv_(R, out)
    return out
