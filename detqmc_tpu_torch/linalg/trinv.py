"""K9: the blocked upper-triangular inverse, applied to a right-hand side —
wrapper and plain version.

Replaces detqmc_tpu/linalg/pallas_trinv_common.py (``call_batched``,
Pallas kernel ``_kernel``), which the JAX package reaches through
pallas_ctrinv.py (``ctrinv_big``) and pallas_trinv.py (``trinv_big``) on
its refine route (cudv.cinv_refined: QR, then R^{-1}, then R^{-1} Q^H),
with ``csrc/trinv_big.cu``: the same descending panels of b columns, one
CTA per tile of tc columns of X, R's next panel copied while the current
one is solved (nbuf = 2), the update of the rows above a panel on the
FP64 tensor cores (float64, complex128) or register-tiled on the CUDA
cores (float32, complex64); see the source's note. ``X = None``
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
# (panel width b <= 32, tile width tc, panel buffers nbuf), widest first;
# tc is 8, 16 or 32 (the compiled tile widths), b a multiple of 8
_PLANS = ((32, 32, 2), (16, 32, 2), (32, 16, 2), (16, 16, 2), (32, 32, 1),
          (16, 32, 1), (16, 16, 1), (8, 16, 1), (16, 8, 1), (8, 8, 1))
_DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.complex64: 2,
                torch.complex128: 3}


def _eye_like(R):
    B, n, _ = R.shape
    return torch.eye(n, dtype=R.dtype, device=R.device).expand(B, n, n)


def trinv_plain(R, X=None):
    return torch.linalg.solve_triangular(
        R, _eye_like(R) if X is None else X, upper=True)


def smem_bytes(n: int, dtype, b: int, tc: int, nbuf: int) -> int:
    """Dynamic shared memory of the kernel (csrc/trinv_big.cu
    trinv_smem_bytes): the tile and nbuf panels, rows padded by
    tc_blocked.cuh pad_of."""
    np_, pad = -(-n // 8) * 8, _kernels.row_pad(dtype)
    return dtype.itemsize * (np_ * (tc + pad) + nbuf * np_ * (b + pad))


def plan(n: int, dtype, batch: int = 1, sms: int = _kernels.H100_SMS):
    """(b, tc, nbuf) at this n, dtype and batch: the widest plan of two
    CTAs per SM when its grid (batch x ceil(n / tc) CTAs) has more CTAs
    than the card has SMs, else (or if none fits) the widest one-CTA plan
    within the shared-memory budget; raises beyond MAX_N."""
    if n <= MAX_N:
        for b, tc, nbuf in _PLANS:
            if (batch * -(-n // tc) > sms and smem_bytes(n, dtype, b, tc, nbuf)
                    <= _kernels.TWO_CTA_SMEM_BYTES):
                return b, tc, nbuf
        for b, tc, nbuf in _PLANS:
            if smem_bytes(n, dtype, b, tc, nbuf) <= \
                    _kernels.MAX_SMEM_BYTES - 1024:
                return b, tc, nbuf
    raise ValueError(f"trinv: n={n} {dtype} exceeds the kernel's "
                     f"shared-memory budget or n > {MAX_N}")


def blocks_per_sm(n: int, dtype, plan, device="cuda") -> int:
    """CTAs of K9 one SM of ``device`` holds at this plan, as the CUDA
    occupancy calculator reports it."""
    return _kernels.query("dq_trinv_big_blocks_per_sm", device,
                          _DTYPE_CODES[dtype], n, *plan)


def trinv_(R, X, plan_=None) -> None:
    """X <- R^{-1} X in place on CUDA tensors (contiguous (B, n, n), one
    dtype): one K9 launch at ``plan`` (or ``plan_``), or raise."""
    _kernels.check_cuda_tensor("R", R, tuple(_ENTRIES), 3)
    _kernels.check_cuda_tensor("X", X, (R.dtype,), 3)
    B, n, n2 = R.shape
    if n2 != n or tuple(X.shape) != (B, n, n):
        raise ValueError(f"trinv: shapes {tuple(R.shape)}, {tuple(X.shape)}: "
                         "need (B, n, n) twice")
    plan_ = plan_ or plan(n, R.dtype, B, _kernels.sm_count(R.device))
    _kernels.launch("trinv_big", _ENTRIES[R.dtype], R, X, B, n, *plan_)


def trinv(R, X=None):
    """K9: CPU tensors run ``trinv_plain``; CUDA tensors launch the kernel
    on a copy of X (the identity if None) or raise."""
    if R.device.type == "cpu":
        return trinv_plain(R, X)
    out = (_eye_like(R) if X is None else X).contiguous().clone()
    trinv_(R, out)
    return out
