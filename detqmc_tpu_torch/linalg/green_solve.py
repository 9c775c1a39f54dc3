"""K3 / K3c: the stabilized inner solve — wrapper and plain version, for
the real (K3, float64) and the complex (K3c, complex128) chain.

Replaces the dispatcher detqmc_tpu/linalg/pallas_green.py
(``solve_inner``) and the kernel it sends n <= 128 to,
detqmc_tpu/linalg/pallas_green_lanes.py (``solve_inner_lanes``), and for
the complex SDW chain pallas_cgreen_lanes.py (``solve_inner_complex``),
with ``csrc/green_solve.cu``: Householder QR of the inner matrix applied
to diag(r1), then back-substitution, one CTA per matrix. Complex matrices
beyond that kernel's shared memory (n > 83) go to K8,
``csrc/green_solve_big.cu``, the counterpart of pallas_cgreen.py
(``solve_inner_complex_big``): K7's blocked factorization
(``qr.big_plan``) applied to diag(r1), the matrices in global memory,
then the back-substitution by K9 (``linalg/trinv.py``, the blocked
triangular inverse of pallas_trinv_common.py) on Q^H diag(r1) in place:
two launches.

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

from detqmc_tpu_torch.linalg import _kernels, trinv
from detqmc_tpu_torch.linalg.qr import MAX_N_BIG, big_plan

MAX_N = 128
_ENTRIES = {torch.float64: ("solve_inner", "dq_solve_inner_f64"),
            torch.complex128: ("solve_inner_complex", "dq_solve_inner_c128")}
_BIG_ENTRY = "dq_solve_inner_big_c128"


def solve_inner_plain(inner, r1):
    Q, R = torch.linalg.qr(inner)
    rhs = Q.mH * r1[..., None, :]
    return torch.linalg.solve_triangular(R, rhs, upper=True)


def smem_bytes(n: int, dtype=torch.float64) -> int:
    """Dynamic shared memory of the kernel (csrc/green_solve.cu)."""
    item = torch.empty((), dtype=dtype).element_size()
    return item * (2 * n * (n + 1) + 3 * n)


def kernel_for(n: int, dtype) -> str:
    """The kernel a CUDA tensor of this size and dtype goes to:
    "solve_inner"/"solve_inner_complex" (K3/K3c, one CTA in shared
    memory) when it fits, else "solve_inner_complex_big" (K8) for
    complex128 up to qr.MAX_N_BIG; raises beyond."""
    kernel = _ENTRIES[dtype][0]
    if n <= MAX_N and smem_bytes(n, dtype) <= _kernels.MAX_SMEM_BYTES - 1024:
        return kernel
    if dtype == torch.complex128 and n <= MAX_N_BIG:
        return "solve_inner_complex_big"
    raise ValueError(f"solve_inner: n={n} {dtype} exceeds the shared-memory "
                     f"budget of K3 (float64) or n > {MAX_N_BIG}")


def solve_inner(inner, r1):
    """K3 (float64), K3c or K8 + K9 (complex128): CPU tensors run
    ``solve_inner_plain``; CUDA tensors launch the kernel ``kernel_for``
    names (contiguous, r1 float64) or raise."""
    if inner.device.type == "cpu":
        return solve_inner_plain(inner, r1)
    _kernels.check_cuda_tensor("inner", inner, tuple(_ENTRIES), 3)
    _kernels.check_cuda_tensor("r1", r1, (torch.float64,), 2)
    B, n, n2 = inner.shape
    if n2 != n or tuple(r1.shape) != (B, n):
        raise ValueError(f"solve_inner: shapes {tuple(inner.shape)}, "
                         f"{tuple(r1.shape)}: need (B, n, n), (B, n)")
    kernel = kernel_for(n, inner.dtype)
    mid = torch.empty_like(inner)
    if kernel == "solve_inner_complex_big":
        work = torch.empty_like(inner)
        _kernels.launch(kernel, _BIG_ENTRY, inner, r1, mid, work, B, n,
                        *big_plan(n, inner.dtype))
        trinv.trinv_(work, mid)         # R^{-1} (Q^H diag(r1))
    else:
        _kernels.launch(kernel, _ENTRIES[inner.dtype][1], inner, r1, mid, B,
                        n)
    return mid
