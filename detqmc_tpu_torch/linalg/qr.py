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
ones: K8's blocked Householder QR (``csrc/tc_blocked.cuh``
householder_tc), the matrices in global memory, the products on the FP64
tensor cores (float64, complex128) or register-tiled on the FP32 pipe
(float32, complex64), then Q formed from the panels' reflectors in
reverse order; ``big_plan`` picks the panel width b,
the tile width tc and the tile buffers nbuf. ``qr_plain`` is
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
# K7's plans (panel width b, tile width tc, tile buffers nbuf), widest
# first, for the (b, tc) that csrc/qr_big.cu compiles: one CTA per SM, and
# in float64 two per SM (within _kernels.TWO_CTA_SMEM_BYTES) when the batch
# has more matrices than the card has SMs, as K8 (green_solve.big_plan)
_REAL_PLANS = ((32, 16, 2), (16, 16, 2), (16, 16, 1))
_BIG_PLANS = {torch.float32: _REAL_PLANS, torch.float64: _REAL_PLANS,
              torch.complex64: _REAL_PLANS,
              torch.complex128: ((16, 8, 2), (8, 8, 2), (8, 8, 1))}
_BIG_PLANS_TWO_CTA = {torch.float64: ((16, 16, 1),)}
_DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.complex64: 2,
                torch.complex128: 3}


def qr_plain(A):
    return torch.linalg.qr(A)


def smem_bytes(n: int, dtype) -> int:
    """Dynamic shared memory of the kernel (csrc/qr.cu)."""
    item = torch.empty((), dtype=dtype).element_size()
    return item * (2 * n * (n + 1) + 3 * n)


def on_tensor_cores(dtype) -> bool:
    """tc_blocked.cuh on_tensor_cores: float64 and complex128 products run
    on the FP64 tensor cores, float32 and complex64 ones on the FP32
    pipe."""
    return dtype in (torch.float64, torch.complex128)


def slices(dtype, b: int, w: int) -> int:
    """tc_blocked.cuh slices_of: the k-slices of a b x w product V^H M."""
    if on_tensor_cores(dtype):
        frags = (b // 8) * (w // 8)
        return 1 if frags >= 8 else 8 // frags
    return min(8, max(1, 2048 // (b * w)))


def tc_smem_bytes(n: int, dtype, b: int, tc: int, nbuf: int) -> int:
    """Dynamic shared memory of householder_tc (tc_blocked.cuh
    tc_smem_bytes), K7's and K8's: the reflectors' beta are real."""
    item, real_item = dtype.itemsize, dtype.to_real().itemsize
    np_, pad = -(-n // 8) * 8, _kernels.row_pad(dtype)
    part = max(slices(dtype, b, tc) * b * (tc + pad),
               slices(dtype, b, b) * b * (b + pad))
    elems = (np_ * (b + pad) + nbuf * np_ * (tc + pad) + part + b * (tc + pad)
             + b * b + 3 * b)
    return item * elems + real_item * b


def big_plan(n: int, dtype, batch: int = 1, sms: int = _kernels.H100_SMS):
    """(b, tc, nbuf) of K7 at this n, dtype and batch: with more matrices
    than SMs, the widest two-CTA plan that fits (float64); else (or if
    none fits) the widest one-CTA plan within the shared-memory budget
    (every n <= MAX_N_BIG fits one of them)."""
    if batch > sms:
        for plan in _BIG_PLANS_TWO_CTA.get(dtype, ()):
            if tc_smem_bytes(n, dtype, *plan) <= _kernels.TWO_CTA_SMEM_BYTES:
                return plan
    for plan in _BIG_PLANS[dtype]:
        if tc_smem_bytes(n, dtype, *plan) <= _kernels.MAX_SMEM_BYTES - 1024:
            return plan
    raise ValueError(f"n={n} {dtype} exceeds the blocked kernels' "
                     "shared-memory budget")


def big_blocks_per_sm(n: int, dtype, plan, device="cuda") -> int:
    """CTAs of K7 one SM of ``device`` holds at this plan, as the CUDA
    occupancy calculator reports it."""
    return _kernels.query("dq_qr_big_blocks_per_sm", device,
                          _DTYPE_CODES[dtype], n, *plan)


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


# the phase probe's phases of K7 (qr_big.cu), in the order of its per-CTA
# record; the record ends with the CTA's total cycles and ns. The probe
# instances are compiled for float64 and complex64 at the one-CTA plan
# (32, 16, ...) (the main paths' K7).
BIG_PROBE_PHASES = ("panel", "T", "update of A", "update of Q",
                    "loads and stores")
_BIG_PROBE_ENTRIES = {torch.float64: "dq_qr_big_probe_f64",
                      torch.complex64: "dq_qr_big_probe_c64"}


def qr(A, probe: bool = False):
    """K2 (float32/float64), K2c (complex64/complex128) or K7 (all four):
    CPU tensors run ``qr_plain``; CUDA tensors launch the kernel
    ``kernel_for`` names (contiguous (B, n, n)) or raise. With ``probe``
    (K7, float64 or complex64) the kernel's instance with clock64() stamps
    runs instead, and the result gains a (B, len(BIG_PROBE_PHASES) + 2)
    int64 record per CTA: cycles per phase, total cycles, total ns."""
    if A.device.type == "cpu":
        if probe:
            raise ValueError("qr: the probe needs a CUDA tensor")
        return qr_plain(A)
    _kernels.check_cuda_tensor("A", A, tuple(_ENTRIES), 3)
    B, n, n2 = A.shape
    if n2 != n:
        raise ValueError(f"qr: A shape {tuple(A.shape)} must be square")
    kernel = kernel_for(n, A.dtype)
    plan = (big_plan(n, A.dtype, B, _kernels.sm_count(A.device))
            if kernel.endswith("_big") else None)
    if probe and (A.dtype not in _BIG_PROBE_ENTRIES or plan is None
                  or plan[0] != 32):
        raise ValueError(f"qr: no phase probe for n={n} {A.dtype} at plan "
                         f"{plan}")
    Q = torch.empty_like(A)
    R = torch.empty_like(A)
    if probe:
        rec = torch.zeros((B, len(BIG_PROBE_PHASES) + 2), dtype=torch.int64,
                          device=A.device)
        _kernels.launch(kernel, _BIG_PROBE_ENTRIES[A.dtype], A, Q, R, B, n,
                        *plan, rec)
        return Q, R, rec
    if plan:
        _kernels.launch(kernel, _BIG_ENTRIES[A.dtype], A, Q, R, B, n, *plan)
    else:
        _kernels.launch(kernel, _ENTRIES[A.dtype][1], A, Q, R, B, n)
    return Q, R
