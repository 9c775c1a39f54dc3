"""K2 / K2c / K7: batched Householder QR with explicit Q — wrapper and
plain version, for real (K2, K7) and complex (K2c, K7) matrices.

Replaces detqmc_tpu/linalg/pallas_qr_lanes.py (``qr_lanes``, Pallas
kernel ``_kernel``) and, for the complex SDW chain,
pallas_cqr_lanes.py (``cqr_lanes``) on the card with ``csrc/qr.cu``, one
CTA per matrix (see the source's note for what bounds each design): in
float64 (K2 on the Hubbard chains) the tensor-core body of K3 and K3r
(``csrc/f64_tc.cuh``) with the companion Q^T in registers, three CTAs
per SM up to n = 64 (``f64_smem_bytes``, ``blocks_per_sm``); in the
complex dtypes (K2c) the complex body of K3c and K3c-rhs
(``csrc/cplx_tc.cuh``) with Q^H in registers, its products on the FP64
tensor cores (complex128) or the FP32 pipe (complex64)
(``complex_smem_bytes``); in float32 (K2 on the opdim-1 SDW chains: the
refactor QR of sdw_o1_l4, sdw_o1_full_l4 and sdw_o1_l8 at n = 32, 64 and
128, and the opdim-1 log-det's QR) K2c's complex64 body on real floats,
its products on the FP32 pipe with no TF32 (``complex_smem_bytes``).
``kernel_for`` routes each dtype by its body's shared memory up to the
last n it routed there before (``ONE_CTA_LAST_N``: n <= 128 in float32,
119 in float64 and complex64, 83 in complex128). Matrices beyond it go to
K7, ``csrc/qr_big.cu``, the counterpart of
pallas_qr_wy.py (``qr_wy``) and pallas_qr_big.py (``qr_big``) for real
matrices and of pallas_cqr_wy.py (``cqr_wy``) and pallas_cqr.py
(``cqr_big``) for complex ones: K8's blocked Householder QR
(``csrc/tc_blocked.cuh`` householder_tc), the matrices in global memory,
the products on the FP64 tensor cores (float64, complex128) or
register-tiled on the FP32 pipe (float32, complex64), then Q formed from
the panels' reflectors in reverse order; ``big_plan`` picks the panel
width b, the tile width tc and the tile buffers nbuf. ``qr_plain`` is
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

MAX_N_BIG = 512
# the last n of each dtype's one-CTA route: float32 up to K2's np = 128
# instance (RF = 16); the others where the first design's shared memory
# (A and Q^H at n (n + 1) values each) stopped, so that no route changed
ONE_CTA_LAST_N = {torch.float32: 128, torch.float64: 119,
                  torch.complex64: 119, torch.complex128: 83}
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


def f64_smem_bytes(n: int) -> int:
    """Dynamic shared memory of the float64 tensor-core body of K2, K3 and
    K3r (csrc/f64_tc.cuh f64_tc_smem_bytes): A at np x (np + 4), the side
    buffer np x 9, T and V^T V 8 x 9 each, alpha, v's heads and beta."""
    np_ = -(-n // 8) * 8
    return 8 * (np_ * (np_ + 4) + np_ * 9 + 2 * 8 * 9 + 3 * 8)


def complex_smem_bytes(n: int, dtype) -> int:
    """Dynamic shared memory of K2c (csrc/cplx_tc.cuh ctc_smem_bytes, the
    body of K3c and K3c-rhs): A at np x (np + pad), pad 2 in complex64 and
    1 in complex128 (4 in float32, K2's instance of the same body: np + 4
    = 4 or 12 mod 16, the rows 2q + s of a warp's strip 8 banks apart),
    the side buffer np x 9, T and V^H V 8 x 9 each, alpha and v's heads (8
    each), beta (8 reals)."""
    np_ = -(-n // 8) * 8
    pad = {torch.complex64: 2, torch.complex128: 1, torch.float32: 4}[dtype]
    return (dtype.itemsize * (np_ * (np_ + pad) + 9 * np_ + 2 * 8 * 9 + 16)
            + dtype.to_real().itemsize * 8)


def one_cta_smem_bytes(n: int, dtype) -> int:
    """Dynamic shared memory of the one-CTA QR body that ``dtype`` runs
    at this n."""
    if dtype == torch.float64:
        return f64_smem_bytes(n)
    return complex_smem_bytes(n, dtype)


def blocks_per_sm(n: int, dtype, device="cuda") -> int:
    """CTAs of the one-CTA QR (K2 in float32 and float64, K2c in the
    complex dtypes) one SM of ``device`` holds at this n, as the CUDA
    occupancy calculator reports it."""
    return _kernels.query("dq_qr_blocks_per_sm", device, _DTYPE_CODES[dtype],
                          n)


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
    "qr"/"qr_complex" (K2/K2c, one CTA in shared memory) up to
    ``ONE_CTA_LAST_N`` where its body's shared memory fits, else
    "qr_big"/"qr_complex_big" (K7) up to MAX_N_BIG; raises beyond."""
    kernel = _ENTRIES[dtype][0]
    if n <= ONE_CTA_LAST_N[dtype] and (one_cta_smem_bytes(n, dtype)
                                       <= _kernels.MAX_SMEM_BYTES - 1024):
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
# those of the one-CTA tensor-core bodies (f64_tc.cuh: K2 in float64, K3r;
# cplx_tc.cuh: K2 in float32, K2c, K3c-rhs); K2's "apply to M" is the
# update of Q^T and its back-substitution stays 0. K2's probe instances
# are compiled at np = 64 in float64 and at np = 128 in float32 (the
# sdw_o1_l8 shape).
TC_PROBE_PHASES = ("panel", "apply to A", "apply to M",
                   "back-substitution", "barriers", "loads and stores")
_PROBE_ENTRIES = {torch.float32: "dq_qr_probe_f32",
                  torch.float64: "dq_qr_probe_f64",
                  torch.complex64: "dq_qr_probe_c64"}
# the padded size np of each real dtype's K2 probe instance
_PROBE_NP = {torch.float32: 128, torch.float64: 64}


def probe_phases(n: int, dtype):
    """The phase names of the probe instance of the kernel ``kernel_for``
    routes this n and dtype to, if it has one at this n (K7's only at its
    one-CTA plan), else None; K2c's is ``complex_probe_phases``."""
    if kernel_for(n, dtype).endswith("_big"):
        return BIG_PROBE_PHASES if dtype in _BIG_PROBE_ENTRIES else None
    return (TC_PROBE_PHASES if _PROBE_NP.get(dtype) == -(-n // 8) * 8
            else None)


def complex_probe_phases(n: int, dtype):
    """The phase names of K2c's probe instance (complex64 at np = 64, the
    sdw_l4 shape; back-substitution stays 0), else None."""
    return (TC_PROBE_PHASES if dtype == torch.complex64 and -(-n // 8) == 8
            else None)


def qr(A, probe: bool = False):
    """K2 (float32/float64), K2c (complex64/complex128) or K7 (all four):
    CPU tensors run ``qr_plain``; CUDA tensors launch the kernel
    ``kernel_for`` names (contiguous (B, n, n)) or raise. With ``probe``
    (K7 in float64 or complex64, K2 in float64 at n = 57..64 and in
    float32 at n = 121..128, K2c in complex64 at n = 57..64) the
    kernel's
    instance with clock64() stamps runs instead, and the result gains a
    (B, len(phases) + 2) int64 record per CTA (``probe_phases``,
    ``complex_probe_phases``): cycles per phase, total cycles, total
    ns."""
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
    phases = probe_phases(n, A.dtype) or complex_probe_phases(n, A.dtype)
    if probe and (phases is None or plan is not None and plan[0] != 32):
        raise ValueError(f"qr: no phase probe for n={n} {A.dtype} at plan "
                         f"{plan}")
    Q = torch.empty_like(A)
    R = torch.empty_like(A)
    if probe:
        rec = torch.zeros((B, len(phases) + 2), dtype=torch.int64,
                          device=A.device)
        if plan:
            _kernels.launch(kernel, _BIG_PROBE_ENTRIES[A.dtype], A, Q, R, B,
                            n, *plan, rec)
        else:
            _kernels.launch(kernel, _PROBE_ENTRIES[A.dtype], A, Q, R, B, n,
                            rec)
        return Q, R, rec
    if plan:
        _kernels.launch(kernel, _BIG_ENTRIES[A.dtype], A, Q, R, B, n, *plan)
    else:
        _kernels.launch(kernel, _ENTRIES[A.dtype][1], A, Q, R, B, n)
    return Q, R
