"""K3 / K3c: the stabilized inner solve — wrapper and plain version, for
the real (K3, float64) and the complex (K3c, complex128) chain, with a
diagonal right-hand side (the equal-time G) or a dense one (the
unequal-time G(tau, 0)).

Replaces the dispatcher detqmc_tpu/linalg/pallas_green.py
(``solve_inner``) and the kernel it sends n <= 128 to,
detqmc_tpu/linalg/pallas_green_lanes.py (``solve_inner_lanes``), and for
the complex SDW chain pallas_cgreen_lanes.py (``solve_inner_complex``),
with ``csrc/green_solve.cu``: Householder QR of the inner matrix applied
to diag(r1), then back-substitution, one CTA per matrix. Matrices beyond
that kernel's shared memory (n > 119 in float64, n > 83 in complex128) go
to K8, ``csrc/green_solve_big.cu``, the counterpart of pallas_green.py's
own column-lane kernel (the dispatcher's n > 128 branch) and of
pallas_cgreen.py (``solve_inner_complex_big``): a blocked Householder
QR on the FP64 tensor cores (``csrc/tc_blocked.cuh``, laid out by
``big_plan``) applied to diag(r1), the matrices in global memory, then the
back-substitution by K9 (``linalg/trinv.py``, the blocked triangular
inverse of pallas_trinv_common.py) on Q^H diag(r1) in place: two
launches. The dense-RHS twins of these TPU kernels,
``solve_inner_lanes_rhs``, ``solve_inner_complex_rhs`` and
``solve_inner_complex_big_rhs``, are the ``_rhs`` entries of the same two
sources (``solve_inner_rhs`` below): the reflectors are applied to the
given RHS instead of diag(r1), the rest is unchanged, and the routing by
n and dtype is the same. The one-CTA solves run on the FP64 tensor
cores with M in registers (built from r1 for the diag(r1) solves): the
complex128 ones, K3c (diag(r1), sdw_l4's sweep) and K3c-rhs (a dense RHS,
its unequal-time anchors), two CTAs per SM up to n = 64
(``rhs_smem_bytes``, ``c128_blocks_per_sm``); the float64 ones, K3
(diag(r1), the Hubbard sweep) and K3r (a dense RHS, the Hubbard
unequal-time anchors), their float64 twin with a panel at one barrier a
column, three CTAs per SM up to n = 64 (``f64_smem_bytes``,
``f64_blocks_per_sm``; the body K2 runs in float64). The real n > 128
dense-RHS solve has no Pallas kernel (the JAX package runs XLA there,
udv.green_tau_zero); K8's real ``_rhs`` entry takes it.

The TPU kernels work in df32 — (hi, lo) f32 pairs emulating ~48-bit
mantissas, four planes for a complex matrix — because the chip has no f64
(detqmc_tpu/linalg/df32.py). The H100 has native f64 and complex128, so
the port takes the inner matrix as it is and keeps every intermediate in
that type: df32 is not ported. The inner matrix of the range-split Green
formula reaches condition ~1e6 at beta = 8, so an f32 step anywhere in
here would cost the stabilized G its accuracy.

Contract:
    solve_inner(inner (B, n, n) f64 or c128, r1 (B, n) f64)
        -> mid = inner^{-1} diag(r1)  (B, n, n), inner's dtype;
    solve_inner_rhs(inner (B, n, n) f64 or c128, rhs (B, n, n) same dtype)
        -> inner^{-1} rhs  (B, n, n).
Both take float64 and complex128 up to qr.MAX_N_BIG. ``solve_inner_plain`` and ``solve_inner_rhs_plain`` (what a
CPU tensor runs) are torch.linalg.qr + solve_triangular, as
detqmc_tpu/linalg/udv.green_from_two_udv and green_tau_zero do it.
"""

from __future__ import annotations

import torch

from detqmc_tpu_torch.linalg import _kernels, trinv
from detqmc_tpu_torch.linalg.qr import (MAX_N_BIG, TC_PROBE_PHASES,
                                        f64_smem_bytes, tc_smem_bytes)

MAX_N = 128
# K8's plans (panel width b, tile width tc, tile buffers nbuf), widest
# first, for the (b, tc) that csrc/green_solve_big.cu compiles: one CTA per
# SM, and two per SM (each within _kernels.TWO_CTA_SMEM_BYTES) when the
# batch has more matrices than the card has SMs
_BIG_PLANS = {torch.float64: ((32, 16, 2), (16, 16, 2), (16, 16, 1)),
              torch.complex128: ((16, 8, 2), (8, 8, 2), (8, 8, 1))}
# complex128 has none: at n = 256 only b = tc = 8 fits twice, and it took
# 30.2 ms at B = 768 against 24.7 ms for one (16, 8, 2) CTA per SM
# (solve_timing.py --plans, PERF.md)
_BIG_PLANS_TWO_CTA = {torch.float64: ((16, 16, 1),),
                      torch.complex128: ()}
_KERNELS = {torch.float64: "solve_inner", torch.complex128:
            "solve_inner_complex"}
# kernel_for's name -> the C entries with diag(r1) and with a dense RHS
_C_ENTRIES = {"solve_inner": ("dq_solve_inner_f64", "dq_solve_inner_rhs_f64"),
              "solve_inner_complex": ("dq_solve_inner_c128",
                                      "dq_solve_inner_rhs_c128"),
              "solve_inner_big": ("dq_solve_inner_big_f64",
                                  "dq_solve_inner_big_rhs_f64"),
              "solve_inner_complex_big": ("dq_solve_inner_big_c128",
                                          "dq_solve_inner_big_rhs_c128")}


def entry(route: str, rhs: bool):
    """(launch-count name, C entry) of ``kernel_for``'s route, with
    diag(r1) or (``rhs``) a dense right-hand side."""
    return (route + "_rhs" if rhs else route), _C_ENTRIES[route][rhs]


def solve_inner_plain(inner, r1):
    Q, R = torch.linalg.qr(inner)
    rhs = Q.mH * r1[..., None, :]
    return torch.linalg.solve_triangular(R, rhs, upper=True)


def solve_inner_rhs_plain(inner, rhs):
    Q, R = torch.linalg.qr(inner)
    return torch.linalg.solve_triangular(R, Q.mH @ rhs, upper=True)


def smem_bytes(n: int, dtype=torch.float64) -> int:
    """Dynamic shared memory of the first one-CTA design, A and M in
    shared memory, which no kernel keeps: ``kernel_for`` routes both
    dtypes by it, so the one-CTA routes keep their limits (n <= 119 in
    float64, n <= 83 in complex128)."""
    item = torch.empty((), dtype=dtype).element_size()
    return item * (2 * n * (n + 1) + 3 * n)


# K8's dynamic shared memory is householder_tc's, as K7's
big_smem_bytes = tc_smem_bytes


def big_plan(n: int, dtype, batch: int = 1, sms: int = _kernels.H100_SMS):
    """(b, tc, nbuf) of K8 at this n, dtype and batch: with more matrices
    than SMs, the widest two-CTA plan that fits; else (or if none fits)
    the widest one-CTA plan within the shared-memory budget."""
    if batch > sms:
        for plan in _BIG_PLANS_TWO_CTA[dtype]:
            if big_smem_bytes(n, dtype, *plan) <= _kernels.TWO_CTA_SMEM_BYTES:
                return plan
    for plan in _BIG_PLANS[dtype]:
        if big_smem_bytes(n, dtype, *plan) <= _kernels.MAX_SMEM_BYTES - 1024:
            return plan
    raise ValueError(f"n={n} {dtype} exceeds K8's shared-memory budget")


def blocks_per_sm(n: int, dtype, plan, rhs: bool = False, device="cuda") -> int:
    """CTAs of K8 (``rhs``: K8-rhs) one SM of ``device`` holds at this
    plan, as the CUDA occupancy calculator reports it."""
    return _kernels.query("dq_solve_inner_big_blocks_per_sm", device,
                          int(dtype == torch.complex128), int(rhs), n, *plan)


def kernel_for(n: int, dtype) -> str:
    """The kernel a CUDA tensor of this size and dtype goes to:
    "solve_inner"/"solve_inner_complex" (K3/K3c, one CTA per matrix) when
    it fits, else "solve_inner_big"/"solve_inner_complex_big"
    (K8) up to qr.MAX_N_BIG; raises beyond."""
    kernel = _KERNELS[dtype]
    if n <= MAX_N and smem_bytes(n, dtype) <= _kernels.MAX_SMEM_BYTES - 1024:
        return kernel
    if n <= MAX_N_BIG:
        return "solve_inner_big" if kernel == "solve_inner" else kernel + "_big"
    raise ValueError(f"solve_inner: n={n} {dtype} exceeds the shared-memory "
                     f"budget of K3 / K3c and n > {MAX_N_BIG} (K8)")


# the phase probe's phases of the one-CTA dense-RHS solves on the tensor
# cores, K3r and K3c-rhs (f64_tc.cuh solve_f64_tc and green_solve.cu
# solve_c128_tc, whose probe instances are compiled at np = 64), in the
# order of their per-CTA records (each record ends with the CTA's total
# cycles and ns)
TC_RHS_PROBE_PHASES = TC_PROBE_PHASES


def rhs_smem_bytes(n: int) -> int:
    """Dynamic shared memory of the complex128 kernels K3c and K3c-rhs
    (cplx_tc.cuh ctc_smem_bytes): A at np x (np + 1), the side
    buffer np x 9, T and V^H V 8 x 9 each, alpha and v's heads (8 each)
    and beta."""
    np_ = -(-n // 8) * 8
    return 16 * (np_ * (np_ + 1) + np_ * 9 + 2 * 8 * 9 + 2 * 8) + 8 * 8


def c128_blocks_per_sm(n: int, rhs: bool = False, device="cuda") -> int:
    """CTAs of K3c (``rhs``: K3c-rhs) one SM of ``device`` holds at this
    n, as the CUDA occupancy calculator reports it."""
    return _kernels.query("dq_solve_inner_c128_blocks_per_sm", device, n,
                          int(rhs))


def f64_blocks_per_sm(n: int, rhs: bool = False, device="cuda") -> int:
    """CTAs of K3 (``rhs``: K3r) one SM of ``device`` holds at this n, as
    the CUDA occupancy calculator reports it."""
    return _kernels.query("dq_solve_inner_f64_blocks_per_sm", device, n,
                          int(rhs))


def rhs_probe_phases(n: int, dtype):
    """The phase names of the dense-RHS kernel ``kernel_for`` routes this
    n and dtype to, if it has a phase probe at this n, else None."""
    if kernel_for(n, dtype).endswith("_big"):
        return None
    return TC_RHS_PROBE_PHASES if -(-n // 8) == 8 else None


def _solve(inner, M, rhs: bool, plan=None, plan9=None, probe=False):
    """inner^{-1} diag(M) (M = r1, (B, n) float64) or, with ``rhs``,
    inner^{-1} M (M (B, n, n) of inner's dtype) on CUDA tensors: checks,
    routes by ``kernel_for`` and launches, or raises. K8's and K8-rhs's
    back-substitution is K9, in place on Q^H M. ``plan`` / ``plan9``
    override ``big_plan`` / ``trinv.plan`` (to time other layouts). With
    ``probe`` (a dense RHS on a one-CTA route) the kernel's instance with
    clock64() stamps runs and the result is (out, its per-CTA record)."""
    _kernels.check_cuda_tensor("inner", inner, tuple(_KERNELS), 3)
    if rhs:
        _kernels.check_cuda_tensor("rhs", M, (inner.dtype,), 3)
    else:
        _kernels.check_cuda_tensor("r1", M, (torch.float64,), 2)
    B, n, n2 = inner.shape
    want = (B, n, n) if rhs else (B, n)
    if n2 != n or tuple(M.shape) != want:
        raise ValueError(f"solve_inner: shapes {tuple(inner.shape)}, "
                         f"{tuple(M.shape)}: need (B, n, n), {want}")
    route = kernel_for(n, inner.dtype)
    kernel, c_entry = entry(route, rhs)
    phases = rhs_probe_phases(n, inner.dtype) if probe and rhs else None
    if probe and not phases:
        raise ValueError(f"solve_inner: no phase probe for n={n} "
                         f"{inner.dtype}{'' if rhs else ' diag(r1)'}")
    out = torch.empty_like(inner)
    if route.endswith("_big"):
        work = torch.empty_like(inner)
        plan = plan or big_plan(n, inner.dtype, B,
                                _kernels.sm_count(inner.device))
        _kernels.launch(kernel, c_entry, inner, M, out, work, B, n, *plan)
        trinv.trinv_(work, out, plan9)  # R^{-1} (Q^H M)
    elif probe:
        rec = torch.zeros((B, len(phases) + 2),
                          dtype=torch.int64, device=inner.device)
        _kernels.launch(kernel, c_entry.replace("_rhs_", "_rhs_probe_"),
                        inner, M, out, B, n, rec)
        return out, rec
    else:
        _kernels.launch(kernel, c_entry, inner, M, out, B, n)
    return out


def solve_inner(inner, r1):
    """K3 (float64), K3c (complex128) or K8 + K9 (both): CPU tensors run
    ``solve_inner_plain``; CUDA tensors launch the kernel ``kernel_for``
    names (contiguous, r1 float64) or raise."""
    if inner.device.type == "cpu":
        return solve_inner_plain(inner, r1)
    return _solve(inner, r1, rhs=False)


def solve_inner_rhs(inner, rhs):
    """The dense-RHS twins of K3 (float64), K3c (complex128) or K8 + K9
    (both), routed by ``kernel_for`` as ``solve_inner``: CPU tensors run
    ``solve_inner_rhs_plain``; CUDA tensors (contiguous, one dtype) launch
    the kernel or raise."""
    if inner.device.type == "cpu":
        return solve_inner_rhs_plain(inner, rhs)
    return _solve(inner, rhs, rhs=True)
