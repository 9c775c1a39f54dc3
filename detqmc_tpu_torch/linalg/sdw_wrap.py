"""K6: the fused SDW wrap and one-sided B apply — wrappers and plain
versions, with the plain factor applies the model is built from.

Replaces detqmc_tpu/linalg/pallas_sdw_wrap.py (``fused_wrap``, Pallas
kernel ``_kernel``; ``fused_apply_left``, ``_apply_kernel``) on the card
with ``csrc/sdw_wrap.cu`` (see the source's note for the design: row-tile
and column-tile passes through shared memory, the kinetic step
register-tiled on a real copy of E staged once per CTA, a global scratch
buffer between the two halves of a wrap; ``plan`` picks the tiles).

Layout (as the model's): dim index = orbital * N + site, h = q N (q = 4
orbitals for the full opdim-3 model, 2 for the reduced sector); E, Einv
(q, N, N) the per-orbital dense kinetic factors, real: the model's
``expK`` buffers (real values in a complex tensor, or real tensors on the
real opdim-1 chain) or its real copies ``expK_real`` /
``expK_inv_real``, which it builds once and hands to the kernel; D, Dinv
(W, N, q, q) the per-site potential blocks, in G's dtype. The kernel has
instances for complex G at q = 4 and q = 2 and for real G at q = 2; the
real q = 4 chain (the full opdim-1 model) runs the plain versions, as the
JAX model fuses its wrap only on the native-pair chain.

    wrap(G, E, Einv, D, Dinv, up=True)   G' = D . (E @ ((G @ Einv) . Dinv))
    wrap(G, E, Einv, D, Dinv, up=False)  G' = Einv @ (Dinv . ((G . D) @ E))
    apply(X, E, D, herm=False)           X' = D . (E @ X)     (B X)
    apply(X, E, D, herm=True)            X' = E^T @ (D^H . X) (B^H X)

A CPU tensor runs the plain versions, compositions of ``dv_left``,
``dv_right``, ``kin_left`` and ``kin_right`` (einsum and matmul applies,
also the model's route below dim 128 on a CUDA device); a CUDA tensor
launches K6 or raises.
"""

from __future__ import annotations

import functools

import torch

from detqmc_tpu_torch.linalg import _kernels
from detqmc_tpu_torch.precision import mm

Q = 4   # orbitals per site of the full opdim-3 model (the default q)
# (G dtype, q) -> (launch count, C entry) of a wrap and of an apply, as
# linalg/sdw_update.py
_WRAP = {(torch.complex64, 4): ("sdw_wrap", "dq_sdw_wrap_c64"),
         (torch.complex128, 4): ("sdw_wrap", "dq_sdw_wrap_c128"),
         (torch.complex64, 2): ("sdw_wrap_q2", "dq_sdw_wrap_q2_c64"),
         (torch.complex128, 2): ("sdw_wrap_q2", "dq_sdw_wrap_q2_c128"),
         (torch.float32, 2): ("sdw_wrap_q2_real", "dq_sdw_wrap_q2_f32"),
         (torch.float64, 2): ("sdw_wrap_q2_real", "dq_sdw_wrap_q2_f64")}
_APPLY = {k: (name.replace("wrap", "apply"), entry.replace("wrap", "apply"))
          for k, (name, entry) in _WRAP.items()}
_DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.complex64: 2,
                torch.complex128: 3}
# K6's plans at q = 4 (lines per tile TL, orbitals of F staged together
# og, line buffers nb), in order of preference: F staged once per CTA
# (og = 4) with a prefetch buffer, the widest tile first, then without
# one; then F staged per tile (``plans`` maps them to q = 2)
_PLANS = ((32, 4, 3), (16, 4, 3), (8, 4, 3), (4, 4, 3), (16, 4, 2),
          (8, 4, 2), (16, 2, 3), (16, 1, 3), (8, 2, 3), (8, 1, 3), (4, 2, 3),
          (4, 1, 3), (8, 1, 2), (4, 1, 2))
_THREADS = 256   # csrc/common.cuh kThreads


def plans(q: int = Q):
    """K6's plans at q orbitals: ``_PLANS`` with og scaled by q / 4 (all,
    half or one orbital of F staged together), repeats dropped."""
    return tuple(dict.fromkeys((TL, max(1, og * q // Q), nb)
                               for TL, og, nb in _PLANS))


def lines_per_thread(dtype) -> int:
    """csrc/sdw_wrap.cu k6_rt: lines of a thread's kinetic block (2 in
    double precision, else 4)."""
    return 2 if dtype.to_real() == torch.float64 else 4


# ---- plain factor applies (X: (..., h, k) or (..., k, h)) -----------------
def _as_orb(X, N):
    return X.reshape(*X.shape[:-2], X.shape[-2] // N, N, X.shape[-1])


def dv_left(D, X):
    """D_V @ X, D_V block-diagonal per site: D (..., N, q, q)."""
    out = torch.einsum("...iab,...bik->...aik", D, _as_orb(X, D.shape[-3]))
    return out.reshape(X.shape)


def dv_right(X, D):
    """X @ D_V."""
    Xo = X.reshape(*X.shape[:-1], D.shape[-1], D.shape[-3])
    out = torch.einsum("...kai,...iab->...kbi", Xo, D)
    return out.reshape(X.shape)


def kin_left(E, X):
    """blockdiag(E_o) @ X, E (q, N, N)."""
    return mm(E, _as_orb(X, E.shape[-1])).reshape(X.shape)


def kin_right(X, E):
    """X @ blockdiag(E_o)."""
    Xo = X.reshape(*X.shape[:-1], E.shape[0], E.shape[-1])
    return torch.einsum("...kom,omn->...kon", Xo, E).reshape(X.shape)


def wrap_plain(G, E, Einv, D, Dinv, up: bool):
    if up:
        return dv_left(D, kin_left(E, dv_right(kin_right(G, Einv), Dinv)))
    return kin_left(Einv, dv_left(Dinv, kin_right(dv_right(G, D), E)))


def apply_plain(X, E, D, herm: bool):
    if herm:
        return kin_left(E.transpose(-1, -2), dv_left(D.mH, X))
    return dv_left(D, kin_left(E, X))


# ---- the kernel --------------------------------------------------------------
def smem_bytes(N: int, dtype, TL: int, og: int, nb: int, q: int = Q) -> int:
    """Dynamic shared memory of one line pass (csrc/sdw_wrap.cu
    k6_smem_bytes): nb line buffers of h x (TL + line pad), h = q N, the
    line pad 16 bytes (none at TL = 4); D's blocks (q^2 N); og orbitals of
    the real F at N x (round_up(N, 4) + F pad)."""
    item = dtype.itemsize
    ritem = dtype.to_real().itemsize
    ldt = TL + (16 // item if TL >= 8 else 0)
    ldf = -(-N // 4) * 4 + (2 if ritem == 8 else 4)
    return item * (nb * q * N * ldt + q * q * N) + ritem * og * N * ldf


def kinetic_blocks(N: int, dtype, TL: int, og: int) -> int:
    """Threads' blocks of one kinetic step (per group of og orbitals)."""
    return og * -(-N // 4) * (TL // lines_per_thread(dtype))


def has_instance(dtype, q: int = Q) -> bool:
    """Whether K6 has an instance for G of ``dtype`` at q orbitals."""
    return (dtype, q) in _WRAP


@functools.lru_cache(maxsize=None)
def plan(N: int, dtype, W: int = 1, sms: int = _kernels.H100_SMS,
         q: int = Q):
    """(TL, og, nb, tpc) of K6 (computed once a shape: the wrappers ask
    at every call). At q = 4: the first of ``plans(4)`` within the
    shared-memory budget whose kinetic step has a block for every thread
    (else the first within the budget), and tpc tiles per CTA so that a
    walker's tiles spread over max(1, sms // W) CTAs (one CTA per walker
    at W >= sms). At q = 2 (the reduced sectors): the first of
    ``plans(2)`` with a prefetch buffer (nb = 3) that fits two CTAs per SM
    and has a block for every thread of its kinetic step, its tiles
    spread over max(1, 2 sms // W) CTAs (W = 128: a walker's tiles on two
    CTAs, 256 CTAs in one wave at two per SM, each staging F once; the
    float32 N = 64 of sdw_o1_l8); where none does, the q = 4 rule. Raises
    if no plan fits (N beyond 128 in complex128 at q = 4)."""
    budget = _kernels.MAX_SMEM_BYTES - 1024
    fit = [p for p in plans(q) if smem_bytes(N, dtype, *p, q=q) <= budget]
    if not fit:
        raise ValueError(f"sdw_wrap: N={N} q={q} {dtype} exceeds the "
                         "shared-memory budget")
    twice = [p for p in fit if q != Q and p[2] == 3
             and smem_bytes(N, dtype, *p, q=q) <= _kernels.TWO_CTA_SMEM_BYTES
             and kinetic_blocks(N, dtype, p[0], p[1]) >= _THREADS]
    if twice:
        (TL, og, nb), per_sm = twice[0], 2
    else:
        full = [p for p in fit
                if kinetic_blocks(N, dtype, p[0], p[1]) >= _THREADS]
        (TL, og, nb), per_sm = (full or fit)[0], 1
    tiles = -(-q * N // TL)
    ctas = max(1, min(tiles, per_sm * sms // max(W, 1)))
    return TL, og, nb, -(-tiles // ctas)


def blocks_per_sm(N: int, dtype, plan, device="cuda", q: int = Q) -> int:
    """CTAs of a K6 line pass one SM of ``device`` holds at this plan
    (TL, og, nb, ...), as the CUDA occupancy calculator reports it."""
    if q == Q:
        return _kernels.query("dq_sdw_wrap_blocks_per_sm", device,
                              int(dtype == torch.complex128), N, *plan[:3])
    return _kernels.query("dq_sdw_wrap_q2_blocks_per_sm", device,
                          _DTYPE_CODES[dtype], N, *plan[:3])


def ctas(N: int, W: int, TL: int, tpc: int, q: int = Q) -> int:
    """CTAs of one line pass at this plan."""
    tiles = -(-q * N // TL)
    return W * -(-tiles // tpc)


def launch_name(dtype, q: int, apply_: bool = False) -> str:
    """The launch count (``_kernels.LAUNCHES``) of the wrap (or apply)
    instance for G of ``dtype`` and q orbitals."""
    return (_APPLY if apply_ else _WRAP)[(dtype, q)][0]


def real_factor(E, dtype):
    """The real kinetic factor K6 reads, for G of ``dtype``: E itself if it
    is already the real copy, else its real part (the model builds it
    once: ``SDWModel.expK_real``)."""
    rdt = dtype.to_real()
    if E.is_complex():
        E = E.real
    if E.dtype != rdt:
        raise TypeError(f"sdw_wrap: E dtype {E.dtype}, need {rdt} for "
                        f"{dtype}")
    return E.contiguous()


def _check(X, E, D, extra=()):
    q = E.shape[0] if E.ndim == 3 else 0
    if (X.dtype, q) not in _WRAP:
        raise NotImplementedError(
            f"sdw_wrap: no K6 instance for {X.dtype} at q = {q} (the real "
            "q = 4 chain runs the plain wraps, as the JAX model does)")
    _kernels.check_cuda_tensor("X", X, (X.dtype,), 3)
    W, h, h2 = X.shape
    N = h // q
    if h2 != h or h != q * N or E.shape[1] != N:
        raise ValueError(f"sdw_wrap: X shape {tuple(X.shape)} must be "
                         f"(W, q N, q N) for E of shape {tuple(E.shape)}")
    rdt = X.dtype.to_real()
    for name, t, shape in ((("E", E, (q, N, N)), ("D", D, (W, N, q, q)))
                           + tuple(extra)):
        kinetic = len(shape) == 3
        _kernels.check_cuda_tensor(name, t, (rdt,) if kinetic else
                                   (X.dtype,), len(shape))
        if tuple(t.shape) != shape:
            raise ValueError(f"sdw_wrap: {name} shape {tuple(t.shape)} != "
                             f"{shape}")
    return W, N, q, plan(N, X.dtype, W, _kernels.sm_count(X.device), q)


# the phase probe's phases of K6 (sdw_wrap.cu), in the order of its per-CTA
# record; the record ends with the CTA's total cycles and ns. The probe
# instances: complex64 at q = 4 (sdw_l8) and q = 2 (sdw_o2_l8), float32 at
# q = 2 (sdw_o1_l8), the main paths' K6; (G dtype, q) -> the C entries of
# the wrap and the apply
PROBE_PHASES = ("F staging", "kinetic step", "D step",
                "line loads and stores")
_PROBE_ENTRIES = {(torch.complex64, 4): "c64", (torch.complex64, 2): "q2_c64",
                  (torch.float32, 2): "q2_f32"}


def has_probe(dtype, q: int = Q) -> bool:
    """Whether K6 has a phase-probe instance for G of ``dtype`` at q."""
    return (dtype, q) in _PROBE_ENTRIES


def _probe_record(X, n_ctas: int, q: int, probe: bool):
    if not probe:
        return None
    if not has_probe(X.dtype, q):
        raise ValueError(f"sdw_wrap: no phase probe for {X.dtype} q={q}")
    return torch.zeros((n_ctas, len(PROBE_PHASES) + 2), dtype=torch.int64,
                       device=X.device)


def _like(E, dtype):
    """E in G's dtype for the plain applies (the real part of a complex E
    for real G)."""
    if E.is_complex() and not dtype.is_complex:
        E = E.real
    return E.to(dtype)


def wrap(G, E, Einv, D, Dinv, up: bool, probe: bool = False):
    """K6 wrap: CPU tensors run ``wrap_plain``; CUDA tensors launch the
    kernel (two line passes) or raise. E, Einv in G's dtype or their real
    copies. With ``probe`` (``has_probe``: complex64 at q = 4 and 2,
    float32 at q = 2) the kernel's instance with clock64() stamps runs,
    and the result is (G', the per-CTA record of both passes)."""
    if G.device.type == "cpu":
        if probe:
            raise ValueError("sdw_wrap: the probe needs a CUDA tensor")
        return wrap_plain(G, _like(E, G.dtype), _like(Einv, G.dtype), D,
                          Dinv, up)
    E, Einv = real_factor(E, G.dtype), real_factor(Einv, G.dtype)
    W, N, q, (TL, og, nb, tpc) = _check(
        G, E, D, (("Einv", Einv, tuple(E.shape)),
                  ("Dinv", Dinv, tuple(D.shape))))
    tmp = torch.empty_like(G)
    out = torch.empty_like(G)
    args = (G, tmp, out, E, Einv, D, Dinv, W, N, int(up), TL, og, nb, tpc)
    rec = _probe_record(G, 2 * ctas(N, W, TL, tpc, q), q, probe)
    if rec is not None:
        _kernels.launch(_WRAP[(G.dtype, q)][0], "dq_sdw_wrap_probe_"
                        + _PROBE_ENTRIES[(G.dtype, q)], *args, rec)
        return out, rec
    _kernels.launch(*_WRAP[(G.dtype, q)], *args)
    return out


def apply(X, E, D, herm: bool, probe: bool = False):
    """K6 apply: CPU tensors run ``apply_plain``; CUDA tensors launch the
    kernel (one line pass) or raise. With ``probe`` as ``wrap``."""
    if X.device.type == "cpu":
        if probe:
            raise ValueError("sdw_wrap: the probe needs a CUDA tensor")
        return apply_plain(X, _like(E, X.dtype), D, herm)
    E = real_factor(E, X.dtype)
    W, N, q, (TL, og, nb, tpc) = _check(X, E, D)
    out = torch.empty_like(X)
    args = (X, out, E, D, W, N, int(herm), TL, og, nb, tpc)
    rec = _probe_record(X, ctas(N, W, TL, tpc, q), q, probe)
    if rec is not None:
        _kernels.launch(_APPLY[(X.dtype, q)][0], "dq_sdw_apply_probe_"
                        + _PROBE_ENTRIES[(X.dtype, q)], *args, rec)
        return out, rec
    _kernels.launch(*_APPLY[(X.dtype, q)], *args)
    return out
