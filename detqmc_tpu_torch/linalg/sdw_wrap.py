"""K6: the fused SDW wrap and one-sided B apply — wrappers and plain
versions, with the plain factor applies the model is built from.

Replaces detqmc_tpu/linalg/pallas_sdw_wrap.py (``fused_wrap``, Pallas
kernel ``_kernel``; ``fused_apply_left``, ``_apply_kernel``) on the card
with ``csrc/sdw_wrap.cu`` (see the source's note for the design: row-tile
and column-tile passes through shared memory, a global scratch buffer
between the two halves of a wrap).

Layout (as the model's): dim index = orbital * N + site, h = 4 N; E, Einv
(4, N, N) the per-orbital dense kinetic factors (real values in a complex
tensor, the model's ``expK`` buffers; the kernel reads their real parts);
D, Dinv (W, N, 4, 4) the per-site potential blocks.

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

import torch

from detqmc_tpu_torch.linalg import _kernels
from detqmc_tpu_torch.precision import mm

Q = 4   # orbitals per site
_WRAP = {torch.complex64: "dq_sdw_wrap_c64",
         torch.complex128: "dq_sdw_wrap_c128"}
_APPLY = {torch.complex64: "dq_sdw_apply_c64",
          torch.complex128: "dq_sdw_apply_c128"}
_TILES = (16, 8, 4)


# ---- plain factor applies (X: (..., h, k) or (..., k, h)) -----------------
def _as_orb(X, N):
    return X.reshape(*X.shape[:-2], Q, N, X.shape[-1])


def dv_left(D, X):
    """D_V @ X, D_V block-diagonal per site: D (..., N, 4, 4)."""
    out = torch.einsum("...iab,...bik->...aik", D, _as_orb(X, D.shape[-3]))
    return out.reshape(X.shape)


def dv_right(X, D):
    """X @ D_V."""
    Xo = X.reshape(*X.shape[:-1], Q, D.shape[-3])
    out = torch.einsum("...kai,...iab->...kbi", Xo, D)
    return out.reshape(X.shape)


def kin_left(E, X):
    """blockdiag(E_o) @ X, E (4, N, N)."""
    return mm(E, _as_orb(X, E.shape[-1])).reshape(X.shape)


def kin_right(X, E):
    """X @ blockdiag(E_o)."""
    Xo = X.reshape(*X.shape[:-1], Q, E.shape[-1])
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
def smem_bytes(N: int, dtype, TL: int) -> int:
    """Dynamic shared memory of one line pass (csrc/sdw_wrap.cu)."""
    item = torch.empty((), dtype=dtype).element_size()
    h = Q * N
    return item * (2 * TL * (h + 1) + 16 * N) + item // 2 * N * (N + 1)


def tile_lines(N: int, dtype) -> int:
    """Lines per block: the largest of 16, 8, 4 within the shared-memory
    budget; raises if none fits (N beyond 128 in complex128)."""
    for TL in _TILES:
        if smem_bytes(N, dtype, TL) <= _kernels.MAX_SMEM_BYTES - 1024:
            return TL
    raise ValueError(f"sdw_wrap: N={N} {dtype} exceeds the shared-memory "
                     "budget")


def _check(X, E, D, extra=()):
    _kernels.check_cuda_tensor("X", X, tuple(_WRAP), 3)
    W, h, h2 = X.shape
    N = h // Q
    if h2 != h or h != Q * N:
        raise ValueError(f"sdw_wrap: X shape {tuple(X.shape)} must be "
                         "(W, 4 N, 4 N)")
    for name, t, shape in ((("E", E, (Q, N, N)), ("D", D, (W, N, Q, Q)))
                           + tuple(extra)):
        _kernels.check_cuda_tensor(name, t, (X.dtype,), len(shape))
        if tuple(t.shape) != shape:
            raise ValueError(f"sdw_wrap: {name} shape {tuple(t.shape)} != "
                             f"{shape}")
    return W, N, tile_lines(N, X.dtype)


def wrap(G, E, Einv, D, Dinv, up: bool):
    """K6 wrap: CPU tensors run ``wrap_plain``; CUDA tensors launch the
    kernel (two line passes) or raise."""
    if G.device.type == "cpu":
        return wrap_plain(G, E, Einv, D, Dinv, up)
    W, N, TL = _check(G, E, D, (("Einv", Einv, tuple(E.shape)),
                                ("Dinv", Dinv, tuple(D.shape))))
    tmp = torch.empty_like(G)
    out = torch.empty_like(G)
    _kernels.launch("sdw_wrap", _WRAP[G.dtype], G, tmp, out, E, Einv, D,
                    Dinv, W, N, int(up), TL)
    return out


def apply(X, E, D, herm: bool):
    """K6 apply: CPU tensors run ``apply_plain``; CUDA tensors launch the
    kernel (one line pass) or raise."""
    if X.device.type == "cpu":
        return apply_plain(X, E, D, herm)
    W, N, TL = _check(X, E, D)
    out = torch.empty_like(X)
    _kernels.launch("sdw_apply", _APPLY[X.dtype], X, out, E, D, W, N,
                    int(herm), TL)
    return out
