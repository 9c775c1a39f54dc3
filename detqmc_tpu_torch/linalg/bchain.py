"""B-matrix application: dense and checkerboard kinetic propagators.

Port of detqmc_tpu.linalg.bchain. A slice propagator is

    B_l = diag(e_l) @ E_K,   E_K = exp(-dtau (K - mu)),

with the potential diagonal LEFT of the kinetic factor, so that a flip at
slice l is a left rank-1 perturbation of the chain and the textbook ratio
R = 1 + delta (1 - G(l)_ii) holds with G at slice l itself.

The kinetic apply is one dense matmul, or the 2d-bond-group checkerboard
factorization applied as sequential gather+axpy passes (``cb_apply =
"sparse"``), or the exact dense product of those factors (``cb_dense``).
All functions broadcast over leading batch dims (walkers, components).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from detqmc_tpu.lattice import kinetic_exponentials
from detqmc_tpu_torch.precision import mm


class Propagators(NamedTuple):
    """Static per-run propagator data."""

    expK: torch.Tensor        # (N, N) dense exp(-dtau (K - mu))
    expK_inv: torch.Tensor    # (N, N)
    cb_partner: torch.Tensor  # (groups, N) int64 bond-partner tables
    cb_cosh: torch.Tensor     # (groups,) cosh(dtau t) per group
    cb_sinh: torch.Tensor     # (groups,) sinh per group
    cb_gamma: torch.Tensor    # (N,) exp(dtau mu) onsite piece


def make_propagators(lat, t: float, dtau: float, mu: float,
                     dtype=torch.float32, device=None,
                     checkerboard: bool = False,
                     cb_dense: bool = False) -> Propagators:
    """``cb_dense``: replace expK/expK_inv by the EXACT dense product of the
    checkerboard factors (inverse from the per-factor inverses); callers
    then use the dense apply. Tables are built in float64 numpy and cast."""
    K = lat.hopping_matrix(t)
    expK, expK_inv = kinetic_exponentials(K, dtau, mu)
    n_groups = 2 * getattr(lat, "d", 2)
    if checkerboard:
        partner = lat.checkerboard_groups()
        n_groups = partner.shape[0]
        gamma = np.full(lat.n_sites, np.exp(dtau * mu))
    else:
        partner = np.zeros((n_groups, lat.n_sites), dtype=np.int64)
        gamma = np.ones(lat.n_sites)
    c = np.cosh(dtau * t) * np.ones(n_groups)
    s = np.sinh(dtau * t) * np.ones(n_groups)
    if checkerboard and cb_dense:
        E = np.eye(lat.n_sites)
        Einv = np.eye(lat.n_sites)
        for g in reversed(range(n_groups)):  # E = F0 F1 ... (F_last first)
            E = c[g] * E + s[g] * E[partner[g], :]
        for g in range(n_groups):            # E^{-1} = F'_last ... F'_0
            Einv = c[g] * Einv - s[g] * Einv[partner[g], :]
        expK = gamma[:, None] * E
        expK_inv = Einv * (1.0 / gamma)[None, :]

    def as_t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    return Propagators(
        expK=as_t(expK), expK_inv=as_t(expK_inv),
        cb_partner=as_t(partner, torch.int64),
        cb_cosh=as_t(c), cb_sinh=as_t(s), cb_gamma=as_t(gamma))


# -- kinetic applies --------------------------------------------------------

def kinetic_mult_left(prop: Propagators, X: torch.Tensor, *,
                      inv: bool = False, transpose: bool = False,
                      checkerboard: bool = False) -> torch.Tensor:
    """E_K @ X (or E_K^{-1} @ X / E_K^T @ X).

    The checkerboard product E_cb = F_0 F_1 ... has E_cb^T = ... F_1 F_0
    (each factor symmetric), and F_g^{-1} flips the sinh sign: the group
    order is reversed iff transpose == inv."""
    if not checkerboard:
        E = prop.expK_inv if inv else prop.expK
        if transpose:
            E = E.transpose(-1, -2)
        return mm(E, X)
    ng = prop.cb_partner.shape[0]
    groups = list(range(ng))[::-1] if transpose == inv else list(range(ng))
    sgn = -1.0 if inv else 1.0
    out = X
    if inv:
        out = out / prop.cb_gamma[..., :, None]
    for g in groups:
        out = (prop.cb_cosh[g] * out
               + (sgn * prop.cb_sinh[g])
               * torch.index_select(out, -2, prop.cb_partner[g]))
    if not inv:
        out = prop.cb_gamma[..., :, None] * out
    return out


def kinetic_mult_right(prop: Propagators, X: torch.Tensor, *,
                       inv: bool = False, transpose: bool = False,
                       checkerboard: bool = False) -> torch.Tensor:
    """X @ E_K (or X @ E_K^{-1} / X @ E_K^T)."""
    if not checkerboard:
        E = prop.expK_inv if inv else prop.expK
        if transpose:
            E = E.transpose(-1, -2)
        return mm(X, E)
    ng = prop.cb_partner.shape[0]
    groups = list(range(ng))
    if transpose != inv:
        groups = groups[::-1]
    sgn = -1.0 if inv else 1.0
    out = X
    if inv:
        out = out / prop.cb_gamma[..., None, :]
    for g in groups:
        out = (prop.cb_cosh[g] * out
               + (sgn * prop.cb_sinh[g])
               * torch.index_select(out, -1, prop.cb_partner[g]))
    if not inv:
        out = out * prop.cb_gamma[..., None, :]
    return out


# -- full B applies ---------------------------------------------------------
# B = diag(e) E_K; e is the exp-potential diagonal, batched (..., N).

def b_mult_left(prop, e, X, *, checkerboard=False):
    """B @ X = e * (E_K X)."""
    return e[..., :, None] * kinetic_mult_left(
        prop, X, checkerboard=checkerboard)


def b_inv_mult_left(prop, e, X, *, checkerboard=False):
    """B^{-1} @ X = E_K^{-1} ((1/e) * X)."""
    return kinetic_mult_left(prop, (1.0 / e)[..., :, None] * X, inv=True,
                             checkerboard=checkerboard)


def b_mult_right(prop, X, e, *, checkerboard=False):
    """X @ B = (X * e) E_K."""
    return kinetic_mult_right(prop, X * e[..., None, :],
                              checkerboard=checkerboard)


def b_inv_mult_right(prop, X, e, *, checkerboard=False):
    """X @ B^{-1} = (X E_K^{-1}) * (1/e)."""
    return kinetic_mult_right(prop, X, inv=True, checkerboard=checkerboard) \
        * (1.0 / e)[..., None, :]


def bT_mult_left(prop, e, X, *, checkerboard=False):
    """B^T @ X = E_K^T (e * X) — extends the transposed right stack."""
    return kinetic_mult_left(prop, e[..., :, None] * X, transpose=True,
                             checkerboard=checkerboard)
