"""Periodic hypercubic lattices: neighbor tables, checkerboard bond
groups, hopping matrices, momentum grids and the kinetic exponentials.

The port's own copy of what it uses from detqmc_tpu/lattice.py (numpy
only, computed once at model setup and turned into device buffers), so
that the port imports nothing of the JAX package. The tables are the
reference's, index for index: the tests build both models from one
config and compare their buffers' consequences at 1e-12.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class HyperCubicLattice:
    """L^d periodic hypercubic lattice, d in {1, 2, 3}. Site index
    convention: site = sum_ax c_ax * L^ax (axis 0 fastest — for d=2 the
    row-major y*L + x of SquareLattice)."""

    L: int
    d: int = 2

    def __post_init__(self):
        if self.d not in (1, 2, 3):
            raise ValueError(f"d must be 1, 2 or 3, got {self.d}")

    @property
    def n_sites(self) -> int:
        return self.L ** self.d

    # -- coordinates ------------------------------------------------------
    def coords(self, site: np.ndarray) -> np.ndarray:
        """(..., d) coordinates, axis 0 fastest."""
        site = np.asarray(site)
        return np.stack([(site // self.L ** ax) % self.L
                         for ax in range(self.d)], axis=-1)

    def site_of(self, coords: np.ndarray) -> np.ndarray:
        """(..., d) coordinates (any integers; wrapped) -> site index."""
        c = np.asarray(coords) % self.L
        s = np.zeros(c.shape[:-1], dtype=np.int64)
        for ax in range(self.d):
            s = s + c[..., ax] * self.L ** ax
        return s

    # -- neighbor table ---------------------------------------------------
    def neighbors(self) -> np.ndarray:
        """(N, 2d) int array: +ax0, -ax0, +ax1, -ax1, ... periodic nn."""
        s = np.arange(self.n_sites)
        c = self.coords(s)
        cols = []
        for ax in range(self.d):
            step = np.zeros(self.d, dtype=np.int64)
            step[ax] = 1
            cols.append(self.site_of(c + step))
            cols.append(self.site_of(c - step))
        return np.stack(cols, axis=1)

    # -- hopping matrix ---------------------------------------------------
    def hopping_matrix(self, t: float = 1.0, tx: float | None = None,
                       ty: float | None = None) -> np.ndarray:
        """Dense tight-binding matrix K with K[i, j] = -t for nn pairs;
        ``tx``/``ty`` set anisotropic hopping along axes 0/1 (the SDW
        model's bands; d >= 2 for ``ty``)."""
        ts = [t] * self.d
        if tx is not None:
            ts[0] = tx
        if ty is not None:
            if self.d < 2:
                raise ValueError("ty needs d >= 2")
            ts[1] = ty
        N = self.n_sites
        K = np.zeros((N, N))
        s = np.arange(N)
        c = self.coords(s)
        for ax in range(self.d):
            step = np.zeros(self.d, dtype=np.int64)
            step[ax] = 1
            K[s, self.site_of(c + step)] -= ts[ax]
            K[s, self.site_of(c - step)] -= ts[ax]
        return K

    # -- checkerboard bond groups ----------------------------------------
    def checkerboard_groups(self) -> np.ndarray:
        """Partner tables (2d, N) of the checkerboard breakup's bond groups
        (groups 2*ax / 2*ax+1 = axis-ax bonds starting at even/odd
        coordinate). For even L each group is a perfect matching:
        ``partner[g]`` is an involutive permutation, so a group factor is
        one gather + axpy."""
        if self.L % 2 != 0:
            raise ValueError(
                f"checkerboard breakup requires even L, got L={self.L}")
        N = self.n_sites
        s = np.arange(N)
        c = self.coords(s)
        partner = np.zeros((2 * self.d, N), dtype=np.int32)
        for ax in range(self.d):
            step = np.zeros(self.d, dtype=np.int64)
            step[ax] = 1
            fwd = self.site_of(c + step)
            bwd = self.site_of(c - step)
            par = c[:, ax] % 2
            partner[2 * ax] = np.where(par == 0, fwd, bwd)
            partner[2 * ax + 1] = np.where(par == 1, fwd, bwd)
        for g in range(2 * self.d):
            if not (partner[g][partner[g]] == s).all():
                raise AssertionError(f"bond group {g} is not a matching")
        return partner

    # -- momentum grid ----------------------------------------------------
    def k_grid(self) -> np.ndarray:
        """(N, d) array of momenta 2*pi*n/L, same ordering as sites."""
        return 2.0 * np.pi / self.L * self.coords(np.arange(self.n_sites))

    def fourier_phases(self) -> np.ndarray:
        """(N_k, N_r) matrix exp(-i k.r) for structure factors."""
        k = self.k_grid()
        r = self.coords(np.arange(self.n_sites)).astype(np.float64)
        return np.exp(-1j * (k @ r.T))

    def stagger(self) -> np.ndarray:
        """(-1)^(sum of coordinates): the AF / particle-hole staggering."""
        return (-1.0) ** self.coords(np.arange(self.n_sites)).sum(axis=-1)

    def dwave_form_factor(self) -> np.ndarray:
        """(N, N) d_{x2-y2} pair form factor of a d = 2 lattice: +1 for the
        x neighbors, -1 for the y neighbors of each site."""
        if self.d != 2:
            raise ValueError("the d-wave form factor needs d = 2")
        s, nb = np.arange(self.n_sites), self.neighbors()
        D = np.zeros((self.n_sites, self.n_sites))
        for col, sgn in ((0, 1.0), (1, 1.0), (2, -1.0), (3, -1.0)):
            np.add.at(D, (s, nb[:, col]), sgn)
        return D


@dataclasses.dataclass(frozen=True)
class SquareLattice(HyperCubicLattice):
    """L x L periodic square lattice (d = 2) with the (x, y) coordinate
    API of the SDW model."""

    d: int = 2

    def __post_init__(self):
        super().__post_init__()
        if self.d != 2:
            raise ValueError("SquareLattice is d=2; use HyperCubicLattice")

    def xy(self, site: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        return site % self.L, site // self.L

    def site(self, x: np.ndarray, y: np.ndarray) -> np.ndarray:
        return (y % self.L) * self.L + (x % self.L)


def kinetic_exponentials(K: np.ndarray, dtau: float, mu: float = 0.0
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Dense exp(-dtau*(K - mu)) and its inverse via eigendecomposition,
    in float64 on the host (cast to the run dtype by the caller)."""
    w, V = np.linalg.eigh(K)
    expK = (V * np.exp(-dtau * (w - mu))) @ V.T
    expK_inv = (V * np.exp(dtau * (w - mu))) @ V.T
    return expK, expK_inv
