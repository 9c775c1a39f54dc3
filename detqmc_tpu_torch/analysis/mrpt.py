"""Multiple-histogram (Ferrenberg-Swendsen) reweighting over a PT grid.

Reference parity: SURVEY.md §3 "mrpt family" and §4.5: combine the time
series of all parallel-tempering parameter values into continuous
estimates <O>(r) on an arbitrary grid, via the self-consistent
free-energy solve; locate Binder-cumulant crossings between system sizes
and susceptibility maxima; jackknifed errors by repeating the whole solve
per leave-one-block-out set.

Weight model: w_r(conf) = exp(-r * a(conf)) * (r-independent), where
``a`` is the exchange-conjugate action (for the SDW model a = dtau/2 *
sum phi^2 — derivable from the recorded phiSquared series and the run
metadata). Self-consistency (log-domain, MBAR/FS form):

    f_k = -log sum_s exp(-r_k a_s) / sum_j n_j exp(f_j - r_j a_s)

Reweighted averages: <O>(r) = sum_s O_s W_r(s) / sum_s W_r(s),
W_r(s) = exp(-r a_s) / sum_j n_j exp(f_j - r_j a_s).

The port's copy of detqmc_tpu/analysis/mrpt.py. The solve and the
weights run in torch float64 on an explicit device, the card unless
``device`` names another: the same log-domain fixed point (the f_0 = 0
gauge, the ``tol`` / ``max_iter`` stopping rule), the same bisection and
golden-section searches. The JAX package's OpenMP core
(analysis/_native.py) is not copied: it only speeds up the NumPy loop,
and on the card the torch route takes that role; the CPU route here is
the plain version, the counterpart of the JAX class's
``use_native="never"``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

F64 = torch.float64


def _logsumexp(x: torch.Tensor, dim: int) -> torch.Tensor:
    """log sum exp over ``dim`` with the max shift of the JAX module's
    ``_logsumexp`` (the same operations, so the fixed point stops at the
    same iteration)."""
    m = torch.amax(x, dim=dim, keepdim=True)
    out = m + torch.log(torch.sum(torch.exp(x - m), dim=dim, keepdim=True))
    return out.squeeze(dim)


class MultireweightPT:
    """Ferrenberg-Swendsen solver (reference: MultireweightHistosPT) on
    ``device`` (default the card): the series live there as float64
    tensors, ``f`` comes back as a NumPy array."""

    def __init__(self, r_values, actions: List[np.ndarray],
                 observables: Dict[str, List[np.ndarray]], device=None):
        self.device = torch.device("cuda" if device is None else device)
        self.r_values = np.asarray(r_values, np.float64)
        self.actions = actions
        self.observables = observables
        self.n_k = np.array([len(a) for a in actions])
        self._r = torch.as_tensor(self.r_values, device=self.device)
        self._a = torch.as_tensor(np.concatenate(actions).astype(np.float64),
                                  device=self.device)          # (S,)
        self._log_n = torch.log(torch.as_tensor(
            self.n_k.astype(np.float64), device=self.device))
        self._f = torch.zeros(len(self.r_values), dtype=F64,
                              device=self.device)
        self._obs: Dict[str, torch.Tensor] = {}
        self._solved = False

    @property
    def f(self) -> np.ndarray:
        return self._f.cpu().numpy()

    def solve(self, tol: float = 1e-10, max_iter: int = 10000) -> None:
        """Self-consistent free energies (log-domain iteration)."""
        r, a, log_n = self._r, self._a, self._log_n
        f = self._f
        for _ in range(max_iter):
            # log denominator per sample: logsumexp_j [log n_j + f_j - r_j a_s]
            z = log_n[None, :] + f[None, :] - torch.outer(a, r)   # (S, R)
            log_den = _logsumexp(z, 1)                            # (S,)
            f_new = -_logsumexp(-r[:, None] * a[None, :]
                                - log_den[None, :], 1)            # (R,)
            f_new = f_new - f_new[0]
            if torch.max(torch.abs(f_new - f)).item() < tol:
                f = f_new
                break
            f = f_new
        self._f = f
        self._solved = True

    # -- reweighted expectations ------------------------------------------------
    def _log_den(self) -> torch.Tensor:
        if not self._solved:
            from detqmc_tpu_torch.exceptions import GeneralError

            raise GeneralError(
                "MultireweightPT used before solve(): call solve() to "
                "fit the free-energy shifts before reweighting")
        z = (self._log_n[None, :] + self._f[None, :]
             - torch.outer(self._a, self._r))
        return _logsumexp(z, 1)

    def log_weights(self, r_targets) -> torch.Tensor:
        """log W_r(s) for each r of ``r_targets``: (len(r_targets), S)."""
        rt = torch.as_tensor(np.atleast_1d(np.asarray(r_targets, np.float64)),
                             device=self.device)
        return -rt[:, None] * self._a[None, :] - self._log_den()[None, :]

    def _series(self, name: str) -> torch.Tensor:
        if name not in self._obs:
            self._obs[name] = torch.as_tensor(
                np.concatenate(self.observables[name]).astype(np.float64),
                device=self.device)
        return self._obs[name]

    def _curve(self, name: str, r_grid) -> torch.Tensor:
        o = self._series(name)
        lw = self.log_weights(r_grid)
        lw = lw - lw.amax(dim=1, keepdim=True)
        w = torch.exp(lw)
        return torch.sum(w * o[None, :], dim=1) / torch.sum(w, dim=1)

    def expectation(self, name: str, r_target: float) -> float:
        return float(self._curve(name, [r_target])[0].item())

    def curve(self, name: str, r_grid: Sequence[float]) -> np.ndarray:
        return self._curve(name, r_grid).cpu().numpy()

    def binder(self, r_target: float, phi2="phiSquared",
               phi4="phiFourth") -> float:
        """U = 1 - <phi^4> / (3 <phi^2>^2) reweighted to r_target."""
        p2 = self.expectation(phi2, r_target)
        p4 = self.expectation(phi4, r_target)
        return float(1.0 - p4 / (3.0 * p2 ** 2))

    def susceptibility_max(self, name: str, r_grid: Sequence[float]):
        vals = self.curve(name, r_grid)
        i = int(np.argmax(vals))
        return float(r_grid[i]), float(vals[i])


def find_binder_intersection(m1: MultireweightPT, m2: MultireweightPT,
                             r_lo: float, r_hi: float,
                             tol: float = 1e-8) -> Optional[float]:
    """Root of U_L1(r) - U_L2(r) by bisection (reference:
    findBinderIntersect)."""
    def g(r):
        return m1.binder(r) - m2.binder(r)

    glo, ghi = g(r_lo), g(r_hi)
    if glo * ghi > 0:
        return None
    for _ in range(200):
        mid = 0.5 * (r_lo + r_hi)
        gm = g(mid)
        if abs(gm) < tol or (r_hi - r_lo) < tol:
            return mid
        if glo * gm <= 0:
            r_hi, ghi = mid, gm
        else:
            r_lo, glo = mid, gm
    return 0.5 * (r_lo + r_hi)


def find_observable_maximum(m: MultireweightPT, name: str,
                            r_lo: float, r_hi: float,
                            tol: float = 1e-8):
    """Location and value of the maximum of the reweighted <O>(r) by
    golden-section search (reference: the mrpt family's susceptibility-
    maximum finders). Assumes <O>(r) is unimodal on [r_lo, r_hi]."""
    g = 0.5 * (np.sqrt(5.0) - 1.0)
    a, b = float(r_lo), float(r_hi)
    c, d = b - g * (b - a), a + g * (b - a)
    fc, fd = m.expectation(name, c), m.expectation(name, d)
    while (b - a) > tol:
        if fc > fd:
            b, d, fd = d, c, fc
            c = b - g * (b - a)
            fc = m.expectation(name, c)
        else:
            a, c, fc = c, d, fd
            d = a + g * (b - a)
            fd = m.expectation(name, d)
    r_star = 0.5 * (a + b)
    return r_star, float(m.expectation(name, r_star))


def _leave_one_out(actions, observables, b: int, n_blocks: int):
    """Leave-one-out block copies of a PT run's series (block b of
    n_blocks deleted from every parameter's series, jackknife
    convention)."""
    acts = []
    obs: Dict[str, List[np.ndarray]] = {k: [] for k in observables}
    for k_idx, a in enumerate(actions):
        nb = len(a) // n_blocks
        mask = np.ones(nb * n_blocks, bool)
        mask[b * nb:(b + 1) * nb] = False
        acts.append(a[:nb * n_blocks][mask])
        for name, series_list in observables.items():
            s = series_list[k_idx][:nb * n_blocks]
            obs[name].append(s[mask])
    return acts, obs


def jackknife_reweighted(
    r_values, actions, observables, estimator:
        Callable[[MultireweightPT], float], n_blocks: int = 10,
        device=None):
    """Jackknifed errors: the WHOLE FS solve repeats per leave-one-out
    block set (reference: mrpt-jk)."""
    full = MultireweightPT(np.asarray(r_values),
                           [a.copy() for a in actions],
                           {k: [s.copy() for s in v]
                            for k, v in observables.items()}, device=device)
    full.solve()
    est_full = estimator(full)

    loo_vals = []
    for b in range(n_blocks):
        acts, obs = _leave_one_out(actions, observables, b, n_blocks)
        m = MultireweightPT(np.asarray(r_values), acts, obs, device=device)
        m.solve()
        loo_vals.append(estimator(m))
    loo = np.array(loo_vals)
    err = np.sqrt((n_blocks - 1) / n_blocks
                  * np.sum((loo - loo.mean()) ** 2))
    est = n_blocks * est_full - (n_blocks - 1) * loo.mean()
    return float(est), float(err)


def jackknife_intersection(run1, run2, r_lo: float, r_hi: float,
                           n_blocks: int = 10, device=None):
    """Jackknifed Binder-cumulant crossing between two PT runs (two
    system sizes): BOTH runs' FS solves repeat per leave-one-out block
    (reference: the jackknifed intersect finders). Each ``run`` is a
    ``(r_values, actions, observables)`` triple; observables must carry
    phiSquared and phiFourth. Returns (r*, err); raises if the full
    solve finds no crossing in [r_lo, r_hi]."""
    def solved(run, b=None):
        r_values, actions, observables = run
        if b is not None:
            actions, observables = _leave_one_out(actions, observables,
                                                  b, n_blocks)
        m = MultireweightPT(np.asarray(r_values), actions, observables,
                            device=device)
        m.solve()
        return m

    full = find_binder_intersection(solved(run1), solved(run2),
                                    r_lo, r_hi)
    if full is None:
        raise ValueError(
            f"no Binder crossing in [{r_lo}, {r_hi}] for the full data")
    loo = []
    for b in range(n_blocks):
        x = find_binder_intersection(solved(run1, b), solved(run2, b),
                                     r_lo, r_hi)
        loo.append(full if x is None else x)
    loo = np.asarray(loo)
    err = np.sqrt((n_blocks - 1) / n_blocks
                  * np.sum((loo - loo.mean()) ** 2))
    est = n_blocks * full - (n_blocks - 1) * loo.mean()
    return float(est), float(err)
