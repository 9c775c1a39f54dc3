"""Statistics: binning, block jackknife, integrated autocorrelation time.

Reference parity: SURVEY.md §3 row "Statistics" (src/statistics.h —
``average``, ``jackknife`` with jkBlocks convention) and §9 "Jackknife".
Pure NumPy — this is host-side analysis, not device code. The port's own
copy of detqmc_tpu/statistics.py.

Conventions (must match the reference so results are comparable):
- jackknife with B blocks: leave-one-block-out means o_b;
  sigma^2 = (B-1)/B * sum_b (o_b - o_mean)^2, with o_mean the mean of the
  leave-one-out estimates; bias-corrected estimate B*full - (B-1)*o_mean.
- series that do not divide evenly into blocks drop the tail remainder.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np


def average(series: np.ndarray) -> float:
    return float(np.mean(series))


def variance(series: np.ndarray) -> float:
    return float(np.var(series))


def rebin(series: np.ndarray, n_blocks: int) -> np.ndarray:
    """Block means: reshape the series into n_blocks equal blocks (tail
    dropped) and average within each. Works on (T,) or (T, ...) arrays."""
    if n_blocks < 1:
        raise ValueError("n_blocks must be >= 1")
    T = series.shape[0]
    block = T // n_blocks
    if block < 1:
        raise ValueError(
            f"series of length {T} cannot form {n_blocks} blocks")
    trimmed = series[: block * n_blocks]
    shaped = trimmed.reshape(n_blocks, block, *series.shape[1:])
    return shaped.mean(axis=1)


def jackknife(series: np.ndarray, n_blocks: int = 20,
              estimator: Callable[[np.ndarray], float] | None = None
              ) -> Tuple[float, float]:
    """(estimate, error) via block jackknife.

    ``estimator`` maps a 1-D (or (T, ...)) sample array to a scalar; default
    is the mean. Nonlinear estimators (Binder cumulants, susceptibilities)
    are handled by re-evaluating the estimator on each leave-one-out set —
    the reference does the same (SURVEY.md §9 "Jackknife").
    """
    if estimator is None:
        estimator = lambda x: float(np.mean(x, axis=0))  # noqa: E731
    blocks = rebin(series, n_blocks)
    B = blocks.shape[0]
    full = estimator(blocks)
    loo = np.array([
        estimator(np.delete(blocks, b, axis=0)) for b in range(B)
    ])
    loo_mean = loo.mean(axis=0)
    err = np.sqrt((B - 1) / B * np.sum((loo - loo_mean) ** 2, axis=0))
    est = B * np.asarray(full) - (B - 1) * loo_mean  # bias corrected
    return float(est), float(err)


def jackknife_multi(
    series_list: Sequence[np.ndarray], n_blocks: int,
    estimator: Callable[..., float],
) -> Tuple[float, float]:
    """Jackknife for estimators of several jointly-sampled series (e.g.
    Binder U = 1 - <phi^4>/(3 <phi^2>^2) needs two series)."""
    blocks = [rebin(s, n_blocks) for s in series_list]
    B = blocks[0].shape[0]
    full = estimator(*[b.mean(axis=0) for b in blocks])
    loo = np.array([
        estimator(*[np.delete(b, k, axis=0).mean(axis=0) for b in blocks])
        for k in range(B)
    ])
    loo_mean = loo.mean(axis=0)
    err = np.sqrt((B - 1) / B * np.sum((loo - loo_mean) ** 2, axis=0))
    est = B * np.asarray(full) - (B - 1) * loo_mean
    return float(est), float(err)


def binning_error(series: np.ndarray, min_blocks: int = 32) -> float:
    """Autocorrelation-robust error: block the series at increasing block
    sizes until the naive block error plateaus; return the largest."""
    T = len(series)
    errs = []
    size = 1
    while T // size >= min_blocks:
        nb = T // size
        blocks = rebin(series, nb)
        errs.append(np.std(blocks, ddof=1) / np.sqrt(nb))
        size *= 2
    return float(max(errs)) if errs else float(
        np.std(series, ddof=1) / np.sqrt(max(T, 1)))


def tau_int(series: np.ndarray, c: float = 8.0) -> float:
    """Integrated autocorrelation time with the standard self-consistent
    window W >= c * tau (reference: tauintsimple tool, SURVEY.md §3).

    tau_int = 1/2 + sum_{t=1}^{W} rho(t).
    """
    x = np.asarray(series, dtype=np.float64)
    T = len(x)
    if T < 8:
        return 0.5
    x = x - x.mean()
    var = np.dot(x, x) / T
    if var == 0:
        return 0.5
    # FFT autocorrelation
    n_fft = 1
    while n_fft < 2 * T:
        n_fft *= 2
    f = np.fft.rfft(x, n_fft)
    acf = np.fft.irfft(f * np.conj(f), n_fft)[:T].real
    rho = acf / acf[0]
    tau = 0.5
    for t in range(1, T):
        tau += rho[t]
        if t >= c * tau:
            break
    return float(max(tau, 0.5))


def effective_samples(series: np.ndarray) -> float:
    return len(series) / (2.0 * tau_int(series))
