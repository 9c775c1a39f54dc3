"""Observable accumulation, time series, and end-of-run results.

Reference parity: SURVEY.md §3 rows "Observables & accumulation"
(Observable / ScalarObservableHandler / VectorObservableHandler:
insertValue, outputResults) and §6 "Metrics / logging": named observables,
optional full `.series` files, end-of-run `results.values` with
jackknifed errors, all stamped with the run's metadata.

The driver hands over each block's measurement values stacked over
measurements and walkers as NumPy arrays; this handler is host-side NumPy
and consumes them in batches. The port's own copy of
detqmc_tpu/observables.py: the same accumulation and output files.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from detqmc_tpu_torch import statistics
from detqmc_tpu_torch.io.series import SeriesWriter, write_results
from detqmc_tpu_torch.metadata import Metadata


class ObservableHandler:
    """Accumulates per-measurement observable values.

    - scalar observables: values of shape () or (W,) per measurement
      (W walkers are averaged into one sample per measurement)
    - vector observables: shape (k,) or (W, k)

    ``insert_batch`` takes a dict of stacked arrays with a leading
    measurement axis, e.g. from a device chunk of T measurements.
    """

    def __init__(self, outdir: Optional[str] = None, jk_blocks: int = 20,
                 timeseries: bool = False,
                 meta: Optional[Metadata] = None):
        self.outdir = outdir
        self.jk_blocks = jk_blocks
        self.timeseries = timeseries and outdir is not None
        self.meta = meta or {}
        self._scalar: Dict[str, List[np.ndarray]] = {}
        self._vector: Dict[str, List[np.ndarray]] = {}
        self._writers: Dict[str, SeriesWriter] = {}

    def register_vectors(self, names) -> None:
        """Explicitly declare vector observables (a 2-D batch for any name
        here is (T, k), never (T, W)) — models expose
        ``vector_observables`` so classification never falls back to the
        name-suffix heuristic."""
        for n in names:
            self._vector.setdefault(n, [])

    # -- insertion ---------------------------------------------------------
    def insert_batch(self, values: Dict[str, np.ndarray]) -> None:
        """values[name]: (T,), (T, W), (T, k) or (T, W, k) arrays."""
        for name, arr in values.items():
            arr = np.asarray(arr)
            if arr.ndim <= 1 or (arr.ndim == 2 and self._is_walker_axis(
                    name, arr)):
                # scalar observable, maybe with walker axis
                samples = arr if arr.ndim == 1 else arr.mean(axis=1)
                self._scalar.setdefault(name, []).append(
                    np.atleast_1d(samples))
                if self.timeseries:
                    self._series_writer(name).append(np.atleast_1d(samples))
            else:
                # vector observable: average walker axis if present (ndim 3)
                samples = arr if arr.ndim == 2 else arr.mean(axis=1)
                self._vector.setdefault(name, []).append(samples)
                if self.timeseries:
                    self._series_writer(name).append(samples)

    def _is_walker_axis(self, name: str, arr: np.ndarray) -> bool:
        # (T, W) scalar-with-walkers vs (T, k) vector: decided at first
        # insertion by registration; default: 2-D arrays for names ending in
        # "Correlation"/"Vector"/"_k" are vectors.
        if name in self._vector:
            return False
        if name in self._scalar:
            return True
        return not any(tag in name for tag in
                       ("Correlation", "Vector", "_k", "_r"))

    def _series_writer(self, name: str) -> SeriesWriter:
        if name not in self._writers:
            path = os.path.join(self.outdir, f"{name}.series")
            self._writers[name] = SeriesWriter(path, name, meta=self.meta)
        return self._writers[name]

    # -- results -----------------------------------------------------------
    def scalar_series(self, name: str) -> np.ndarray:
        arr = np.concatenate(self._scalar[name], axis=0)
        return arr.mean(axis=1) if arr.ndim == 2 else arr

    def vector_series(self, name: str) -> np.ndarray:
        return np.concatenate(self._vector[name], axis=0)

    @property
    def names(self):
        return list(self._scalar) + list(self._vector)

    def n_samples(self) -> int:
        if self._scalar:
            return sum(a.shape[0] for a in next(iter(self._scalar.values())))
        if self._vector:
            return sum(a.shape[0] for a in next(iter(self._vector.values())))
        return 0

    def results(self) -> Dict[str, Tuple[float, float]]:
        """Jackknifed mean/error for every scalar observable (reference:
        ObservableHandler::outputResults)."""
        out: Dict[str, Tuple[float, float]] = {}
        for name in self._scalar:
            series = self.scalar_series(name)
            nb = min(self.jk_blocks, max(2, len(series) // 2))
            if len(series) < 4:
                out[name] = (float(series.mean()),
                             float(series.std(ddof=1) if len(series) > 1
                                   else 0.0))
            else:
                out[name] = statistics.jackknife(series, nb)
        return out

    def vector_results(self) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
        out = {}
        for name in self._vector:
            if not self._vector[name]:
                continue  # registered but never measured
            series = self.vector_series(name)  # (T, k)
            if series.shape[0] < 2:
                out[name] = (series.mean(axis=0),
                             np.zeros(series.shape[1:]))
                continue
            nb = min(self.jk_blocks, max(2, series.shape[0] // 2),
                     series.shape[0])
            blocks = statistics.rebin(series, nb)
            B = blocks.shape[0]
            mean = blocks.mean(axis=0)
            loo = (blocks.sum(axis=0)[None] - blocks) / (B - 1)
            err = np.sqrt((B - 1) / B * ((loo - loo.mean(0)) ** 2).sum(0))
            out[name] = (mean, err)
        return out

    def write_output(self) -> None:
        """Write results.values + per-vector result files (reference file
        contracts, SURVEY.md §6)."""
        if self.outdir is None:
            return
        os.makedirs(self.outdir, exist_ok=True)
        write_results(os.path.join(self.outdir, "results.values"),
                      self.results(), meta=self.meta)
        for name, (mean, err) in self.vector_results().items():
            path = os.path.join(self.outdir, f"results-{name}.values")
            with open(path, "w") as f:
                f.write(f"# index mean error ({name})\n")
                for i, (m_, e_) in enumerate(zip(mean, err)):
                    f.write(f"{i} {m_!r} {e_!r}\n")

    # -- checkpoint support ---------------------------------------------------
    def state_dict(self) -> Dict[str, np.ndarray]:
        out = {}
        for name in self._scalar:
            if self._scalar[name]:
                out[f"scalar:{name}"] = np.concatenate(self._scalar[name], 0)
        for name in self._vector:
            if self._vector[name]:
                out[f"vector:{name}"] = np.concatenate(self._vector[name], 0)
        return out

    def load_state_dict(self, d: Dict[str, np.ndarray]) -> None:
        self._scalar.clear()
        self._vector.clear()
        for key, arr in d.items():
            kind, _, name = key.partition(":")
            if kind == "scalar":
                self._scalar[name] = [np.asarray(arr)]
            else:
                self._vector[name] = [np.asarray(arr)]
