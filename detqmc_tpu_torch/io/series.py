"""Append-on-the-fly time-series files and result maps.

Reference parity: SURVEY.md §3 rows "Time-series IO" (dataserieswritersucc /
dataseriesloader / datamapwriter). File contract kept compatible in spirit:

`<obs>.series`:
    ## key = value          (metadata header lines)
    # <obs>                 (column label)
    v0
    v1
    ...
Vector observables write one whitespace-separated row per measurement.

`results.values` / `vector results`:
    # name mean error
    occupancy 1.0000 0.0001

The port's own copy of detqmc_tpu/io/series.py: the same file formats, so
the port's analysis tools (``detqmc_tpu_torch.analysis``) and the JAX
package's read the port's runs.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from detqmc_tpu_torch.metadata import (Metadata, metadata_to_string,
                                       string_to_metadata)


class SeriesWriter:
    """Incremental .series writer (reference: DataSeriesWriterSucc)."""

    def __init__(self, path: str, name: str,
                 meta: Optional[Metadata] = None):
        self.path = path
        self.name = name
        self._f = None
        if not os.path.exists(path):
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(path, "w") as f:
                if meta:
                    f.write(metadata_to_string(meta, prefix="## "))
                f.write(f"# {name}\n")

    def append(self, values: np.ndarray) -> None:
        """values: scalar, (T,) scalars, or (T, k) vector rows."""
        arr = np.atleast_1d(np.asarray(values))
        with open(self.path, "a") as f:
            if arr.ndim == 1:
                f.write("\n".join(repr(float(v)) for v in arr) + "\n")
            else:
                for row in arr:
                    f.write(" ".join(repr(float(v)) for v in row) + "\n")

    def flush(self) -> None:  # writes are flushed per append
        pass


def load_series(path: str) -> Tuple[np.ndarray, Metadata]:
    """Read a .series file -> (values array, header metadata).

    (Reference: DataSeriesLoader.) Scalar series -> (T,), vector -> (T, k).
    """
    header_lines = []
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith("##"):
                header_lines.append(line[2:].strip())
            elif line.startswith("#"):
                continue
            else:
                rows.append([float(t) for t in line.split()])
    meta = string_to_metadata("\n".join(header_lines))
    arr = np.asarray(rows)
    if arr.ndim == 2 and arr.shape[1] == 1:
        arr = arr[:, 0]
    return arr, meta


def write_results(path: str, results: Dict[str, Tuple[float, float]],
                  meta: Optional[Metadata] = None) -> None:
    """Write `name mean error` rows (reference: DataMapWriter ->
    results.values)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        if meta:
            f.write(metadata_to_string(meta, prefix="## "))
        f.write("# name mean error\n")
        for name, (mean, err) in sorted(results.items()):
            f.write(f"{name} {mean!r} {err!r}\n")
    os.replace(tmp, path)


def load_results(path: str) -> Dict[str, Tuple[float, float]]:
    out: Dict[str, Tuple[float, float]] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) >= 3:
                out[parts[0]] = (float(parts[1]), float(parts[2]))
    return out
