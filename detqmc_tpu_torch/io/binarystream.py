"""Binary configuration streams (.binarystream) — the port's copy of
detqmc_tpu/io/binarystream.py (numpy only, the same file format, so the
JAX package's readers read the port's streams and back).

Reference parity: SURVEY.md §3 "SDW config dumps" (detsdwsystemconfig:
stream phi configurations to a raw binary file for offline analysis) and
"Series utilities" (mainextractfrombinarystream.cpp).

Format: a small JSON sidecar `<path>.meta.json` records the record shape
and dtype; the stream itself is raw little-endian float64 records appended
per measurement — directly np.fromfile-able, like the reference's raw
double stream.
"""

from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np


class BinaryStreamWriter:
    def __init__(self, path: str, record_shape: Tuple[int, ...]):
        self.path = path
        self.record_shape = tuple(int(x) for x in record_shape)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        sidecar = {"record_shape": self.record_shape, "dtype": "<f8"}
        with open(path + ".meta.json", "w") as f:
            json.dump(sidecar, f)
        if not os.path.exists(path):
            open(path, "wb").close()

    def append(self, records: np.ndarray) -> None:
        arr = np.asarray(records, dtype="<f8")
        per = int(np.prod(self.record_shape))
        assert arr.size % per == 0, (arr.shape, self.record_shape)
        with open(self.path, "ab") as f:
            arr.ravel().tofile(f)


def read_binarystream(path: str) -> np.ndarray:
    """-> (n_records, *record_shape) float64."""
    with open(path + ".meta.json") as f:
        sidecar = json.load(f)
    shape = tuple(sidecar["record_shape"])
    raw = np.fromfile(path, dtype="<f8")
    per = int(np.prod(shape))
    n = raw.size // per
    return raw[: n * per].reshape(n, *shape)


def extract_doubles(path: str, start: int = 0, count: int = -1
                    ) -> np.ndarray:
    """Raw double extraction (reference: extractfrombinarystream)."""
    raw = np.fromfile(path, dtype="<f8")
    return raw[start:] if count < 0 else raw[start:start + count]
