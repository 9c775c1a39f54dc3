"""jointimeseries — concatenate .series files across restarted runs.

Reference parity: SURVEY.md §3 "Series utilities" (mainjointimeseries.cpp).
Usage: python -m detqmc_tpu_torch.analysis.jointimeseries out.series in1 in2 ...
Headers are taken from the first input. The port's copy of
detqmc_tpu/analysis/jointimeseries.py: host NumPy, no device.
"""

from __future__ import annotations

import sys

import numpy as np

from detqmc_tpu_torch.io.series import SeriesWriter, load_series


def join(out_path: str, inputs) -> int:
    total = 0
    meta = None
    chunks = []
    for path in inputs:
        arr, m = load_series(path)
        if meta is None:
            meta = m
        chunks.append(np.atleast_1d(arr))
        total += len(chunks[-1])
    name = out_path.rsplit("/", 1)[-1].replace(".series", "")
    w = SeriesWriter(out_path, name, meta=meta)
    for c in chunks:
        w.append(c)
    return total


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print("usage: jointimeseries <out.series> <in.series>...",
              file=sys.stderr)
        return 2
    n = join(argv[0], argv[1:])
    print(f"{argv[0]}: {n} samples from {len(argv) - 1} inputs")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
