"""tauintsimple — integrated autocorrelation time of a time series.

Reference parity: SURVEY.md §3 "tauint tool" (maintauintsimple.cpp).
Usage: tauint-torch <series-file> [...]

The port's copy of detqmc_tpu/analysis/tauint.py: host NumPy, no
device (a series is a few thousand numbers).
"""

from __future__ import annotations

import sys

from detqmc_tpu_torch.io.series import load_series
from detqmc_tpu_torch.statistics import tau_int


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: tauintsimple <series-file>...", file=sys.stderr)
        return 2
    for path in argv:
        arr, _ = load_series(path)
        if arr.ndim != 1:
            print(f"{path}: not a scalar series", file=sys.stderr)
            continue
        print(f"{path}: tau_int = {tau_int(arr)!r}  (n = {len(arr)})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
