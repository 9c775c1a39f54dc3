"""deteval — offline evaluation of a finished run directory.

Reference parity: SURVEY.md §4.4 (maindeteval.cpp): read info.dat, load
each observable's .series, discard warmup, rebin, jackknife mean/error,
integrated autocorrelation time, write eval-results files.

Usage: deteval-torch [--discard N] [--jkBlocks B] <rundir> [rundir...]

The port's copy of detqmc_tpu/analysis/deteval.py. It reads and writes
small host series, so it stays host NumPy (over the port's
statistics.py) and runs on no device: its output files are byte for
byte the JAX tool's on the same run directory.
"""

from __future__ import annotations

import glob
import os
import sys
from typing import Dict, Tuple

from detqmc_tpu_torch import statistics
from detqmc_tpu_torch.io.series import load_series, write_results
from detqmc_tpu_torch.metadata import read_metadata


def evaluate_run(rundir: str, discard: int = 0, jk_blocks: int = 20
                 ) -> Dict[str, Tuple[float, float, float]]:
    """Returns {observable: (mean, error, tau_int)}."""
    out: Dict[str, Tuple[float, float, float]] = {}
    for path in sorted(glob.glob(os.path.join(rundir, "*.series"))):
        name = os.path.splitext(os.path.basename(path))[0]
        arr, _meta = load_series(path)
        if arr.ndim != 1:
            continue  # vector series get their own tooling (sdwcorr etc.)
        arr = arr[discard:]
        if len(arr) < 4:
            continue
        nb = min(jk_blocks, max(2, len(arr) // 2))
        mean, err = statistics.jackknife(arr, nb)
        tau = statistics.tau_int(arr)
        out[name] = (mean, err, tau)
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    discard = 0
    jk = 20
    dirs = []
    i = 0
    while i < len(argv):
        if argv[i] == "--discard":
            discard = int(argv[i + 1]); i += 2
        elif argv[i] == "--jkBlocks":
            jk = int(argv[i + 1]); i += 2
        else:
            dirs.append(argv[i]); i += 1
    if not dirs:
        print("usage: deteval [--discard N] [--jkBlocks B] <rundir>...",
              file=sys.stderr)
        return 2
    for rundir in dirs:
        res = evaluate_run(rundir, discard, jk)
        if not res:
            print(f"{rundir}: no scalar .series files", file=sys.stderr)
            continue
        meta = {}
        info = os.path.join(rundir, "info.dat")
        if os.path.exists(info):
            meta = read_metadata(info)
        meta["evalDiscard"] = str(discard)
        meta["evalJkBlocks"] = str(jk)
        write_results(os.path.join(rundir, "eval-results.values"),
                      {k: (m, e) for k, (m, e, _t) in res.items()},
                      meta=meta)
        with open(os.path.join(rundir, "eval-tauint.values"), "w") as f:
            f.write("# name tau_int\n")
            for k, (_m, _e, t) in sorted(res.items()):
                f.write(f"{k} {t!r}\n")
        for k, (m, e, t) in sorted(res.items()):
            print(f"{rundir}: {k} = {m!r} +/- {e!r}  (tau_int {t:.2f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
