"""mrpt — multiple-histogram reweighting over a parallel-tempering run.

Reference parity: SURVEY.md §4.5 (mainmrpt*.cpp): load the per-parameter
time series of a PT run directory, solve the Ferrenberg-Swendsen
self-consistency, and write continuous <O>(r) curves (plus Binder
cumulants) on a fine grid, with optional jackknifed errors.

The exchange-conjugate action a = dtau/2 sum phi^2 is read from the
per-configuration exchangeAction series when present (the model records
the sweep-final configuration's action exactly — FS weights exp(-dr*a)
are nonlinear in a, so averaged actions would be Jensen-biased). Runs
recorded before that series existed fall back to reconstructing a from
the phiSquared series (interval-averaged; biased at large |dr|) with a
warning.

Usage:
  mrpt-torch <pt-outdir> [--obs phiSquared]
      [--grid lo,hi,n] [--binder] [--jackknife B] [--discard N]
      [--maxsusc NAME] [--intersect <pt-outdir-of-other-L>] [--device D]

--maxsusc locates the maximum of the reweighted <NAME>(r) (golden-
section; reference: susceptibility-maximum finders); --intersect finds
the Binder-cumulant crossing against a second run (another system
size; reference: findBinderIntersect) — both with jackknifed errors
when --jackknife B is given (the whole FS solve repeats per block).

The port's copy of detqmc_tpu/cli/main_mrpt.py: the same arguments and
files, one more, --device (default cuda; --device cpu runs the plain
version on the CPU), the torch device the free-energy solve and the
reweighting run on (detqmc_tpu_torch.analysis.mrpt)."""

from __future__ import annotations

import glob
import os
import sys

import numpy as np

from detqmc_tpu_torch.analysis.mrpt import (
    MultireweightPT,
    find_binder_intersection,
    find_observable_maximum,
    jackknife_intersection,
    jackknife_reweighted,
)
from detqmc_tpu_torch.io.series import load_series
from detqmc_tpu_torch.metadata import read_metadata


def load_pt_run(outdir: str, obs_names, discard: int = 0):
    """-> (r_values, actions, observables) from p*/ subdirectories."""
    subdirs = sorted(glob.glob(os.path.join(outdir, "p*")),
                     key=lambda p: int(os.path.basename(p)[1:]))
    if not subdirs:
        raise FileNotFoundError(f"no p*/ parameter dirs under {outdir}")
    r_values, actions = [], []
    observables = {name: [] for name in obs_names}
    for sub in subdirs:
        meta = read_metadata(os.path.join(sub, "info.dat"))
        r = float(meta["r"])
        action_path = os.path.join(sub, "exchangeAction.series")
        if os.path.exists(action_path):
            a, _ = load_series(action_path)
            a = a[discard:]
        else:
            print(f"warning: {action_path} missing; reconstructing the "
                  "action from the interval-averaged phiSquared series "
                  "(Jensen-biased at large |dr|)", file=sys.stderr)
            L = int(meta["L"])
            m = int(meta["m"])
            beta = float(meta["beta"])
            dtau = beta / m
            phi2, _ = load_series(os.path.join(sub, "phiSquared.series"))
            a = phi2[discard:] * (0.5 * dtau * m * L * L)
        r_values.append(r)
        actions.append(a)
        for name in obs_names:
            s, _ = load_series(os.path.join(sub, f"{name}.series"))
            observables[name].append(s[discard:])
    return np.asarray(r_values), actions, observables


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    outdir = argv[0]
    obs = ["phiSquared", "phiFourth"]
    grid = None
    do_binder = False
    jk = 0
    discard = 0
    maxsusc = None
    intersect_dir = None
    device = "cuda"
    i = 1
    while i < len(argv):
        if argv[i] == "--obs":
            obs = argv[i + 1].split(","); i += 2
        elif argv[i] == "--grid":
            lo, hi, n = argv[i + 1].split(","); i += 2
            grid = np.linspace(float(lo), float(hi), int(n))
        elif argv[i] == "--binder":
            do_binder = True; i += 1
        elif argv[i] == "--jackknife":
            jk = int(argv[i + 1]); i += 2
        elif argv[i] == "--discard":
            discard = int(argv[i + 1]); i += 2
        elif argv[i] == "--maxsusc":
            maxsusc = argv[i + 1]; i += 2
        elif argv[i] == "--intersect":
            intersect_dir = argv[i + 1]; i += 2
        elif argv[i] == "--device":
            device = argv[i + 1]; i += 2
        else:
            print(f"unknown argument {argv[i]!r}", file=sys.stderr)
            return 2

    if maxsusc is not None and maxsusc not in obs:
        obs.append(maxsusc)
    for name in ("phiSquared", "phiFourth"):
        if (do_binder or intersect_dir is not None) and name not in obs:
            obs.append(name)
    r_values, actions, observables = load_pt_run(outdir, obs, discard)
    if grid is None:
        grid = np.linspace(r_values.min(), r_values.max(), 51)

    m = MultireweightPT(r_values, actions, observables, device=device)
    m.solve()
    out_path = os.path.join(outdir, "mrpt.values")
    with open(out_path, "w") as f:
        cols = ["r"] + obs + (["binder"] if do_binder else [])
        f.write("# " + " ".join(cols) + "\n")
        # one batched reweighting per observable over the whole grid
        curves = {name: m.curve(name, grid) for name in obs}
        if do_binder:
            p2 = m.curve("phiSquared", grid)
            p4 = m.curve("phiFourth", grid)
        for i_r, r in enumerate(grid):
            row = [r] + [curves[name][i_r] for name in obs]
            if do_binder:
                row.append(1.0 - p4[i_r] / (3.0 * p2[i_r] ** 2))
            f.write(" ".join(repr(float(v)) for v in row) + "\n")
    print(f"wrote {out_path} ({len(grid)} grid points, "
          f"f = {np.round(m.f, 4).tolist()})")

    if jk > 1:
        for name in obs:
            r_mid = float(grid[len(grid) // 2])
            est, err = jackknife_reweighted(
                r_values, actions, observables,
                lambda mm_, n_=name: mm_.expectation(n_, r_mid),
                n_blocks=jk, device=device)
            print(f"{name}(r={r_mid:.4f}) = {est!r} +/- {err!r}")

    r_lo, r_hi = float(grid.min()), float(grid.max())
    if maxsusc is not None:
        r_star, val = find_observable_maximum(m, maxsusc, r_lo, r_hi)
        line = f"max {maxsusc}: r = {r_star!r} (value {val!r})"
        if jk > 1:
            est, err = jackknife_reweighted(
                r_values, actions, observables,
                lambda mm_: find_observable_maximum(
                    mm_, maxsusc, r_lo, r_hi)[0], n_blocks=jk,
                device=device)
            line += f"; jackknifed location {est!r} +/- {err!r}"
        print(line)

    if intersect_dir is not None:
        r2, a2, o2 = load_pt_run(intersect_dir, obs, discard)
        m2 = MultireweightPT(r2, a2, o2, device=device)
        m2.solve()
        x = find_binder_intersection(m, m2, r_lo, r_hi)
        if x is None:
            print(f"no Binder crossing in [{r_lo}, {r_hi}]",
                  file=sys.stderr)
            return 1
        line = f"binderIntersection = {x!r}"
        if jk > 1:
            est, err = jackknife_intersection(
                (r_values, actions, observables), (r2, a2, o2),
                r_lo, r_hi, n_blocks=jk, device=device)
            line += f" (jackknifed {est!r} +/- {err!r})"
        print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
