"""Time the port's n > 128 inner solve (K8 + K9) and K9 alone on one CUDA
card, at the shapes of the main paths, beside the library's calls:

    python3 solve_timing.py                  # this checkout's kernels
    python3 solve_timing.py --tree OTHER     # the package of another checkout
    python3 solve_timing.py --plans          # also K8's and K9's other plans

Rows (float64 as the Hubbard L=16 chain, complex128 as SDW L=8):
K8 + K9 f64 B=128 n=256 (diag(r1)), K8-rhs + K9 f64 B=5376 n=256, K8 + K9
c128 B=128 n=256, K8-rhs + K9 c128 B=768 n=256, and K9 alone c128 B=128
n=256 on R^{-1} Q^H diag(r1). The inner matrices are U diag(s) V^H with
Haar-random U, V and s graded from 1 to 1e-11 (the mid-chain condition),
made on the card from --seed; the timed work does not depend on the
values. Each call: CUDA events, one warm-up, the median of --reps calls
(torch.linalg.solve and solve_triangular at least five), the backward
error checked against 1e-13. With --tree the package is imported from
that directory (an unpacked parent commit, say), so two versions can be
timed in one session on one card: parent, change, change, parent. Each
row prints as one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

BACKWARD_TOL = 1e-13


def time_ms(fn, reps: int) -> float:
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def graded_inner(B: int, n: int, dtype, gen, device):
    """(B, n, n) U diag(s) V^H, s from 1 to 1e-11, U and V Haar-random."""
    import torch

    def haar():
        X = torch.randn((B, n, n), generator=gen, dtype=dtype, device=device)
        return torch.linalg.qr(X).Q

    s = torch.logspace(0, -11, n, dtype=torch.float64, device=device)
    return ((haar() * s.to(dtype)) @ haar().mH).contiguous()


def backward(inner, X, M) -> float:
    amax = lambda T: T.abs().amax((1, 2))                      # noqa: E731
    n = inner.shape[-1]
    return float((amax(inner @ X - M) / (n * amax(inner) * amax(X))).max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parent),
                    help="directory holding the detqmc_tpu_torch to time")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--seed", type=int, default=256)
    ap.add_argument("--plans", action="store_true",
                    help="also time K8's and K9's other plans")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("solve_timing: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.tree).resolve()))
    from detqmc_tpu_torch.linalg import green_solve, trinv

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    lib_reps = max(5, args.reps)
    rows = []

    def emit(row):
        row.update(tree=args.tree, card=card)
        rows.append(row)
        print(json.dumps(row), flush=True)

    cases = (("K8+K9", torch.float64, 128, False),
             ("K8-rhs+K9", torch.float64, 5376, True),
             ("K8+K9", torch.complex128, 128, False),
             ("K8-rhs+K9", torch.complex128, 768, True))
    for name, dtype, B, rhs in cases:
        n = 256
        inner = graded_inner(B, n, dtype, gen, device)
        if rhs:
            M = torch.randn((B, n, n), generator=gen, dtype=dtype,
                            device=device)
            full = M
            solve = lambda **kw: green_solve._solve(  # noqa: E731
                inner, M, True, **kw)
        else:
            M = torch.rand((B, n), generator=gen, dtype=torch.float64,
                           device=device) + 0.1
            full = torch.diag_embed(M).to(dtype)
            solve = lambda **kw: green_solve._solve(  # noqa: E731
                inner, M, False, **kw)
        X = solve()
        torch.cuda.synchronize()
        err = backward(inner, X, full)
        if err > BACKWARD_TOL:
            raise AssertionError(f"{name} {dtype}: backward error {err:.3e}")
        ms = time_ms(solve, args.reps)
        lms = time_ms(lambda: torch.linalg.solve(inner, full), lib_reps)
        emit(dict(kernel=name, dtype=str(dtype)[6:], B=B, n=n, ms=ms,
                  library_ms=lms, library="torch.linalg.solve",
                  backward=err))
        if args.plans and hasattr(green_solve, "_BIG_PLANS_TWO_CTA"):
            plans = sorted(set(green_solve._BIG_PLANS[dtype]
                               + green_solve._BIG_PLANS_TWO_CTA[dtype]))
            for plan in plans:
                if green_solve.big_smem_bytes(n, dtype, *plan) > \
                        green_solve._kernels.MAX_SMEM_BYTES - 1024:
                    continue
                t = time_ms(lambda: solve(plan=plan), args.reps)
                emit(dict(kernel=name, dtype=str(dtype)[6:], B=B, n=n,
                          k8_plan=plan, ms=t))
            for plan in trinv._PLANS:
                if trinv.smem_bytes(n, dtype, *plan) > \
                        trinv._kernels.MAX_SMEM_BYTES - 1024:
                    continue
                t = time_ms(lambda: solve(plan9=plan), args.reps)
                emit(dict(kernel=name, dtype=str(dtype)[6:], B=B, n=n,
                          k9_plan=plan, ms=t))
        if dtype == torch.complex128 and not rhs:
            # K9 alone on the path's right-hand side, R^{-1} Q^H diag(r1)
            Q, R = torch.linalg.qr(inner)
            R = R.contiguous()
            rhs9 = (Q.mH * M[:, None, :].to(dtype)).contiguous()
            ms9 = time_ms(lambda: trinv.trinv(R, rhs9), args.reps)
            lms9 = time_ms(lambda: torch.linalg.solve_triangular(
                R, rhs9, upper=True), lib_reps)
            emit(dict(kernel="K9", dtype="complex128", B=B, n=n, ms=ms9,
                      library_ms=lms9, library="solve_triangular"))
        del inner, M, full, X
        torch.cuda.empty_cache()
    print(json.dumps({"rows": len(rows), "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
