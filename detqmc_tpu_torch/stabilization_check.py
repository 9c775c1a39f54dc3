"""How far the wrapped G drifts from the stabilized one (green_dev) for the
port's stabilization and for the JAX package's choices, on one card.

    python -m detqmc_tpu_torch.stabilization_check [--pairs 10] [--walkers 128]

Runs HubbardConfig(L=16, U=4, beta=8, m=80, s=4, checkerboard, delay=16)
— the L=16 cell of chip_smoke.py — from one seed in five variants and
prints, per sweep pair, the median over walkers of each walker's
green_dev (max |G_wrapped - G_stabilized| over a sweep), then the same
for one pair without updates (every flip rejected) on the final field:
- "port": float32 G, the f64 stack (U, d, V and the block products that
  feed the refactor QR) and the pre-pivoted refactor (udv.udv_refactor);
- "f32 chain": the same with the stack's U and its block products in the
  run dtype, as the JAX package keeps them;
- "unpivoted": the port with the JAX package's refactor (the column order
  the chain made);
- "unpivoted f32 chain": both, the JAX package's numerics;
- "float64, unpivoted": everything in f64 with the JAX package's refactor.
The variants swap the module-level names the model reads
(``hubbard.CHAIN_DTYPE``, ``hubbard.udv_refactor``) for the run; nothing
else differs. Needs a CUDA card (the default device of the models).
"""

from __future__ import annotations

import argparse
import time

import torch

from detqmc_tpu_torch.linalg import udv
from detqmc_tpu_torch.models import hubbard

CFG = dict(L=16, U=4.0, beta=8.0, m=80, s=4, checkerboard=True, delay=16)


def unpivoted_refactor(M, d, V):
    """udv.udv_refactor without the column order: the JAX package's."""
    g = udv.udv_decompose(M)
    d = d.to(torch.float64)
    d_new = g.d.to(torch.float64) * d
    ds = torch.clamp(d, min=torch.finfo(torch.float64).tiny)
    upper = torch.ones(M.shape[-1], M.shape[-1], dtype=torch.bool,
                       device=M.device).triu()
    ratio = torch.where(upper, ds[..., None, :] / ds[..., :, None],
                        torch.zeros((), dtype=torch.float64, device=M.device))
    Vb = g.V.to(torch.float64) * ratio
    return udv.UDV(U=g.U, d=d_new, V=Vb @ V.to(torch.float64))


VARIANTS = (  # name, run dtype, chain dtype (None: the run dtype), refactor
    ("port", "float32", torch.float64, udv.udv_refactor),
    ("f32 chain", "float32", None, udv.udv_refactor),
    ("unpivoted", "float32", torch.float64, unpivoted_refactor),
    ("unpivoted f32 chain", "float32", None, unpivoted_refactor),
    ("float64, unpivoted", "float64", torch.float64, unpivoted_refactor))


def run(name, dtype, chain, refactor, walkers, pairs, seed=0):
    cfg = hubbard.HubbardConfig(dtype=dtype, **CFG)
    saved = hubbard.CHAIN_DTYPE, hubbard.udv_refactor
    hubbard.CHAIN_DTYPE = chain or cfg.torch_dtype
    hubbard.udv_refactor = refactor
    try:
        model = hubbard.HubbardModel(cfg)
        gen = torch.Generator(model.device).manual_seed(seed)
        t0 = time.perf_counter()
        state = model.init_state(walkers, gen)
        medians = []
        for _ in range(pairs):
            state, obs = model.sweep_pair(state, measure=True, generator=gen)
            medians.append(float(state.green_dev.double().median()))
        inf = torch.full((walkers, cfg.m, cfg.n_sites), float("inf"),
                         dtype=model.dtype, device=model.device)
        frozen, _ = model.sweep_pair(state, measure=False, u01=(inf, inf))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        hubbard.CHAIN_DTYPE, hubbard.udv_refactor = saved
    print(f"{name}: median green_dev per pair "
          + " ".join(f"{x:.2e}" for x in medians)
          + f"; no-update pair {float(frozen.green_dev.double().median()):.2e}"
          f"; occupancy {float(obs.occupancy.mean()):.6f}; {wall:.1f} s",
          flush=True)
    return medians


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--walkers", type=int, default=128)
    args = ap.parse_args(argv)
    print(torch.cuda.get_device_name(0), flush=True)
    for variant in VARIANTS:
        run(*variant, walkers=args.walkers, pairs=args.pairs)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
