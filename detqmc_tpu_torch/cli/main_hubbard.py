"""detqmc-hubbard-torch — Hubbard-model DQMC simulation binary of the port.

The port's counterpart of detqmc_tpu/cli/main_hubbard.py (reference
parity: SURVEY.md §3 "CLI mains", maindetqmchubbard.cpp): the same keys,
config files and output files, run by the port's driver on one CUDA card.
One key more: ``device`` (default ``cuda``) names the torch device, e.g.
``device=cpu`` to run the plain PyTorch versions on the CPU. It is not
echoed into info.dat, so a run's files carry the JAX CLI's keys.
Usage:
    detqmc-hubbard-torch --conf sim.conf [--key value ...]
    python -m detqmc_tpu_torch.cli.main_hubbard L=4 beta=4 U=4 sweeps=200 ...
"""

from __future__ import annotations

import sys

from detqmc_tpu_torch.config import (
    ConfigurationError,
    _HUBBARD_KEYS,
    build_driver_config,
    build_hubbard_config,
    parse_args,
    split_params,
)
from detqmc_tpu_torch.driver import DetQMC
from detqmc_tpu_torch.timing import timing


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        params = parse_args(argv)
        device = params.pop("device", "cuda")
        model_p, driver_p, _ = split_params(params, _HUBBARD_KEYS)
        cfg = build_hubbard_config(model_p)
        drv = build_driver_config(driver_p)
    except ConfigurationError as e:
        print(f"configuration error: {e}", file=sys.stderr)
        return 2

    from detqmc_tpu_torch.models.hubbard import HubbardModel

    model = HubbardModel(cfg, device=device)
    qmc = DetQMC(model, drv, meta_extra={"model": "hubbard"})
    results = qmc.run()
    for name, (mean, err) in sorted(results.items()):
        print(f"{name} = {mean!r} +/- {err!r}")
    print(timing.report(), file=sys.stderr)
    if qmc.stopped_early:
        print("walltime exhausted: state saved, resume with the same "
              "command", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
