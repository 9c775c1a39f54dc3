"""detqmc-sdw-torch — O(n) SDW-model DQMC simulation binary of the port.

The port's counterpart of detqmc_tpu/cli/main_sdw.py (reference parity:
SURVEY.md §3 "CLI mains", maindetqmcsdwopdim.cpp): the same keys, config
files and output files, run by the port's driver on one CUDA card, at
opdim 3 (the full fermion matrix) and opdim 2 and 1 (the reduced
two-sector chains), global moves (globalShift, wolffClusterUpdate,
wolffClusterShiftUpdate) and turnoffFermions included. One key more: ``device`` (default ``cuda``) names the torch
device, e.g. ``device=cpu`` to run the plain PyTorch versions on the CPU.
It is not echoed into info.dat, so a run's files carry the JAX CLI's
keys. ``accRatio`` sets the driver's proposal-width target (the JAX CLI
reads and drops it). Exit codes: 0 done, 2 configuration error, 3
stopped early by the wall-time budget (state saved; the same command
resumes).
Usage:
    detqmc-sdw-torch --conf examples/sdw_o3_l8.conf [--key value ...]
    detqmc-sdw-torch L=4 opdim=2 r=1.0 beta=4 m=40 s=2 sweeps=1000 \
        thermalization=300 globalShift=true wolffClusterUpdate=true
    python -m detqmc_tpu_torch.cli.main_sdw --conf sim.conf sweeps=100 ...
"""

from __future__ import annotations

import sys

from detqmc_tpu_torch.config import (
    ConfigurationError,
    _SDW_KEYS,
    build_sdw_config,
    build_sdw_driver_config,
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
        model_p, driver_p, _ = split_params(params, _SDW_KEYS)
        cfg = build_sdw_config(model_p)
        drv = build_sdw_driver_config(driver_p, model_p)
    except ConfigurationError as e:
        print(f"configuration error: {e}", file=sys.stderr)
        return 2

    from detqmc_tpu_torch.models.sdw import SDWModel

    model = SDWModel(cfg, device=device)
    qmc = DetQMC(model, drv, meta_extra={"model": "sdw"})
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
