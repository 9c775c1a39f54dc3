"""detqmc-pt-torch — the port's parallel-tempering binary, model- and
parameter-generic.

The port's counterpart of detqmc_tpu/cli/main_pt.py (reference parity:
SURVEY.md §3 "CLI mains", maindetqmcptsdwopdim.cpp; the reference's
``mpirun -n R`` is the ``values`` grid as walkers on one card): the same
keys, the same two schemes and the same output files.

  model = sdw | hubbard      which model samples
  controlParameter =         which parameter the grid tempers:
      r          (sdw, default)     label swap, no determinant
      stagger_h  (hubbard, default) label swap, no determinant
      beta       (either model)     det-coupled configuration swap
                 (parallel/det_pt.py): one model per grid value at
                 fixed m (dtau = beta_k / m), the swap weighs the
                 fermionic log-det difference

Config keys: everything the single-run main takes, plus
    values = v0,v1,...      control-parameter grid (one replica each)
    exchangeInterval = n    sweep pairs between exchange attempts
    ptEnsembles = E         independent chains per grid value
and one key more, ``device`` (default ``cuda``): the torch device, e.g.
``device=cpu`` for the plain PyTorch versions on the CPU; it is not
echoed into info.dat. Exit codes: 0 done (also after a wall-time stop,
which saves the state; the same command resumes), 2 configuration error.
Usage:
    detqmc-pt-torch --conf examples/pt_sdw_r_grid.conf [--key value ...]
    detqmc-pt-torch model=hubbard L=8 U=4 beta=8 m=80 s=4 \
        controlParameter=stagger_h values=0,0.05,0.1,0.2 ptEnsembles=64
"""

from __future__ import annotations

import dataclasses
import sys

from detqmc_tpu_torch.config import (
    ConfigurationError,
    _HUBBARD_KEYS,
    _PT_KEYS,
    _SDW_KEYS,
    build_driver_config,
    build_hubbard_config,
    build_sdw_config,
    parse_args,
    pt_params,
    split_params,
)
from detqmc_tpu_torch.timing import timing

_DEFAULT_CONTROL = {"sdw": "r", "hubbard": "stagger_h"}


def main(argv=None, default_model: str = "sdw") -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        params = parse_args(argv)
        device = params.pop("device", "cuda")
        model_name = params.get("model", default_model)
        if model_name not in ("sdw", "hubbard"):
            raise ConfigurationError(
                f"model must be sdw|hubbard, got {model_name!r}")
        keys = _SDW_KEYS if model_name == "sdw" else _HUBBARD_KEYS
        build = (build_sdw_config if model_name == "sdw"
                 else build_hubbard_config)
        model_p, driver_p, extra = split_params(params, keys,
                                                extra_keys=_PT_KEYS)
        cfg = build(model_p)
        drv = build_driver_config(driver_p)
        ptp = pt_params(extra)
        values = ptp.get("values")
        if not values:
            raise ConfigurationError(
                "parallel tempering needs `values = v0,v1,...`")
        control = ptp.get("controlParameter", _DEFAULT_CONTROL[model_name])
    except ConfigurationError as e:
        print(f"configuration error: {e}", file=sys.stderr)
        return 2

    if model_name == "sdw":
        from detqmc_tpu_torch.models.sdw import SDWModel as Model
    else:
        from detqmc_tpu_torch.models.hubbard import HubbardModel as Model

    scheme = dict(exchange_interval=ptp.get("exchangeInterval", 1),
                  n_ensembles=ptp.get("ptEnsembles", 1))
    meta = {"model": f"{model_name}-pt"}
    try:
        if control == "beta":
            from detqmc_tpu_torch.parallel.det_pt import (DetPTConfig,
                                                          DetQMCPTDet)

            models = [Model(dataclasses.replace(cfg, beta=float(v)),
                            device=device) for v in values]
            qmc = DetQMCPTDet(models, values, drv, DetPTConfig(
                control_parameter="beta", **scheme), meta_extra=meta)
        else:
            from detqmc_tpu_torch.parallel.pt_driver import (DetQMCPT,
                                                             PTConfig)

            qmc = DetQMCPT(Model(cfg, device=device), values, drv, PTConfig(
                control_parameter=control, **scheme), meta_extra=meta)
    except ConfigurationError as e:
        print(f"configuration error: {e}", file=sys.stderr)
        return 2
    results = qmc.run()
    for k, res in results.items():
        print(f"# parameter {k} ({control} = {values[k]})")
        for name, (mean, err) in sorted(res.items()):
            print(f"{name} = {mean!r} +/- {err!r}")
    print(timing.report(), file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
