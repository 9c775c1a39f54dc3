"""Config system: `key = value` files + CLI flags -> validated dataclasses.

The port's copy of detqmc_tpu/config.py, for the Hubbard and SDW CLIs:
the same keys, parsing and validation, building the port's DriverConfig,
HubbardConfig and SDWConfig (the parallel-tempering keys come with their
CLIs, ROADMAP.md Queue 1 item 10). One divergence: the SDW key
``accRatio``, which the JAX config drops, becomes the driver's
``target_acc_ratio`` (``build_sdw_driver_config``).

Reference parity: SURVEY.md §3 row "Config/flag system"
(boost::program_options: CLI flags + --conf file; parameter structs with
check() validation and createMetadata() echo). Same semantics:

- every binary takes ``--conf <file>`` and/or ``--key value`` / ``key=value``
  overrides (CLI wins over file),
- unknown keys are hard errors,
- the resolved parameter set is echoed into the run's info.dat.

Key names follow the reference's concepts (SURVEY.md §6): model, L, t, U,
mu, beta, m, dtau (two of beta/m/dtau), s (stabilization interval),
checkerboard, updateMethod (iterative|delayed), delay, sweeps,
thermalization, measureInterval, saveInterval, jkBlocks, timeseries,
walltimeSecs, rngSeed, outdir, walkers.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

from detqmc_tpu_torch.driver import DriverConfig
from detqmc_tpu_torch.exceptions import ConfigurationError
from detqmc_tpu_torch.metadata import string_to_metadata


_BOOL_TRUE = {"1", "true", "yes", "on"}
_BOOL_FALSE = {"0", "false", "no", "off"}


def _to_bool(v: str) -> bool:
    lv = v.lower()
    if lv in _BOOL_TRUE:
        return True
    if lv in _BOOL_FALSE:
        return False
    raise ConfigurationError(f"not a boolean: {v!r}")


def parse_args(argv: Sequence[str]) -> Dict[str, str]:
    """Parse ``--conf file``, ``--key value``, ``--key=value`` and bare
    ``key=value`` tokens into a flat string map (CLI overrides file)."""
    file_params: Dict[str, str] = {}
    cli_params: Dict[str, str] = {}
    i = 0
    argv = list(argv)
    while i < len(argv):
        tok = argv[i]
        if tok in ("--conf", "-c"):
            if i + 1 >= len(argv):
                raise ConfigurationError("--conf needs a file path")
            with open(argv[i + 1]) as f:
                file_params.update(string_to_metadata(f.read()))
            i += 2
        elif tok.startswith("--"):
            body = tok[2:]
            if "=" in body:
                k, _, v = body.partition("=")
                cli_params[k] = v
                i += 1
            else:
                if i + 1 >= len(argv) or argv[i + 1].startswith("--"):
                    cli_params[body] = "true"  # boolean flag form
                    i += 1
                else:
                    cli_params[body] = argv[i + 1]
                    i += 2
        elif "=" in tok:
            k, _, v = tok.partition("=")
            cli_params[k.strip()] = v.strip()
            i += 1
        else:
            raise ConfigurationError(f"unrecognized argument: {tok!r}")
    file_params.update(cli_params)
    return file_params


# -- shared simulation keys ---------------------------------------------------

_DRIVER_KEYS = {
    "sweeps": int,
    "thermalization": int,
    "measureInterval": int,
    "saveInterval": int,
    "jkBlocks": int,
    "timeseries": _to_bool,
    "walltimeSecs": float,
    "outdir": str,
    "walkers": int,
    "rngSeed": int,
    "blockMeas": int,
    "meshDevices": int,
    "timedisplaced": _to_bool,
    "timedisplacedSlices": _to_bool,
    "currentCorrelators": _to_bool,
    "autoStabilize": _to_bool,
    "greenDevThreshold": float,
    "profileDir": str,
}

_DRIVER_FIELD = {
    "sweeps": "sweeps",
    "thermalization": "thermalization",
    "measureInterval": "measure_interval",
    "saveInterval": "save_interval",
    "jkBlocks": "jk_blocks",
    "timeseries": "timeseries",
    "walltimeSecs": "walltime_secs",
    "outdir": "outdir",
    "walkers": "n_walkers",
    "rngSeed": "seed",
    "blockMeas": "block_meas",
    "meshDevices": "mesh_devices",
    "timedisplaced": "timedisplaced",
    "timedisplacedSlices": "timedisplaced_slices",
    "currentCorrelators": "current_correlators",
    "autoStabilize": "auto_stabilize",
    "greenDevThreshold": "green_dev_threshold",
    "profileDir": "profile_dir",
}

_HUBBARD_KEYS = {
    "L": int, "d": int, "t": float, "U": float, "mu": float,
    "beta": float, "m": int, "dtau": float, "s": int,
    "checkerboard": _to_bool, "updateMethod": str, "delay": int,
    "dtype": str, "updateKernel": str, "greenKernel": str,
    "greenRefineIters": int, "ozakiChainLimbs": int, "cbApply": str,
    "staggerH": float,
}

_SDW_KEYS = {
    "L": int, "r": float, "lambda": float, "u": float, "c": float,
    "txhor": float, "txver": float, "tyhor": float, "tyver": float,
    "mu": float, "opdim": int,
    "beta": float, "m": int, "dtau": float, "s": int,
    "checkerboard": _to_bool,
    "updateMethod": str, "delay": int, "dtype": str,
    "globalShift": _to_bool, "wolffClusterUpdate": _to_bool,
    "wolffClusterShiftUpdate": _to_bool,
    "globalUpdateInterval": int, "turnoffFermions": _to_bool,
    "boxLength": float, "accRatio": float,
    "spinProposalMethod": str,
    "fermionRepr": str, "updateKernel": str, "greenKernel": str,
    "greenRefineIters": int, "ozakiChainLimbs": int, "cbApply": str,
    "wrapPrec": str, "wrapKernel": str,
}

def resolve_time_grid(params: Dict[str, Any]) -> Tuple[float, int]:
    """Two-of-three (beta, m, dtau) rule (reference: DetQMCParams.check)."""
    beta = params.get("beta")
    m = params.get("m")
    dtau = params.get("dtau")
    given = sum(x is not None for x in (beta, m, dtau))
    if given < 2:
        raise ConfigurationError(
            "need two of (beta, m, dtau); got "
            f"beta={beta}, m={m}, dtau={dtau}")
    if beta is None:
        beta = m * dtau
    elif m is None:
        m = round(beta / dtau)
        if abs(m * dtau - beta) > 1e-9:
            raise ConfigurationError(
                f"beta={beta} is not an integer multiple of dtau={dtau}")
    elif dtau is not None and abs(m * dtau - beta) > 1e-9:
        raise ConfigurationError(
            f"inconsistent beta={beta}, m={m}, dtau={dtau}")
    return float(beta), int(m)


def _convert(params: Dict[str, str], schema: Dict[str, Any],
             context: str) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in params.items():
        if k not in schema:
            raise ConfigurationError(
                f"unknown parameter {k!r} for {context}; known: "
                f"{sorted(schema)}")
        try:
            out[k] = schema[k](v)
        except ConfigurationError:
            raise
        except Exception as e:
            raise ConfigurationError(f"bad value for {k}: {v!r} ({e})")
    return out


def split_params(params: Dict[str, str], model_keys: Dict[str, Any],
                 extra_keys: Optional[Dict[str, Any]] = None
                 ) -> Tuple[Dict[str, str], Dict[str, str], Dict[str, str]]:
    """Split a flat map into (model, driver, extra) maps; unknown keys are
    errors (reference behavior)."""
    model: Dict[str, str] = {}
    driver: Dict[str, str] = {}
    extra: Dict[str, str] = {}
    extra_keys = extra_keys or {}
    for k, v in params.items():
        if k == "model":
            continue
        if k in model_keys:
            model[k] = v
        elif k in _DRIVER_KEYS:
            driver[k] = v
        elif k in extra_keys:
            extra[k] = v
        else:
            known = sorted(set(model_keys) | set(_DRIVER_KEYS)
                           | set(extra_keys) | {"model"})
            raise ConfigurationError(
                f"unknown parameter {k!r}; known: {known}")
    return model, driver, extra


def build_driver_config(driver_params: Dict[str, str]) -> DriverConfig:
    typed = _convert(driver_params, _DRIVER_KEYS, "driver")
    kwargs = {_DRIVER_FIELD[k]: v for k, v in typed.items()}
    return DriverConfig(**kwargs)


def build_hubbard_config(model_params: Dict[str, str]):
    from detqmc_tpu_torch.models.hubbard import HubbardConfig

    typed = _convert(model_params, _HUBBARD_KEYS, "hubbard")
    beta, m = resolve_time_grid({
        "beta": typed.pop("beta", None),
        "m": typed.pop("m", None),
        "dtau": typed.pop("dtau", None),
    })
    upd = typed.pop("updateMethod", "iterative")
    delay = typed.pop("delay", 16 if upd == "delayed" else 0)
    if upd not in ("iterative", "delayed"):
        raise ConfigurationError(
            f"updateMethod must be iterative|delayed, got {upd!r}")
    if upd == "iterative":
        delay = 0
    for conf_key, field in (("updateKernel", "update_kernel"),
                            ("greenKernel", "green_kernel"),
                            ("greenRefineIters", "green_refine_iters"),
                            ("ozakiChainLimbs", "ozaki_chain_limbs"),
                            ("cbApply", "cb_apply"),
                            ("staggerH", "stagger_h")):
        if conf_key in typed:
            typed[field] = typed.pop(conf_key)
    try:
        return HubbardConfig(beta=beta, m=m, delay=delay, **typed)
    except ValueError as e:
        raise ConfigurationError(str(e))


def build_sdw_config(model_params: Dict[str, str]):
    from detqmc_tpu_torch.models.sdw import SDWConfig

    typed = _convert(model_params, _SDW_KEYS, "sdw")
    beta, m = resolve_time_grid({
        "beta": typed.pop("beta", None),
        "m": typed.pop("m", None),
        "dtau": typed.pop("dtau", None),
    })
    if "lambda" in typed:
        typed["lam"] = typed.pop("lambda")
    if "boxLength" in typed:
        typed["box_width"] = typed.pop("boxLength")
    # accRatio is the driver's (build_sdw_driver_config)
    typed.pop("accRatio", None)
    if "spinProposalMethod" in typed:
        typed["spinProposalMethod"] = typed["spinProposalMethod"].lower()
    upd = typed.pop("updateMethod", "iterative")
    if upd not in ("iterative", "delayed"):
        raise ConfigurationError(
            f"updateMethod must be iterative|delayed, got {upd!r}")
    if upd == "iterative":
        typed["delay"] = 0
    elif "delay" not in typed:
        typed["delay"] = 16  # reference-style default delaySteps
    for conf_key, field in (("fermionRepr", "fermion_repr"),
                            ("updateKernel", "update_kernel"),
                            ("greenKernel", "green_kernel"),
                            ("greenRefineIters", "green_refine_iters"),
                            ("ozakiChainLimbs", "ozaki_chain_limbs"),
                            ("cbApply", "cb_apply"),
                            ("wrapPrec", "wrap_prec"),
                            ("wrapKernel", "wrap_kernel")):
        if conf_key in typed:
            typed[field] = typed.pop(conf_key)
    try:
        return SDWConfig(beta=beta, m=m, **typed)
    except (TypeError, ValueError) as e:
        raise ConfigurationError(str(e))


def build_sdw_driver_config(driver_params: Dict[str, str],
                            model_params: Dict[str, str]) -> DriverConfig:
    """build_driver_config, with the SDW key ``accRatio`` (if given) as
    ``target_acc_ratio``: the proposal-width tuning's target. The JAX
    config drops the key, so there a conf's value never reaches the
    tuning; its default, 0.5, is examples/sdw_o3_l8.conf's value."""
    drv = build_driver_config(driver_params)
    if "accRatio" in model_params:
        acc = _convert({"accRatio": model_params["accRatio"]}, _SDW_KEYS,
                       "sdw")["accRatio"]
        drv = dataclasses.replace(drv, target_acc_ratio=acc)
    return drv
