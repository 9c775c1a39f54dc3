"""Parallel-tempering driver over a grid of r (SDW) or stagger_h (Hubbard).

The port's counterpart of detqmc_tpu/parallel/pt_driver.py (reference:
DetQMCPT::run, SURVEY.md §4.3). R replicas of a model run over a
control-parameter grid; every ``exchange_interval`` sweep pairs the
exchange step (parallel/pt.py) swaps parameter LABELS between replicas
(configurations never move). Each grid value has its own observable
stream and output subdirectory ``p{k}/``, the reference's per-value
output contract; the files are the JAX driver's.

From JAX to PyTorch: replicas and ensembles are the model's walker axis.
The state holds E R walkers in ensemble-major order (walker e R + k is
replica k of PT system e), so one batched ``sweep_pair`` advances every
replica of every system with each kernel launch, and ``arr[pidx == k]``
routes a block's samples in the JAX driver's (measurement, ensemble,
replica) order. A round — ``exchange_interval`` sweep pairs (the last one
measured in a measurement round), the tag, the exchange and the relabel
(``with_r``) — runs on the device without a host synchronization; the
host takes each block's measurements and tags once. One
``torch.Generator`` on the model's device, seeded from
``DriverConfig.seed``, draws the sweeps' and the exchanges' uniforms,
and a checkpoint stores its state beside the PT state and every handler.

As in the JAX driver, no global move fires and no proposal width is tuned
(``globalShift`` and ``accRatio`` are read and echoed, not used).
``mesh_devices > 1`` (replicas over several cards) raises
NotImplementedError: ROADMAP.md Queue 1 item 10.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from detqmc_tpu_torch import checkpoint as ckpt_mod
from detqmc_tpu_torch.driver import ConsistencyLogger, DriverConfig
from detqmc_tpu_torch.exceptions import ConfigurationError
from detqmc_tpu_torch.io.binarystream import BinaryStreamWriter
from detqmc_tpu_torch.metadata import Metadata, write_metadata
from detqmc_tpu_torch.observables import ObservableHandler
from detqmc_tpu_torch.parallel import pt as pt_mod
from detqmc_tpu_torch.timing import timing

_MESH = ("is not ported yet: ROADMAP.md Queue 1 item 10 (parallel "
         "tempering over several cards)")


@dataclasses.dataclass(frozen=True)
class PTConfig:
    exchange_interval: int = 1   # sweep pairs between exchange attempts
    # the model parameter the exchange swaps, checked against the model's
    # ``control_parameter`` ("r" SDW, "stagger_h" Hubbard)
    control_parameter: str = "r"
    # independent PT systems batched together: each grid value collects E
    # chains' measurements, the walker batch is E R
    n_ensembles: int = 1


def write_run_files(outdir: Optional[str], handlers, meta: Metadata,
                    info_extra: Metadata, attempted, accepted) -> None:
    """The end-of-run files of both PT drivers: each handler's results
    and ``info.dat`` in its ``p{k}/``, the run's ``info.dat`` and
    ``exchange-rates.dat`` (per adjacent pair: attempts, accepts, rate)."""
    for h in handlers:
        if h.outdir:
            os.makedirs(h.outdir, exist_ok=True)
            h.write_output()
            write_metadata(os.path.join(h.outdir, "info.dat"), dict(h.meta))
    if not outdir:
        return
    write_metadata(os.path.join(outdir, "info.dat"),
                   {**meta, **info_extra})
    with open(os.path.join(outdir, "exchange-rates.dat"), "w") as f:
        f.write("# pair attempted accepted rate\n")
        for i, (att, acc) in enumerate(zip(attempted, accepted)):
            f.write(f"{i} {att} {acc} {acc / max(att, 1):.4f}\n")


def restore_states(model, blank, arrays: Dict[str, np.ndarray]):
    """A checkpoint's walkers on ``model``: the saved leaves over a blank
    state, G and the stack rebuilt from the field, then every saved leaf
    over the refresh's (as the single-run driver resumes)."""
    restored = ckpt_mod.restore_state(blank, arrays)
    return model.refresh_from_field(restored)._replace(
        **{name: getattr(restored, name) for name in arrays})


class DetQMCPT:
    """Owns the E R replica walkers, the PT bookkeeping, the generator
    and one observable handler per grid value."""

    def __init__(self, model, r_values: Sequence[float],
                 params: DriverConfig, pt_params: PTConfig = PTConfig(),
                 meta_extra: Optional[Metadata] = None):
        supported = getattr(model, "control_parameter", "r")
        if pt_params.control_parameter != supported:
            raise ConfigurationError(
                f"PT control_parameter={pt_params.control_parameter!r} "
                f"but {type(model).__name__} exchanges {supported!r} (its "
                "with_r/exchange_action hooks)")
        if params.n_walkers != 1:
            raise ConfigurationError(
                "DetQMCPT runs one chain per replica; for more chains per "
                "parameter value use PTConfig.n_ensembles (config key "
                f"ptEnsembles) — got n_walkers={params.n_walkers}")
        if params.mesh_devices > 1:
            raise NotImplementedError(
                f"mesh_devices={params.mesh_devices} {_MESH}")
        self.model = model
        self.p = params
        self.ptp = pt_params
        self.R = len(r_values)
        self.E = max(1, int(pt_params.n_ensembles))
        self.r_values = torch.as_tensor(
            np.asarray(r_values, np.float64), dtype=model.cfg.torch_dtype,
            device=model.device)
        self.meta = {k: str(v) for k, v in
                     dataclasses.asdict(model.cfg).items()}
        self.meta.update({
            "exchangeInterval": str(pt_params.exchange_interval),
            "controlParameter": pt_params.control_parameter,
            "controlParameterValues": ",".join(str(v) for v in r_values),
            "ptEnsembles": str(self.E),
            **(meta_extra or {}),
        })
        # the per-value streams carry the key "r" for either model (the
        # JAX driver's files)
        self.handlers = [
            ObservableHandler(
                outdir=None if params.outdir is None else
                os.path.join(params.outdir, f"p{k}"),
                jk_blocks=params.jk_blocks, timeseries=params.timeseries,
                meta={**self.meta, "r": str(float(r_values[k]))})
            for k in range(self.R)]
        for h in self.handlers:
            h.register_vectors(getattr(model, "vector_observables", ()))
        self.generator = torch.Generator(model.device).manual_seed(
            params.seed)
        self.measurements_done = 0
        self.therm_done = 0
        self._t_start = time.time()
        self._consistency = ConsistencyLogger(params.outdir, self.meta)
        self._phi_streams: Dict[int, BinaryStreamWriter] = {}
        self.states = None
        self.pt_state: Optional[pt_mod.PTState] = None

    # -- checkpoint / resume --------------------------------------------------
    @property
    def _ckpt_path(self) -> Optional[str]:
        if self.p.outdir is None:
            return None
        return os.path.join(self.p.outdir, "state")

    def save(self) -> None:
        if self._ckpt_path is None or self.states is None:
            return
        extra: Dict[str, np.ndarray] = {}
        for k, h in enumerate(self.handlers):
            for name, arr in h.state_dict().items():
                extra[f"p{k}|{name}"] = arr
        for name, t in self.pt_state._asdict().items():
            extra[f"pt|{name}"] = t.cpu().numpy()
        manifest = {"measurements_done": self.measurements_done,
                    "therm_done": self.therm_done, "meta": self.meta}
        with timing("saveState"):
            ckpt_mod.save_checkpoint(self._ckpt_path, self.states, extra,
                                     manifest, self.generator)

    def init(self, resume: bool = True) -> None:
        """Fresh walkers (replica k of every system at grid value k), or
        the checkpoint in outdir."""
        loaded = None
        if resume and self._ckpt_path:
            loaded = ckpt_mod.load_checkpoint(self._ckpt_path)
        model, W = self.model, self.E * self.R
        if loaded is None:
            self.pt_state = pt_mod.init_pt(self.R, self.E, model.device)
            self.states = model.with_r(
                model.init_state(W, self.generator),
                pt_mod.replica_r(self.pt_state, self.r_values).reshape(-1))
            return
        arrays, extra, manifest, rng = loaded
        saved_e = int(manifest.get("meta", {}).get("ptEnsembles", 1))
        if saved_e != self.E:
            raise ConfigurationError(
                f"checkpoint has ptEnsembles={saved_e}, run configured "
                f"with n_ensembles={self.E}")
        blank = model.init_state(
            W, torch.Generator(model.device).manual_seed(self.p.seed))
        self.states = restore_states(model, blank, arrays)
        self.pt_state = pt_mod.PTState(*[
            torch.as_tensor(extra[f"pt|{name}"], dtype=torch.int64,
                            device=model.device)
            for name in pt_mod.PTState._fields])
        for k, h in enumerate(self.handlers):
            pref = f"p{k}|"
            h.load_state_dict({key[len(pref):]: arr
                               for key, arr in extra.items()
                               if key.startswith(pref)})
        if rng is not None:
            self.generator.set_state(rng)
        self.measurements_done = int(manifest.get("measurements_done", 0))
        self.therm_done = int(manifest.get("therm_done", 0))

    # -- one round ------------------------------------------------------------
    def round(self, measure: bool, draws: Optional[List[dict]] = None,
              u: Optional[torch.Tensor] = None):
        """``exchange_interval`` sweep pairs (the last one measured if
        ``measure``), then the exchange and the relabel. ``draws``: None,
        or one dict per pair of the model's ``sweep_pair`` draw keyword
        (``draws=`` SDW, ``u01=`` Hubbard); ``u``: the exchange's (E, R)
        uniforms or None. Returns (observables or None, the tag: each
        replica's grid index during the measurement, (E, R))."""
        model, ei = self.model, self.ptp.exchange_interval
        draws = draws or [{}] * ei
        obs = None
        for i in range(ei):
            last = measure and i == ei - 1
            self.states, o = model.sweep_pair(
                self.states, measure=last, generator=self.generator,
                **draws[i])
            if last:
                obs = o
        # the measurements ran under the INCOMING assignment: tag them
        # with it before the exchange relabels (a post-exchange tag books
        # every accepted swap's samples into the neighbouring value)
        tag = self.pt_state.param_of_replica
        actions = model.exchange_action(self.states).reshape(self.E, self.R)
        self.pt_state = pt_mod.exchange_step(
            self.pt_state, actions, self.r_values, u=u,
            generator=self.generator)
        self.states = model.with_r(self.states, pt_mod.replica_r(
            self.pt_state, self.r_values).reshape(-1))
        return obs, tag

    def _meas_block(self, n: int):
        """n measurement rounds; ({name: (n, E R, ...)}, tags (n, E R)) on
        the host."""
        obs, tags = [], []
        for _ in range(n):
            o, tag = self.round(measure=True)
            obs.append(o)
            tags.append(tag)
        return ({name: torch.stack([getattr(o, name) for o in obs]
                                   ).cpu().numpy()
                 for name in obs[0]._fields},
                torch.stack(tags).reshape(n, -1).cpu().numpy())

    # -- run ------------------------------------------------------------------
    def _out_of_time(self, margin: float = 0.0) -> bool:
        if self.p.walltime_secs <= 0:
            return False
        return (time.time() - self._t_start + margin) >= self.p.walltime_secs

    def _dump_configs(self) -> None:
        """Per-value phi dumps: each value's ``phi.binarystream`` receives
        the field of the replica holding it, one record per ensemble, so
        the offline sdwcorr pipeline reads a fixed-r ensemble."""
        if not (self.p.dump_config_stream and self.p.outdir
                and hasattr(self.states, "phi")):
            return
        phi = self.states.phi.reshape(self.E, self.R,
                                      *self.states.phi.shape[1:])
        phi = phi.cpu().numpy()
        rep_of_param = torch.argsort(self.pt_state.param_of_replica,
                                     dim=-1).cpu().numpy()
        for k in range(self.R):
            if k not in self._phi_streams:
                self._phi_streams[k] = BinaryStreamWriter(
                    os.path.join(self.p.outdir, f"p{k}", "phi.binarystream"),
                    phi.shape[2:])
            for e in range(self.E):
                self._phi_streams[k].append(phi[e, rep_of_param[e, k]])

    def run(self) -> Dict[int, Dict[str, Tuple[float, float]]]:
        """Thermalize, then measure, with wall-time-aware checkpoints; a
        resumed run continues the uninterrupted chain."""
        if self.states is None:
            self.init()
        ei = self.ptp.exchange_interval
        sync = self.r_values
        rounds_total = max(1, self.p.thermalization // ei)
        rounds_done = self.therm_done // ei
        t_block = 0.0
        while rounds_done < rounds_total:
            n = min(max(1, self.p.block_meas), rounds_total - rounds_done)
            t0 = time.time()
            with timing("thermalization", block_on=sync):
                for _ in range(n):
                    self.round(measure=False)
            t_block = time.time() - t0
            rounds_done += n
            self.therm_done = rounds_done * ei
            if self._out_of_time(margin=t_block):
                self.save()
                return {k: h.results() for k, h in enumerate(self.handlers)}

        n_meas = self.p.n_measurements
        block = min(self.p.block_meas, max(1, n_meas))
        while self.measurements_done < n_meas:
            n = min(block, n_meas - self.measurements_done)
            t0 = time.time()
            with timing("measurement block", block_on=sync):
                obs_np, pidx = self._meas_block(n)
            t_block = time.time() - t0
            # each (measurement, ensemble, replica) sample to the handler
            # of the value it was measured at
            for k in range(self.R):
                mask = pidx == k
                if mask.any():
                    self.handlers[k].insert_batch(
                        {name: arr[mask] for name, arr in obs_np.items()})
            self.measurements_done += n
            self._consistency.log(self.states)
            self._dump_configs()
            if (self.p.save_interval and self.measurements_done % max(
                    self.p.save_interval, 1) < block):
                self.save()
            if self._out_of_time(margin=t_block):
                self.save()
                break

        self.save()
        att, acc = [t.reshape(self.E, self.R - 1).sum(0).tolist()
                    for t in (self.pt_state.n_attempted,
                              self.pt_state.n_accepted)]
        write_run_files(self.p.outdir, self.handlers, self.meta,
                        {"measurementsDone": str(self.measurements_done),
                         **self._consistency.info_entries()}, att, acc)
        return {k: h.results() for k, h in enumerate(self.handlers)}
