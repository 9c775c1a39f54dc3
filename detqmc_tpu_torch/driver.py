"""Monte-Carlo driver: thermalize, sweep, measure, checkpoint, resume.

Reference parity: SURVEY.md §3 row "MC driver" (DetQMC<Model>::run —
thermalization, measurement sweeps every measureInterval, periodic
saveState every saveInterval, wall-time budget awareness, resume, final
results) and §4.1's call stack.

The port's copy of detqmc_tpu/driver.py. Where the JAX driver compiles
one ``jit(vmap(scan))`` program per block, this one runs Python loops over
the model's ``sweep_pair`` on the walker-batched state (walkers lead
every tensor), drawing every sweep's uniforms from one ``torch.Generator``
on the model's device, seeded from ``DriverConfig.seed``. The host works
between blocks as there: observable accumulation, .series appends,
checkpoints, wall-time checks; the unequal-time measurements
(``timedisplaced``, ``currentCorrelators``) run once per measurement
block; ``ConsistencyLogger``, ``auto_stabilize`` and the save interval
behave as in the JAX driver, and the output files are the same.

The SDW parts of the JAX driver, as there: the model's global moves fire
after each sweep pair that crosses a ``globalUpdateInterval`` boundary
(``global_fire_flags``; thermalization counts 2 sweeps a pair, the
measurements 2 ``measure_interval`` sweeps a measurement, after its
measured pair, so the observables come before the move); after each
thermalization block every walker's ``box_width`` is multiplied by
clip(acceptance / target_acc_ratio, 0.5, 2) (``tuned_box_width``, the
walker's mean sweep acceptance over the block); ``dump_config_stream``
appends the field to ``phi.binarystream`` after each measurement block.
A resume restores every saved leaf after ``refresh_from_field``, so it
serves both models.

Not ported (each raises or is left out, as noted): ``mesh_devices > 1``
(walkers over several cards, ROADMAP.md Queue 1 item 10) raises
NotImplementedError; the compilation cache has no counterpart (Queue 1
item 12).
``profile_dir`` records a torch.profiler trace of the first measurement
block (``trace.json``) where the JAX driver records a jax.profiler one.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from detqmc_tpu_torch import checkpoint as ckpt_mod
from detqmc_tpu_torch.io.binarystream import BinaryStreamWriter
from detqmc_tpu_torch.io.series import SeriesWriter
from detqmc_tpu_torch.metadata import Metadata, write_metadata
from detqmc_tpu_torch.observables import ObservableHandler
from detqmc_tpu_torch.timing import timing


@dataclasses.dataclass(frozen=True)
class DriverConfig:
    """Reference: DetQMCParams (SURVEY.md §3 "Config/flag system"). Field
    for field the JAX package's DriverConfig, so a run's info.dat carries
    the same keys (the fields marked below are echoed, not read).

    All sweep counts are in *sweep pairs* (one up+down pass = 2 reference
    sweeps).
    """

    sweeps: int = 200              # production measurements... see below
    thermalization: int = 100      # thermalization sweep pairs
    measure_interval: int = 1      # sweep pairs between measurements
    save_interval: int = 0         # measurements between checkpoints (0=off)
    jk_blocks: int = 20
    timeseries: bool = False
    walltime_secs: float = 0.0     # 0 = unlimited (grantedWalltimeSecs)
    outdir: Optional[str] = None
    n_walkers: int = 1
    seed: int = 0
    block_meas: int = 25           # measurements per block
    timedisplaced: bool = False    # unequal-time G(k, tau) once per block
    # resolve G(k, tau) at every slice (m+1 tau points) instead of the K+1
    # stabilization-grid points; the wrap deviation is recorded as the
    # timeDisplacedDev observable, the pairing susceptibilities beside it
    timedisplaced_slices: bool = False
    # tau-integrated current-current correlator Lambda_xx(q, iw=0) +
    # superfluid stiffness rho_s once per block (Hubbard)
    current_correlators: bool = False
    # walkers over several cards: not ported (ROADMAP.md Queue 1 item 10)
    mesh_devices: int = 0
    # proposal-width tuning toward target_acc_ratio after each
    # thermalization block, and phi dumps to phi.binarystream after each
    # measurement block (models with box_width / phi: SDW)
    target_acc_ratio: float = 0.5
    tune_proposals: bool = True
    dump_config_stream: bool = False
    # auto-stabilization: when the walker-median wrapped-vs-stabilized
    # Green deviation exceeds green_dev_threshold after a thermalization
    # block, step the stabilization interval s down to the next divisor
    # of m (<= s/2) and rebuild the model (thermalization only)
    auto_stabilize: bool = False
    green_dev_threshold: float = 1e-3
    # a torch.profiler trace of the FIRST measurement block, written to
    # <profile_dir>/trace.json (Chrome / Perfetto format)
    profile_dir: Optional[str] = None

    @property
    def n_measurements(self) -> int:
        return self.sweeps // self.measure_interval


class ConsistencyLogger:
    """Run-output numerical self-checks (reference: DetModelLoggingParams'
    logSV singular-value files + wrapped-vs-stabilized Green deviation
    logging, SURVEY.md §5 item 1).

    Appends one row per measurement block to ``greendev.series`` (walker
    median + max of the wrapped-vs-freshly-stabilized G deviation) and
    ``sv.series`` (walker medians of the log10 extreme stack singular
    values), and exposes the latest values for the info.dat echo."""

    def __init__(self, outdir: Optional[str], meta: Optional[Metadata]):
        self.outdir = outdir
        self.meta = meta
        self._writers = None
        self.last: Dict[str, float] = {}

    def log(self, states) -> None:
        if self.outdir is None:
            return
        dev, svlo, svhi = [getattr(states, n).double().cpu().numpy().ravel()
                           for n in ("green_dev", "sv_min", "sv_max")]
        self.last = {
            "greenDevMedian": float(np.median(dev)),
            "greenDevMax": float(dev.max()),
            "svLog10Min": float(np.median(svlo)),
            "svLog10Max": float(np.median(svhi)),
        }
        if self._writers is None:
            self._writers = (
                SeriesWriter(f"{self.outdir}/greendev.series",
                             "greendev: median max", meta=self.meta),
                SeriesWriter(f"{self.outdir}/sv.series",
                             "sv: log10_min log10_max", meta=self.meta),
            )
        self._writers[0].append(np.asarray(
            [[self.last["greenDevMedian"], self.last["greenDevMax"]]]))
        self._writers[1].append(np.asarray(
            [[self.last["svLog10Min"], self.last["svLog10Max"]]]))

    def info_entries(self) -> Dict[str, str]:
        return {k: repr(v) for k, v in self.last.items()}


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def global_fire_flags(start_sweeps: int, n_units: int, sweeps_per_unit: int,
                      interval: int) -> list:
    """fire[t] is True iff unit t of a block (sweeps_per_unit sweeps from
    start_sweeps + t sweeps_per_unit) crosses a multiple of ``interval``
    sweeps: the global moves are attempted every ``interval`` sweeps
    (detqmc_tpu/driver.py _global_fire_flags); none for interval <= 0."""
    if interval <= 0:
        return [False] * n_units
    s0 = start_sweeps + sweeps_per_unit * np.arange(n_units)
    return ((s0 + sweeps_per_unit) // interval > s0 // interval).tolist()


def tuned_box_width(box_width: torch.Tensor, acceptance: torch.Tensor,
                    target: float) -> torch.Tensor:
    """Each walker's proposal width times clip(acceptance / target, 0.5,
    2), acceptance (W,) its mean sweep acceptance over a thermalization
    block (detqmc_tpu/driver.py's tuning between device blocks)."""
    factor = torch.clamp(acceptance / target, 0.5, 2.0)
    return (box_width * factor).to(box_width.dtype)


class DetQMC:
    """Owns model + walker states + generator + observable handler
    (reference: DetQMC owns model, RNG, handlers)."""

    def __init__(self, model, params: DriverConfig,
                 meta_extra: Optional[Metadata] = None):
        if params.mesh_devices > 1:
            raise NotImplementedError(
                f"mesh_devices={params.mesh_devices} (walkers over several "
                "cards) is not ported yet: ROADMAP.md Queue 1 item 10")
        if params.current_correlators and not hasattr(
                model, "measure_current_correlators"):
            raise ValueError(
                f"{type(model).__name__} has no current-correlator "
                "measurement (currentCorrelators is Hubbard-only)")
        self.model = model
        self.p = params
        self.meta = self._build_metadata(meta_extra or {})
        self.handler = ObservableHandler(
            outdir=params.outdir, jk_blocks=params.jk_blocks,
            timeseries=params.timeseries, meta=self.meta)
        self.handler.register_vectors(
            getattr(model, "vector_observables", ()))
        self.generator = torch.Generator(model.device).manual_seed(
            params.seed)
        self.measurements_done = 0
        self.therm_done = 0
        self._t_start = time.time()
        self._stopped_early = False
        self._phi_stream = None
        self._consistency = ConsistencyLogger(params.outdir, self.meta)
        self.states = None

    # -- setup / resume -----------------------------------------------------
    def _build_metadata(self, extra: Metadata) -> Metadata:
        meta: Metadata = {}
        for k, v in dataclasses.asdict(self.model.cfg).items():
            meta[k] = str(v)
        for k, v in dataclasses.asdict(self.p).items():
            if k != "outdir":
                meta[k] = str(v)
        meta.update(extra)
        return meta

    @property
    def _ckpt_path(self) -> Optional[str]:
        if self.p.outdir is None:
            return None
        return f"{self.p.outdir}/state"

    def init(self, resume: bool = True) -> None:
        """Fresh start, or resume from a checkpoint in outdir (reference:
        resume-from-state with G recomputed on load, SURVEY.md §6)."""
        loaded = None
        if resume and self._ckpt_path:
            loaded = ckpt_mod.load_checkpoint(self._ckpt_path)
        if loaded is None:
            with timing("init", block_on=self.model.expK):
                self.states = self.model.init_state(self.p.n_walkers,
                                                    self.generator)
            return
        arrays, handler_arrays, manifest, rng = loaded
        # a blank state of the right layout from a throwaway generator:
        # the saved leaves replace its own, refresh rebuilds G and stacks
        blank = self.model.init_state(
            self.p.n_walkers,
            torch.Generator(self.model.device).manual_seed(self.p.seed))
        restored = ckpt_mod.restore_state(blank, arrays)
        # every saved leaf wins over the refresh's: Hubbard's sign was
        # tracked exactly through accepted-ratio signs, and SDW's
        # box_width, r and phase are not functions of the field
        self.states = self.model.refresh_from_field(restored)._replace(
            **{name: getattr(restored, name) for name in arrays})
        if rng is not None:
            self.generator.set_state(rng)
        self.handler.load_state_dict(handler_arrays)
        self.measurements_done = int(manifest.get("measurements_done", 0))
        self.therm_done = int(manifest.get("therm_done", 0))

    # -- device blocks --------------------------------------------------------
    def _pair(self, measure: bool):
        self.states, obs = self.model.sweep_pair(
            self.states, measure=measure, generator=self.generator)
        return obs

    def _fire_flags(self, start_sweeps: int, n_units: int,
                    sweeps_per_unit: int) -> list:
        interval = (getattr(self.model.cfg, "globalUpdateInterval", 0)
                    if getattr(self.model, "has_global_moves", False) else 0)
        return global_fire_flags(start_sweeps, n_units, sweeps_per_unit,
                                 interval)

    def _maybe_global(self, fire: bool) -> None:
        if fire:
            self.states = self.model.global_moves(self.states,
                                                  generator=self.generator)

    def _therm_block(self, n: int) -> torch.Tensor:
        """n sweep pairs; returns each walker's mean sweep acceptance over
        them (W,)."""
        acc = 0.0
        for fire in self._fire_flags(2 * self.therm_done, n, 2):
            acc = acc + self._pair(False).acceptance
            self._maybe_global(fire)
        return acc / n

    def _meas_block(self, n: int) -> Dict[str, np.ndarray]:
        """n measurements, each measure_interval sweep pairs (the last one
        measured, the global moves after it); {name: (n, W, ...)}."""
        obs = []
        unit = 2 * self.p.measure_interval
        for fire in self._fire_flags(unit * self.measurements_done, n, unit):
            for _ in range(self.p.measure_interval - 1):
                self._pair(False)
            obs.append(self._pair(True))
            self._maybe_global(fire)
        return {name: _numpy(torch.stack([getattr(o, name) for o in obs]))
                for name in obs[0]._fields}

    def _dump_phi(self) -> None:
        """Append every walker's field to phi.binarystream (one float64
        record per walker, (m, N, opdim))."""
        if not (self.p.dump_config_stream and self.p.outdir
                and hasattr(self.states, "phi")):
            return
        phi = _numpy(self.states.phi)
        if self._phi_stream is None:
            self._phi_stream = BinaryStreamWriter(
                f"{self.p.outdir}/phi.binarystream", phi.shape[1:])
        self._phi_stream.append(phi)

    def _block_measurements(self, batch: Dict[str, np.ndarray]) -> None:
        """The once-per-block unequal-time measurements, one sample each."""
        model, st = self.model, self.states
        if self.p.timedisplaced and hasattr(model, "measure_time_displaced"):
            slices = self.p.timedisplaced_slices
            chi = slices and hasattr(model, "pair_susceptibilities")
            out = model.measure_time_displaced(st, per_slice=slices,
                                               susceptibilities=chi)
            if chi:
                gk, td_dev, ps, pd = out
                batch["pairingSusceptibilityS"] = _numpy(ps)[None]
                batch["pairingSusceptibilityD"] = _numpy(pd)[None]
            elif slices:
                gk, td_dev = out                      # (W, m+1, N), (W,)
            else:
                gk = out                              # (W, K+1, N)
            if slices:
                batch["timeDisplacedDev"] = _numpy(td_dev)[None]
            gk = _numpy(gk)
            batch["greenKTauVector"] = gk.reshape(1, gk.shape[0], -1)
        if self.p.current_correlators:
            lam_q, rho_s, cdev = model.measure_current_correlators(st)
            batch["currentCorrelatorVector"] = _numpy(lam_q)[None]
            batch["rhoS"] = _numpy(rho_s)[None]
            batch["currentWrapDev"] = _numpy(cdev)[None]

    # -- auto-stabilization ---------------------------------------------------
    def _maybe_auto_stabilize(self) -> None:
        """Step cfg.s down when the wrapped-G drift trips the threshold
        (thermalization only — see DriverConfig.auto_stabilize)."""
        if not self.p.auto_stabilize:
            return
        dev = float(np.median(_numpy(self.states.green_dev)))
        s = int(self.model.cfg.s)
        if dev <= self.p.green_dev_threshold or s <= 1:
            return
        m = int(self.model.cfg.m)
        new_s = max((d for d in range(1, s) if m % d == 0
                     and d <= max(1, s // 2)), default=1)
        logging.getLogger(__name__).warning(
            "auto_stabilize: green_dev median %.2e > %.1e; "
            "s %d -> %d (model rebuilt)",
            dev, self.p.green_dev_threshold, s, new_s)
        self.model = type(self.model)(
            dataclasses.replace(self.model.cfg, s=new_s),
            device=self.model.device)
        # the stack (a RECOMPUTED leaf) is rebuilt for the new interval
        self.states = self.model.refresh_from_field(self.states)
        self.meta["s"] = str(new_s)
        self.meta["autoStabilized"] = "true"

    # -- wall-time ------------------------------------------------------------
    def _out_of_time(self, margin: float = 0.0) -> bool:
        if self.p.walltime_secs <= 0:
            return False
        return (time.time() - self._t_start + margin) >= self.p.walltime_secs

    def save(self) -> None:
        if self._ckpt_path is None:
            return
        manifest: Dict[str, Any] = {
            "measurements_done": self.measurements_done,
            "therm_done": self.therm_done,
            "meta": self.meta,
        }
        with timing("saveState"):
            ckpt_mod.save_checkpoint(self._ckpt_path, self.states,
                                     self.handler.state_dict(), manifest,
                                     self.generator)
        info = dict(self.meta)
        info["measurementsDone"] = str(self.measurements_done)
        info["thermalizationDone"] = str(self.therm_done)
        info.update(self._consistency.info_entries())
        write_metadata(f"{self.p.outdir}/info.dat", info)

    # -- main loop ---------------------------------------------------------------
    def run(self) -> Dict[str, tuple]:
        """Thermalize, then measure; returns jackknifed results.

        Stops early (after a clean checkpoint) when the wall-time budget is
        about to run out — the reference's batch-queue pattern."""
        if self.states is None:
            self.init()
        # thermalization in blocks so walltime checks stay responsive
        block = max(1, self.p.block_meas * self.p.measure_interval)
        t_block = None
        while self.therm_done < self.p.thermalization:
            n = min(block, self.p.thermalization - self.therm_done)
            with timing("thermalization", block_on=self.model.expK):
                acc = self._therm_block(n)
            self.therm_done += n
            if self.p.tune_proposals and hasattr(self.states, "box_width"):
                self.states = self.states._replace(box_width=tuned_box_width(
                    self.states.box_width, acc, self.p.target_acc_ratio))
            self._maybe_auto_stabilize()
            if self._out_of_time(margin=(t_block or 0.0)):
                self.save()
                self._stopped_early = True
                return self.handler.results()

        while self.measurements_done < self.p.n_measurements:
            t0 = time.time()
            n_new = min(self.p.block_meas,
                        self.p.n_measurements - self.measurements_done)
            profile_this = (self.p.profile_dir
                            and self.measurements_done == 0)
            with timing("measurement block", block_on=self.model.expK):
                if profile_this:
                    from torch.profiler import ProfilerActivity, profile

                    acts = [ProfilerActivity.CPU]
                    if self.model.device.type == "cuda":
                        acts.append(ProfilerActivity.CUDA)
                    with profile(activities=acts) as prof:
                        batch = self._meas_block(n_new)
                    os.makedirs(self.p.profile_dir, exist_ok=True)
                    prof.export_chrome_trace(
                        os.path.join(self.p.profile_dir, "trace.json"))
                else:
                    batch = self._meas_block(n_new)
            t_block = time.time() - t0
            self._block_measurements(batch)
            self.handler.insert_batch(batch)
            self._dump_phi()
            self._consistency.log(self.states)
            self.measurements_done += n_new
            if (self.p.save_interval and self.measurements_done %
                    self.p.save_interval < self.p.block_meas):
                self.save()
            if self._out_of_time(margin=t_block):
                self.save()
                self._stopped_early = True
                break

        self.save()
        if self.p.outdir:
            self.handler.write_output()
        return self.handler.results()

    @property
    def stopped_early(self) -> bool:
        return self._stopped_early
