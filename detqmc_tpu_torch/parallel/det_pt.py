"""Det-coupled parallel tempering: configuration swaps over a parameter
the determinant depends on (beta at fixed m, so dtau varies).

The port's counterpart of detqmc_tpu/parallel/det_pt.py. The label swap
(parallel/pt.py) covers parameters whose action is linear and
determinant-free (SDW r, Hubbard stagger_h). Tempering beta needs the
fermionic weight at swap time:

    log p = [log w_g(C') + log w_g'(C)] - [log w_g(C) + log w_g'(C')]

with w_g(C) the whole configuration weight under grid value g (the
models' ``log_weight``: one stabilized chain build and a log-det, in
float64).

One model per grid value, each with E walkers (independent chains), swept
in turn; the swap moves the CONFIGURATION between adjacent positions, so
position k always samples at value k and its measurements go straight to
value k's stream. Pairs alternate even / odd as in pt.py. Each exchange
evaluates the four log-weights of every pair and lane; an accepting lane
takes its neighbour's field, and both positions are refreshed from the
stacks the log-weights were read from (per lane the stack of the field
it keeps under its own model: bitwise ``refresh_from_field``'s), so no
chain is built twice and no decision goes through the host. The refresh
recomputes everything the field determines: G, the stack and, for the
Hubbard model, the sign (``_chain_sign``); the SDW phase is exactly 1.
What is not a function of the field stays with the position: the SDW
proposal width and r, the counters.

As in the JAX driver, no global move fires and no proposal width is
tuned. One ``torch.Generator`` on the models' device draws every sweep's
uniforms and each exchange's (G - 1, E) float32 uniforms; checkpoints
store its state.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from detqmc_tpu_torch import checkpoint as ckpt_mod
from detqmc_tpu_torch.driver import DriverConfig
from detqmc_tpu_torch.exceptions import ConfigurationError
from detqmc_tpu_torch.observables import ObservableHandler
from detqmc_tpu_torch.parallel.pt_driver import (_MESH, restore_states,
                                                 write_run_files)
from detqmc_tpu_torch.timing import timing


@dataclasses.dataclass(frozen=True)
class DetPTConfig:
    exchange_interval: int = 1    # sweep pairs between exchange attempts
    control_parameter: str = "beta"   # metadata only (the grid lives in
    #                                   the per-value model configs)
    n_ensembles: int = 1          # independent chains per grid value


def config_leaf(state) -> str:
    """Name of the state leaf that carries the sampled configuration."""
    for name in ("phi", "field"):
        if hasattr(state, name):
            return name
    raise ConfigurationError(
        "det-PT needs a state with a 'phi' or 'field' leaf")


def _pick(mask: torch.Tensor, new: torch.Tensor, old: torch.Tensor):
    """Per walker: ``new`` where mask, else ``old``."""
    return torch.where(mask.view(-1, *[1] * (new.ndim - 1)), new, old)


def _cat(states):
    """The walkers of several states of one layout, concatenated."""
    return type(states[0])(*[
        _cat(leaves) if isinstance(leaves[0], tuple) else torch.cat(leaves)
        for leaves in zip(*states)])


class DetQMCPTDet:
    """Config-swap PT over a list of per-grid-value model instances."""

    def __init__(self, models: Sequence[Any], values: Sequence[float],
                 params: DriverConfig,
                 pt_params: DetPTConfig = DetPTConfig(),
                 meta_extra: Optional[Dict[str, str]] = None):
        if len(models) != len(values) or len(models) < 2:
            raise ConfigurationError(
                f"need one model per grid value (>= 2): got {len(models)} "
                f"models, {len(values)} values")
        if params.n_walkers != 1:
            raise ConfigurationError(
                "DetQMCPTDet runs one chain per (value, ensemble); use "
                "DetPTConfig.n_ensembles for more chains per value")
        if params.mesh_devices > 1:
            raise NotImplementedError(
                f"mesh_devices={params.mesh_devices} {_MESH}")
        self.models = list(models)
        self.values = [float(v) for v in values]
        self.p = params
        self.ptp = pt_params
        self.G = len(models)
        self.E = max(1, int(pt_params.n_ensembles))
        self.meta = {k: str(v) for k, v in
                     dataclasses.asdict(models[0].cfg).items()}
        self.meta.update({
            "exchangeInterval": str(pt_params.exchange_interval),
            "controlParameter": pt_params.control_parameter,
            "controlParameterValues": ",".join(str(v) for v in self.values),
            "ptEnsembles": str(self.E),
            "ptScheme": "det-coupled config swap",
            **(meta_extra or {}),
        })
        self.handlers = [
            ObservableHandler(
                outdir=None if params.outdir is None else
                os.path.join(params.outdir, f"p{k}"),
                jk_blocks=params.jk_blocks, timeseries=params.timeseries,
                meta={**self.meta,
                      pt_params.control_parameter: str(self.values[k])})
            for k in range(self.G)]
        for h in self.handlers:
            h.register_vectors(getattr(models[0], "vector_observables", ()))
        dev = models[0].device
        self.generator = torch.Generator(dev).manual_seed(params.seed)
        self.states: Optional[List[Any]] = None
        self.parity = 0
        self.n_attempted = torch.zeros(self.G - 1, dtype=torch.int64,
                                       device=dev)
        self.n_accepted = torch.zeros_like(self.n_attempted)
        self.measurements_done = 0
        self.therm_done = 0
        self._t_start = time.time()

    # ---- exchange ----------------------------------------------------------
    def exchange(self, u: Optional[torch.Tensor] = None):
        """One DEO exchange (the pairs of the current parity). ``u``: the
        (G - 1, E) uniforms, or None to draw them (float32). Returns
        {g: (delta (E,) float64, accept (E,) bool)} of the pairs tried."""
        leaf = config_leaf(self.states[0])
        if u is None:
            u = torch.rand((self.G - 1, self.E), generator=self.generator,
                           dtype=torch.float32,
                           device=self.n_accepted.device)
        log_u = torch.log(torch.clamp(u, min=1e-38)).to(torch.float64)
        pairs = range(self.parity, self.G - 1, 2)
        fields = [getattr(st, leaf) for st in self.states]
        # own weights (and stacks), once per position in a pair
        own = {g: self.models[g].log_weight_and_stack(fields[g])
               for p in pairs for g in (p, p + 1)}
        out = {}
        for g in pairs:
            lw_lo, st_lo = self.models[g].log_weight_and_stack(fields[g + 1])
            lw_hi, st_hi = self.models[g + 1].log_weight_and_stack(fields[g])
            delta = (lw_lo + lw_hi) - (own[g][0] + own[g + 1][0])
            accept = log_u[g] < delta
            self.n_attempted[g] += self.E
            self.n_accepted[g] += accept.sum()
            for pos, other, cross in ((g, g + 1, st_lo), (g + 1, g, st_hi)):
                stack = type(cross)(*[_pick(accept, a, b) for a, b in
                                      zip(cross, own[pos][1])])
                st = self.states[pos]._replace(**{leaf: _pick(
                    accept, fields[other], fields[pos])})
                self.states[pos] = self.models[pos].refresh_from_stack(
                    st, stack)
            out[g] = (delta, accept)
        self.parity = 1 - self.parity
        return out

    # ---- checkpoint --------------------------------------------------------
    @property
    def _ckpt_path(self) -> Optional[str]:
        if self.p.outdir is None:
            return None
        return os.path.join(self.p.outdir, "state")

    def save(self) -> None:
        """The walkers of every position, concatenated (value-major),
        with the exchange counters, the handlers and the generator."""
        if self._ckpt_path is None or self.states is None:
            return
        extra: Dict[str, np.ndarray] = {}
        for k, h in enumerate(self.handlers):
            for name, arr in h.state_dict().items():
                extra[f"p{k}|{name}"] = arr
        extra["pt|parity"] = np.asarray(self.parity)
        extra["pt|n_attempted"] = self.n_attempted.cpu().numpy()
        extra["pt|n_accepted"] = self.n_accepted.cpu().numpy()
        manifest = {"measurements_done": self.measurements_done,
                    "therm_done": self.therm_done, "meta": self.meta}
        with timing("saveState"):
            ckpt_mod.save_checkpoint(self._ckpt_path, _cat(self.states),
                                     extra, manifest, self.generator)

    def init(self, resume: bool = True) -> None:
        loaded = None
        if resume and self._ckpt_path:
            loaded = ckpt_mod.load_checkpoint(self._ckpt_path)
        if loaded is None:
            self.states = [m.init_state(self.E, self.generator)
                           for m in self.models]
            return
        arrays, extra, manifest, rng = loaded
        E = self.E
        throwaway = torch.Generator(self.n_accepted.device).manual_seed(
            self.p.seed)
        self.states = [
            restore_states(m, m.init_state(E, throwaway),
                           {k: a[g * E:(g + 1) * E]
                            for k, a in arrays.items()})
            for g, m in enumerate(self.models)]
        self.parity = int(extra["pt|parity"])
        dev = self.n_accepted.device
        self.n_attempted = torch.as_tensor(extra["pt|n_attempted"],
                                           dtype=torch.int64, device=dev)
        self.n_accepted = torch.as_tensor(extra["pt|n_accepted"],
                                          dtype=torch.int64, device=dev)
        for k, h in enumerate(self.handlers):
            pref = f"p{k}|"
            h.load_state_dict({key[len(pref):]: arr
                               for key, arr in extra.items()
                               if key.startswith(pref)})
        if rng is not None:
            self.generator.set_state(rng)
        self.measurements_done = int(manifest.get("measurements_done", 0))
        self.therm_done = int(manifest.get("therm_done", 0))

    def _out_of_time(self, margin: float = 0.0) -> bool:
        if self.p.walltime_secs <= 0:
            return False
        return (time.time() - self._t_start
                + margin) >= self.p.walltime_secs

    # ---- run ---------------------------------------------------------------
    def _sweep(self, g: int, n: int) -> None:
        for _ in range(n):
            self.states[g], _ = self.models[g].sweep_pair(
                self.states[g], measure=False, generator=self.generator)

    def run(self) -> Dict[int, Dict[str, Tuple[float, float]]]:
        if self.states is None:
            self.init()
        ei = self.ptp.exchange_interval
        sync = self.n_accepted
        rounds_total = max(1, self.p.thermalization // ei)
        t_block = 0.0
        while self.therm_done // ei < rounds_total:
            t0 = time.time()
            with timing("thermalization", block_on=sync):
                for g in range(self.G):
                    self._sweep(g, ei)
                self.exchange()
            t_block = time.time() - t0
            self.therm_done += ei
            if self._out_of_time(margin=t_block):
                self.save()
                return {k: h.results() for k, h in enumerate(self.handlers)}

        while self.measurements_done < self.p.n_measurements:
            t0 = time.time()
            with timing("measurement round", block_on=sync):
                for g in range(self.G):
                    self._sweep(g, ei - 1)
                    self.states[g], obs = self.models[g].sweep_pair(
                        self.states[g], measure=True,
                        generator=self.generator)
                    self.handlers[g].insert_batch(
                        {name: v.cpu().numpy()
                         for name, v in obs._asdict().items()})
                self.exchange()
            t_block = time.time() - t0
            self.measurements_done += 1
            if (self.p.save_interval and self.measurements_done
                    % max(self.p.save_interval, 1) == 0):
                self.save()
            if self._out_of_time(margin=t_block):
                self.save()
                break

        self.save()
        write_run_files(self.p.outdir, self.handlers, self.meta,
                        {"measurementsDone": str(self.measurements_done)},
                        self.n_attempted.tolist(), self.n_accepted.tolist())
        return {k: h.results() for k, h in enumerate(self.handlers)}
