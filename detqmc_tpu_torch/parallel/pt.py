"""Replica-exchange parallel tempering: the label-swap exchange step.

The port's counterpart of detqmc_tpu/parallel/pt.py (reference parity:
SURVEY.md §3 row "Parallel tempering" and §4.3, DetQMCPT). R replicas sit
at the values of a control-parameter grid; every exchange proposes swaps
of the parameter LABELS of replicas holding adjacent values, accepted
with

    p = min(1, exp[(r_i - r_j)(a_i - a_j)])

where a is the parameter-conjugate action piece of each replica's
configuration (SDW: dtau/2 sum phi^2; Hubbard: -sum eta s). The
configurations never move, so no determinant is recomputed. Pairs
alternate even / odd (the DEO scheme), each exchange touching every pair
of one parity once.

From JAX to PyTorch: the JAX ``vmap`` over E independent PT systems is a
leading axis written out — ``PTState`` tensors are (R,) ... or (E, R) ...,
and ``exchange_step`` takes any leading shape. The threefry key is gone:
the swap uniforms come from a caller's ``torch.Generator`` (float32, as
the JAX package draws them on its device) or are injected (``u``), which
is how the tests feed JAX's own. The log of the uniform is taken in its
own dtype and compared in the grid's, as there. Every operation runs on
the tensors' device with no host synchronization.

Not ported: ``exchange_step_sharded`` (replicas over several cards,
ROADMAP.md Queue 1 item 10).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class PTState(NamedTuple):
    """Replica-exchange bookkeeping; a leading (E,) axis with ensembles."""

    param_of_replica: torch.Tensor   # (..., R) int64: grid index held
    n_attempted: torch.Tensor        # (..., R-1) int64 pair attempts
    n_accepted: torch.Tensor         # (..., R-1) int64
    parity: torch.Tensor             # (...) int64: even / odd alternation


def init_pt(n_replicas: int, n_ensembles: Optional[int] = None,
            device=None) -> PTState:
    """Replica k at grid value k; ``n_ensembles`` None gives unbatched
    (R,) tensors, an int E gives (E, R)."""
    lead = () if n_ensembles is None else (n_ensembles,)
    i64 = dict(dtype=torch.int64, device=device)
    return PTState(
        param_of_replica=torch.arange(n_replicas, **i64).expand(
            *lead, n_replicas).contiguous(),
        n_attempted=torch.zeros(*lead, n_replicas - 1, **i64),
        n_accepted=torch.zeros(*lead, n_replicas - 1, **i64),
        parity=torch.zeros(lead, **i64))


def exchange_step(pt: PTState, actions: torch.Tensor,
                  r_values: torch.Tensor, u: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None) -> PTState:
    """One exchange (the pairs of the current parity) per PT system.

    actions: (..., R) the conjugate action of each REPLICA's configuration;
    r_values: (R,) the grid; u: (..., R) uniforms, or None to draw them
    (float32) from ``generator``. Replicas are ordered by the value they
    hold, so swaps are between adjacent VALUES (reference semantics)."""
    R = pt.param_of_replica.shape[-1]
    dev = actions.device
    if u is None:
        u = torch.rand(actions.shape, generator=generator,
                       dtype=torch.float32, device=dev)
    replica_of_param = torch.argsort(pt.param_of_replica, dim=-1)
    a_sorted = torch.gather(actions, -1, replica_of_param)
    r_sorted = r_values[torch.sort(pt.param_of_replica, dim=-1).values]
    # pair p = (2t + parity, 2t + parity + 1)
    idx = torch.arange(R, device=dev)
    par = pt.parity[..., None]
    is_left = ((idx - par) % 2 == 0) & (idx + 1 < R) & (idx >= par)
    partner = torch.where(is_left, idx + 1, idx)
    log_p = ((r_sorted - torch.gather(r_sorted, -1, partner))
             * (a_sorted - torch.gather(a_sorted, -1, partner)))
    log_u = torch.log(torch.clamp(u, min=1e-38)).to(log_p.dtype)
    # a pair swaps iff its left member accepts
    accept_left = is_left & (log_u < log_p)
    swap_with_prev = torch.roll(accept_left, 1, dims=-1) & (idx > 0)
    new_pos = torch.where(accept_left, idx + 1,
                          torch.where(swap_with_prev, idx - 1, idx))
    # the replica at sorted position i, replica_of_param[i], moves to
    # grid value new_pos[i]
    new_param = torch.empty_like(pt.param_of_replica).scatter_(
        -1, replica_of_param, new_pos)
    return PTState(
        param_of_replica=new_param,
        n_attempted=pt.n_attempted + is_left[..., :R - 1],
        n_accepted=pt.n_accepted + accept_left[..., :R - 1],
        parity=1 - pt.parity)


def replica_r(pt: PTState, r_values: torch.Tensor) -> torch.Tensor:
    """The grid value each replica holds: (..., R)."""
    return r_values[pt.param_of_replica]
