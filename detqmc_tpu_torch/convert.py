"""Carry a walker state from the JAX package into the port.

``state_from_jax`` takes a ``detqmc_tpu.models.hubbard.WalkerState`` —
vmapped over walkers (leading axis) or a single walker — or any object
with the same leaf names whose leaves ``np.asarray`` accepts, and returns
the port's ``WalkerState`` on ``device``. JAX's PRNG ``key`` is dropped:
the port draws from a ``torch.Generator`` held by the caller. No JAX import
is needed: the leaves are read as numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from detqmc_tpu_torch.models.hubbard import Stack, WalkerState


def state_from_jax(jstate, device=None) -> WalkerState:
    batched = np.asarray(jstate.field).ndim == 3

    def t(leaf):
        a = np.array(leaf)               # a writable copy of the leaf
        return torch.as_tensor(a if batched else a[None], device=device)

    return WalkerState(
        field=t(jstate.field), G=t(jstate.G),
        stack=Stack(t(jstate.stack.U), t(jstate.stack.d), t(jstate.stack.V)),
        sign=t(jstate.sign), next_dir=t(jstate.next_dir),
        sweeps_done=t(jstate.sweeps_done), green_dev=t(jstate.green_dev),
        sv_min=t(jstate.sv_min), sv_max=t(jstate.sv_max), h=t(jstate.h))
