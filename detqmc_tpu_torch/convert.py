"""Carry a walker state from the JAX package into the port.

``state_from_jax`` takes a ``detqmc_tpu.models.hubbard.WalkerState`` and
``sdw_state_from_jax`` a ``detqmc_tpu.models.sdw.SDWState`` (of the
``fermion_repr="complex"`` chain: full or reduced, complex or, at opdim 1,
real) — vmapped over walkers (leading axis)
or a single walker — or any object with the same leaf names whose leaves
``np.asarray`` accepts, and return the port's state on ``device``. JAX's
PRNG ``key`` is dropped: the port draws from a ``torch.Generator`` held by
the caller. No JAX import is needed: the leaves are read as numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from detqmc_tpu_torch.models.hubbard import Stack, WalkerState
from detqmc_tpu_torch.models.sdw import SDWState


def _leaf_reader(batched: bool, device):
    def t(leaf):
        a = np.array(leaf)               # a writable copy of the leaf
        return torch.as_tensor(a if batched else a[None], device=device)
    return t


def state_from_jax(jstate, device=None) -> WalkerState:
    t = _leaf_reader(np.asarray(jstate.field).ndim == 3, device)

    return WalkerState(
        field=t(jstate.field), G=t(jstate.G),
        stack=Stack(t(jstate.stack.U), t(jstate.stack.d), t(jstate.stack.V)),
        sign=t(jstate.sign), next_dir=t(jstate.next_dir),
        sweeps_done=t(jstate.sweeps_done), green_dev=t(jstate.green_dev),
        sv_min=t(jstate.sv_min), sv_max=t(jstate.sv_max), h=t(jstate.h))


def sdw_state_from_jax(jstate, device=None) -> SDWState:
    phi = np.asarray(jstate.phi)
    t = _leaf_reader(phi.ndim == 4, device)
    G = np.asarray(jstate.G)
    # the real embedding and the native pair planes hold real G at
    # opdim >= 2 (or an extra plane axis)
    if G.ndim != phi.ndim - 1 or (not np.iscomplexobj(G)
                                  and phi.shape[-1] != 1):
        raise ValueError("sdw_state_from_jax needs the complex chain "
                         "(fermion_repr='complex'), not pair planes or the "
                         "real embedding")
    return SDWState(*[t(getattr(jstate, name)) for name in SDWState._fields])
