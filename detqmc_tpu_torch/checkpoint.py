"""Checkpoint / resume: flat npz of the minimal resumable state.

Reference parity: SURVEY.md §6 "Checkpoint / resume" — the reference
serializes field configuration, RNG state, sweep counters and observable
accumulators (boost archives); Green's function and UdV stacks are
reconstructed from the field on load. The port's copy of
detqmc_tpu/checkpoint.py keeps that contract: ``refresh_from_field``
rebuilds G + stacks (the ``RECOMPUTED`` leaves are never written), so
checkpoints are small and layout-agnostic. Where the JAX package stores
each walker's threefry key as a state leaf, the port stores the state of
the driver's ``torch.Generator`` (``rng/generator``, its uint8 state
bytes), so a resumed run draws what the uninterrupted one would have.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

# state leaves that are cheap to rebuild from the field configuration and
# are therefore never serialized (reference behavior: G and the UdV stacks
# are reconstructed on load, SURVEY.md §6)
RECOMPUTED = ("G", "stack", "stack_U", "stack_d", "stack_V",
              "green_dev", "sv_min", "sv_max")
_RNG = "rng/generator"


def save_checkpoint(path: str, state, handler_state: Dict[str, np.ndarray],
                    manifest: Dict[str, Any],
                    generator: Optional[torch.Generator] = None) -> None:
    """Atomically write `<path>.npz` + `<path>.json`.

    Model-agnostic: every NamedTuple field of the walker state except the
    RECOMPUTED ones is saved by name (Hubbard: field/sign/...), and the
    generator's state beside them."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays: Dict[str, np.ndarray] = {}
    for name in state._fields:
        if name not in RECOMPUTED:
            arrays[f"st/{name}"] = getattr(state, name).cpu().numpy()
    if generator is not None:
        arrays[_RNG] = generator.get_state().numpy()
    for k, v in handler_state.items():
        arrays[f"obs/{k}"] = v
    tmp = f"{path}.npz.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, f"{path}.npz")
    tmpj = f"{path}.json.tmp"
    with open(tmpj, "w") as f:
        json.dump(manifest, f, indent=1, default=str)
    os.replace(tmpj, f"{path}.json")


def load_checkpoint(path: str) -> Optional[Tuple[
        Dict[str, np.ndarray], Dict[str, np.ndarray], Dict[str, Any],
        Optional[torch.Tensor]]]:
    """Returns (state arrays, handler arrays, manifest, generator state or
    None) or None."""
    if not (os.path.exists(f"{path}.npz") and os.path.exists(f"{path}.json")):
        return None
    with np.load(f"{path}.npz") as z:
        arrays = {k: z[k] for k in z.files}
    with open(f"{path}.json") as f:
        manifest = json.load(f)
    handler = {k[len("obs/"):]: v for k, v in arrays.items()
               if k.startswith("obs/")}
    state = {k[len("st/"):]: v for k, v in arrays.items()
             if k.startswith("st/")}
    rng = arrays.get(_RNG)
    return (state, handler, manifest,
            None if rng is None else torch.as_tensor(rng))


def restore_state(blank, arrays: Dict[str, np.ndarray]):
    """Rebuild a walker-state NamedTuple from saved arrays: saved leaves
    replace the blank's (cast to its dtype, on its device); RECOMPUTED
    leaves keep the blank's values until the model's refresh_from_field
    runs."""
    updates = {}
    for name, arr in arrays.items():
        ref = getattr(blank, name)
        updates[name] = torch.as_tensor(arr).to(dtype=ref.dtype,
                                                device=ref.device)
    return blank._replace(**updates)
