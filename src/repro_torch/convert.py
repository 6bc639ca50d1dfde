"""Weights and state carried across from the reference.

The reference's parameters are dicts of worker-stacked arrays with the
same names and layouts as the port's (``core.tasks``), so carrying them is
a dtype-preserving copy. The model zoo's parameter trees
(``models.model``) also keep the reference's names and layouts, so
``model_params_from_jax`` is a leaf-by-leaf copy too. The reference's
``DeFTAState`` fields arrive as numpy arrays (``{field:
np.asarray(...)}``), the DTS v3 ``sketch`` ring buffer among them; its
PRNG ``key`` has no counterpart here (the port's randomness comes from an
``rng`` draw provider). The
reference's ``FedAvgState`` arrives the same way: ``server`` a dict of
arrays, ``opt`` None or ``{"m": ..., "v": ...}``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import DeFTAState, FedAvgState
from repro_torch.device import resolve_device, to_numpy, to_torch

STATE_FIELDS = ("params", "backup", "conf", "best_loss", "last_loss",
                "epoch", "wire_err", "sketch")


def params_from_jax(tree, device=None) -> dict:
    """A dict of reference parameter arrays (numpy) -> dict of tensors."""
    return to_torch(dict(tree), resolve_device(device))


def params_to_numpy(params: dict) -> dict:
    """The inverse of ``params_from_jax``."""
    return to_numpy(params)


def state_from_jax(fields: dict, device=None) -> DeFTAState:
    """The reference's ``DeFTAState`` fields as numpy (a dict keyed by
    field name) -> the port's ``DeFTAState``."""
    dev = resolve_device(device)
    return DeFTAState(**{f: to_torch(fields.get(f), dev)
                         for f in STATE_FIELDS})


def state_to_numpy(state: DeFTAState) -> dict:
    """The port's state -> ``{field: numpy tree}`` (the inverse of
    ``state_from_jax``, without the reference's key)."""
    return {f: to_numpy(getattr(state, f)) for f in STATE_FIELDS}


def fedavg_state_from_jax(fields: dict, device=None) -> FedAvgState:
    """The reference's ``FedAvgState`` fields as numpy (``{"server": {...},
    "opt": None | {"m": {...}, "v": {...}}}``) -> the port's
    ``FedAvgState``."""
    dev = resolve_device(device)
    return FedAvgState(server=to_torch(fields["server"], dev),
                       opt=to_torch(fields.get("opt"), dev))


def fedavg_state_to_numpy(state: FedAvgState) -> dict:
    """The inverse of ``fedavg_state_from_jax``."""
    return {"server": to_numpy(state.server), "opt": to_numpy(state.opt)}


def model_params_from_jax(tree, device=None, dtype=None) -> dict:
    """A nested dict of the reference's model parameters as numpy arrays
    -> the same tree of tensors on ``device``. The reference's bf16 arrives
    as ``ml_dtypes.bfloat16``, which torch cannot read: it goes through
    float32 (exact) and is cast back to ``torch.bfloat16``. ``dtype``
    (default: keep each leaf's) casts every leaf."""
    dev = resolve_device(device)

    def conv(a):
        a = np.asarray(a)
        bf16 = a.dtype.name == "bfloat16"
        t = torch.from_numpy(np.array(a, dtype=np.float32 if bf16
                                      else a.dtype))
        want = dtype or (torch.bfloat16 if bf16 else t.dtype)
        return t.to(device=dev, dtype=want)

    def walk(node):
        return {k: walk(v) for k, v in node.items()} \
            if isinstance(node, dict) else conv(node)
    return walk(tree)


def model_params_to_numpy(params: dict) -> dict:
    """Tensors -> numpy, same tree; bf16 leaves come back as float32
    (exact)."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        t = node.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return walk(params)
