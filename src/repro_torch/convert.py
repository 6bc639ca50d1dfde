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
arrays, ``opt`` None or ``{"m": ..., "v": ...}``; so does its
``CrossDeviceState``, with the sketch ring buffer's stamps
(``sketch_round``) and the participation counters. Its ``PodState``
arrives with its stacked ``[npods, ...]`` trees split into the port's
per-pod trees, one on each pod device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import (CrossDeviceState, DeFTAState,
                                     FedAvgState, PodState)
from repro_torch.device import resolve_device, to_numpy, to_torch

STATE_FIELDS = ("params", "backup", "conf", "best_loss", "last_loss",
                "epoch", "wire_err", "sketch")
CROSS_DEVICE_FIELDS = ("params", "backup", "conf", "best_loss",
                       "last_loss", "epoch", "last_part", "obs", "wire_err",
                       "sketch", "sketch_round")


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


def cross_device_state_from_jax(fields: dict,
                                device=None) -> CrossDeviceState:
    """The reference's ``CrossDeviceState`` fields as numpy (a dict keyed by
    field name; its ``key`` is not read) -> the port's
    ``CrossDeviceState``."""
    dev = resolve_device(device)
    return CrossDeviceState(**{f: to_torch(fields.get(f), dev)
                               for f in CROSS_DEVICE_FIELDS})


def cross_device_state_to_numpy(state: CrossDeviceState) -> dict:
    """The inverse of ``cross_device_state_from_jax``."""
    return {f: to_numpy(getattr(state, f)) for f in CROSS_DEVICE_FIELDS}


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


def _stacked_to_pods(tree, devices):
    """A stacked [npods, ...] numpy tree -> one tree of tensors a pod."""
    if tree is None:
        return None
    return [model_params_from_jax(
        _index_tree(tree, p), device=d) for p, d in enumerate(devices)]


def _index_tree(tree, p):
    return {k: _index_tree(v, p) if isinstance(v, dict) else np.asarray(v)[p]
            for k, v in tree.items()}


def _pods_to_stacked(trees):
    if trees is None:
        return None
    pods = [model_params_to_numpy(t) for t in trees]

    def walk(nodes):
        if isinstance(nodes[0], dict):
            return {k: walk([n[k] for n in nodes]) for k in nodes[0]}
        return np.stack(nodes)
    return walk(pods)


def pod_state_from_jax(fields: dict, devices) -> PodState:
    """The reference's ``PodState`` fields as numpy (a dict keyed by field
    name; its ``key`` is not read) -> the port's ``PodState``: the
    [npods, ...] fields on ``devices[0]`` (the controller), ``wire_err``
    and ``backup`` split into per-pod trees, pod p's on ``devices[p]``."""
    dev = resolve_device(devices[0])
    devs = [resolve_device(d) for d in devices]
    opt = lambda x: None if x is None else to_torch(np.asarray(x), dev)
    return PodState(conf=opt(fields["conf"]),
                    last_loss=opt(fields["last_loss"]),
                    round=int(np.asarray(fields["round"])),
                    wire_err=_stacked_to_pods(fields.get("wire_err"), devs),
                    backup=_stacked_to_pods(fields.get("backup"), devs),
                    best_loss=opt(fields.get("best_loss")),
                    sketch=opt(fields.get("sketch")))


def pod_state_to_numpy(state: PodState) -> dict:
    """The inverse of ``pod_state_from_jax``: the per-pod trees stacked
    back on a leading pod axis, ``round`` an int32 scalar."""
    return {"conf": to_numpy(state.conf),
            "last_loss": to_numpy(state.last_loss),
            "round": np.int32(state.round),
            "wire_err": _pods_to_stacked(state.wire_err),
            "backup": _pods_to_stacked(state.backup),
            "best_loss": to_numpy(state.best_loss),
            "sketch": to_numpy(state.sketch)}
