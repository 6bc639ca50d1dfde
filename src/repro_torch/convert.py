"""Weights and state carried across from the reference.

The reference's parameters are dicts of worker-stacked arrays with the
same names and layouts as the port's (``core.tasks``), so carrying them is
a dtype-preserving copy. The reference's ``DeFTAState`` fields arrive as
numpy arrays (``{field: np.asarray(...)}``); its PRNG ``key`` has no
counterpart here (the port's randomness comes from an ``rng.Draws``
provider) and its DTS v3 ``sketch`` is a later item of the port.
"""
from __future__ import annotations

from repro_torch.core.engine import DeFTAState
from repro_torch.device import resolve_device, to_numpy, to_torch

STATE_FIELDS = ("params", "backup", "conf", "best_loss", "last_loss",
                "epoch", "wire_err")


def params_from_jax(tree, device=None) -> dict:
    """A dict of reference parameter arrays (numpy) -> dict of tensors."""
    return to_torch(dict(tree), resolve_device(device))


def params_to_numpy(params: dict) -> dict:
    """The inverse of ``params_from_jax``."""
    return to_numpy(params)


def state_from_jax(fields: dict, device=None) -> DeFTAState:
    """The reference's ``DeFTAState`` fields as numpy (a dict keyed by
    field name) -> the port's ``DeFTAState``."""
    if fields.get("sketch") is not None:
        raise NotImplementedError("the DTS v3 sketch state is not ported "
                                  "yet (ROADMAP.md, queue 1, item 9)")
    dev = resolve_device(device)
    return DeFTAState(**{f: to_torch(fields.get(f), dev)
                         for f in STATE_FIELDS})


def state_to_numpy(state: DeFTAState) -> dict:
    """The port's state -> ``{field: numpy tree}`` (the inverse of
    ``state_from_jax``, without the reference's key)."""
    return {f: to_numpy(getattr(state, f)) for f in STATE_FIELDS}
