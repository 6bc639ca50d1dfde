"""The pod axis of LM training across pods (``--fl``): per-pod parameter
trees on a list of pod devices.

The reference stacks every pod's parameters on a leading ``[npods, ...]``
axis sharded over a pod mesh. Here the pod axis is a Python list, one
nested dict of tensors a pod, pod ``p``'s on ``devices[p]`` (on one card
``["cuda:0"] * pods``; ``["cpu"] * pods`` in the tests), so the training
step runs pod by pod on the pod's device and the cross-pod ring copies
only real edges between pod devices. The round's stages that read across
pods (the mix's in-process backends, the attack zoo, the trust channels)
stack the rows onto the controller device, ``devices[0]``, as the
reference's collectives gather them.

The gossip mixes and the attack zoo take flat dicts of leaves keyed by
name and walk them in sorted order; ``flatten`` keys a nested tree by its
"/"-joined key paths, whose sorted order is the reference's
``jax.tree.leaves`` order (keys sorted at every level), so the int8
scales, the stochastic wire's uniforms and the secagg pad tags meet the
same leaf in both packages.
"""
from __future__ import annotations

import torch


def flatten(tree, prefix: str = "") -> dict:
    """A nested dict of tensors -> {"a/b/c": tensor}, in the reference's
    leaf order (the depth-first order of sorted keys), which is also the
    sorted order of the paths."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, path + "/"))
        else:
            out[path] = v
    if not prefix and list(out) != sorted(out):
        raise ValueError("parameter names sort differently from their "
                         "tree order (a key below '/'): "
                         f"{list(out)[:8]}")
    return out


def rebuild(like, flat: dict, prefix: str = "") -> dict:
    """``like``'s nested structure (empty sub-dicts included) with each
    leaf taken from ``flat`` by its path."""
    return {k: rebuild(v, flat, f"{prefix}{k}/") if isinstance(v, dict)
            else flat[f"{prefix}{k}"] for k, v in like.items()}


def stack(pod_flats: list, device) -> dict:
    """Per-pod flat dicts -> one flat dict of [npods, ...] tensors on
    ``device``."""
    return {k: torch.stack([f[k].to(device) for f in pod_flats])
            for k in pod_flats[0]}


def unstack(stacked: dict, devices) -> list:
    """A flat dict of [npods, ...] tensors -> per-pod flat dicts, pod p's
    on ``devices[p]``."""
    return [{k: v[p].to(devices[p]) for k, v in stacked.items()}
            for p in range(len(devices))]


def pod_vectors(pod_flats: list, device) -> torch.Tensor:
    """Per-pod flat dicts -> [npods, D] f32 on ``device``, each row the
    pod's leaves concatenated in sorted order (``dts.flatten_stacked`` of
    the stacked tree)."""
    return torch.stack([torch.cat([f[k].reshape(-1).float()
                                   for k in sorted(f)]).to(device)
                        for f in pod_flats])


def select(flag, a: list, b: list) -> list:
    """Per-pod select: ``a[p]`` where ``flag[p]`` else ``b[p]`` (flag a
    [npods] bool tensor; no host read)."""
    out = []
    for p, (x, y) in enumerate(zip(a, b)):
        f = flag[p]
        out.append({k: torch.where(f.to(y[k].device), x[k].to(y[k].dtype),
                                   y[k]) for k in y})
    return out


def copy_to(tree, device=None):
    """A fresh copy of a nested dict of tensors, on ``device`` (None: each
    leaf's own)."""
    return {k: copy_to(v, device) if isinstance(v, dict)
            else v.detach().clone().to(device) for k, v in tree.items()}


def replicate(tree, devices) -> list:
    """One tree copied onto every pod device (the reference's
    ``jnp.stack([x] * pods)``)."""
    return [copy_to(tree, d) for d in devices]
