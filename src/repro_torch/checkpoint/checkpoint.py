"""Tree checkpointing in the reference's on-disk layout (port of
``repro.checkpoint.checkpoint``): ``<dir>/step_<n>/manifest.json`` +
``arrays.npz``, so a checkpoint either package saves loads in the other.

The manifest lists the flattened key paths ("/"-joined dict keys, sorted
at every level, and list indices: the reference's ``jax.tree`` order),
dtypes and shapes; array ``a<i>`` holds the i-th leaf. The reference
writes bf16 through ``ml_dtypes``, whose arrays ``np.savez`` stores as raw
16-bit words (``<V2``) under the manifest dtype ``bfloat16``; this module
reads and writes bf16 as those raw words, so it needs no ``ml_dtypes``,
and its files are the reference's byte for byte.
"""
from __future__ import annotations

import json
import os
import zipfile
from typing import Any

import numpy as np
import torch


def _flatten_with_paths(tree):
    """(key paths, leaves) of nested dicts and lists; None and empty
    containers hold no leaf."""
    keys, vals = [], []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + [str(k)])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + [str(i)])
        elif node is not None:
            keys.append("/".join(path))
            vals.append(node)
    walk(tree, [])
    return keys, vals


def _unflatten_like(like, leaves):
    """``like``'s structure with its leaves replaced, in order."""
    it = iter(leaves)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return None if node is None else next(it)
    return walk(like)


def _to_numpy(v):
    """A leaf -> (numpy array, manifest dtype name); bf16 as its raw
    16-bit words."""
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(v)
    return a, str(a.dtype)


def _savez(file: str, stored) -> None:
    """``np.savez`` of the (array, dtype name) pairs as ``a<i>``, with a
    bf16 array's header naming it ``<V2``, as ``np.savez`` names an
    ``ml_dtypes.bfloat16`` array."""
    with zipfile.ZipFile(file, "w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for i, (a, dtype) in enumerate(stored):
            with zf.open(f"a{i}.npy", "w", force_zip64=True) as f:
                if dtype != "bfloat16":
                    np.lib.format.write_array(f, np.asanyarray(a),
                                              allow_pickle=False)
                    continue
                np.lib.format.write_array_header_1_0(
                    f, {"descr": "<V2", "fortran_order": False,
                        "shape": tuple(a.shape)})
                f.write(np.ascontiguousarray(a).tobytes())


def _from_numpy(a, dtype: str, like):
    """A stored array -> a tensor on ``like``'s device (a numpy array when
    ``like`` is not a tensor)."""
    if dtype == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()
                             ).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    if isinstance(like, torch.Tensor):
        return t.to(like.device)
    return t.numpy() if dtype != "bfloat16" else t


def save_checkpoint(path: str, tree: Any, step: int) -> str:
    d = os.path.join(path, f"step_{step:08d}")
    os.makedirs(d, exist_ok=True)
    keys, vals = _flatten_with_paths(tree)
    stored = [_to_numpy(v) for v in vals]
    _savez(os.path.join(d, "arrays.npz"), stored)
    manifest = {
        "step": step,
        "keys": keys,
        "dtypes": [dt for _, dt in stored],
        "shapes": [list(a.shape) for a, _ in stored],
    }
    with open(os.path.join(d, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    return d


def latest_step(path: str):
    if not os.path.isdir(path):
        return None
    steps = [int(n.split("_")[1]) for n in os.listdir(path)
             if n.startswith("step_")]
    return max(steps) if steps else None


def load_checkpoint(path: str, like: Any, step: int | None = None):
    """Restore into the structure of ``like`` (a template tree; each leaf
    lands on its template tensor's device). Returns (tree, step)."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    d = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(d, "arrays.npz"))
    keys, vals = _flatten_with_paths(like)
    if keys != manifest["keys"]:
        raise ValueError("checkpoint structure mismatch: "
                         f"{set(manifest['keys']) ^ set(keys)}")
    restored = [_from_numpy(data[f"a{i}"], manifest["dtypes"][i], v)
                for i, v in enumerate(vals)]
    return _unflatten_like(like, restored), manifest["step"]
