"""Logical-axis -> mesh-axis rules per architecture family and execution
mode, and helpers to resolve whole param / cache / input sharding trees
(the port of ``repro.launch.sharding_rules``).

``base_rules`` is a verbatim copy (a test pins it source for source).
Notes on the fallback chain: ``sharding.resolve_spec`` demotes any dim
whose size is not divisible by its mesh axes, and skips mesh axes already
used by an earlier dim. Listing both ``kv_heads -> model`` and ``head_dim
-> model`` therefore gives GQA models with few kv heads an automatic
fallback to head-dim sharding (granite-20b's one kv head at any model
axis; whisper's 6 heads at 4). ``sharding_tree`` resolves a tree of
logical-axis tuples into ``sharding.NamedSharding``s, ``with_sharding``
places a tree of (meta) tensors by them (``sharding.Placed``),
``zero1_axes`` rewrites optimizer-state axes for ZeRO-1.
"""
from __future__ import annotations

from repro_torch import sharding
from repro_torch.sharding import logical_rules, resolve_spec


def _is_axes(v) -> bool:
    return isinstance(v, tuple) and all(isinstance(x, (str, type(None)))
                                        for x in v)


def map_axes(fn, axes_tree, *trees):
    """``fn(axes, *leaves)`` at every logical-axes tuple of ``axes_tree``
    (dicts of tuples), with the matching leaves of ``trees``."""
    if _is_axes(axes_tree):
        return fn(axes_tree, *trees)
    return {k: map_axes(fn, v, *(t[k] for t in trees))
            for k, v in axes_tree.items()}


def base_rules(multi_pod: bool, *, variant: str = "baseline") -> dict:
    batch = ("pod", "data") if multi_pod else ("data",)
    rules = {
        # activations
        "batch": batch,
        "act_seq": "model",        # Megatron-SP style sequence sharding
        "seq": None,
        # params
        "vocab": "model",
        "embed": None,
        "mlp": "model",
        "heads": "model",
        "kv_heads": "model",
        "head_dim": "model",       # fallback when kv_heads indivisible
        "experts": "data",         # expert parallelism
        "experts_r": None,
        "expert_mlp": "model",
        "d_inner": "model",
        "layers": None,            # scan axis stays unsharded
        "worker": "pod",           # FL worker stacking (multi-pod)
    }
    if "no_seqshard" in variant:
        rules["act_seq"] = None
    if "expert_model" in variant:
        rules["experts"] = "model"
        rules["expert_mlp"] = None
    if "pure_dp" in variant:
        # beyond-paper lever for small archs: tensor parallelism at TP=16
        # drowns a <1B model in collectives; run 256-way pure data parallel
        # instead (batch over BOTH mesh axes, params fully replicated).
        for k in ("vocab", "mlp", "heads", "kv_heads", "head_dim",
                  "d_inner", "expert_mlp"):
            rules[k] = None
        rules["batch"] = batch + ("model",)
        rules["act_seq"] = None
    # ZeRO-1: optimizer moments sharded over the data axis on their first
    # replicated dim (hillclimb lever for the memory term).
    rules["zero"] = "data" if "zero1" in variant else None
    return rules


def zero1_axes(axes_tree, sds_tree, rules):
    """Rewrite opt-state axes: the first dim that resolves to NO mesh axis
    under ``rules`` (and is divisible by the zero axis) becomes 'zero'
    (ZeRO-1 optimizer-state sharding)."""
    def unresolved(name):
        return name is None or rules.get(name) is None

    def one(a, s):
        a = list(a)
        for i, name in enumerate(a):
            if unresolved(name) and s.shape[i] > 1:
                a[i] = "zero"
                break
        return tuple(a)
    return map_axes(one, axes_tree, sds_tree)


def sharding_tree(mesh, rules, axes_tree, shape_tree):
    """Resolve a tree of logical-axis tuples into ``NamedSharding``s,
    demoting indivisible dims (shape-aware)."""
    def one(axes, sds):
        with logical_rules(mesh, rules):
            spec = resolve_spec(axes, tuple(sds.shape))
        return sharding.NamedSharding(mesh, spec if spec is not None
                                      else ())
    return map_axes(one, axes_tree, shape_tree)


def with_sharding(sds_tree, shard_tree):
    """Attach shardings to a tree of (meta) tensors: each leaf placed by
    its ``NamedSharding`` (``sharding.place``)."""
    if isinstance(sds_tree, dict):
        return {k: with_sharding(v, shard_tree[k])
                for k, v in sds_tree.items()}
    return sharding.place(sds_tree, shard_tree.spec, shard_tree.mesh)
