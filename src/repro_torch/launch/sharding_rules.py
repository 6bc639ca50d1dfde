"""Logical-axis -> mesh-axis rules per architecture family and execution
mode (the port of ``repro.launch.sharding_rules``).

``base_rules`` is a verbatim copy (a test pins it source for source); the
dry run (``launch.dryrun``) reads its "batch" and "experts" entries. The
reference's ``zero1_axes``, ``sharding_tree`` and ``with_sharding``
resolve these rules into GSPMD shardings of arrays on a TPU mesh; the port
places no array by logical axes (tensor parallelism inside a pod, and the
mesh's model axis with it, is ROADMAP.md queue 1a item 12b), so they are
not ported.
"""
from __future__ import annotations


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
