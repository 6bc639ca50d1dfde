"""The reference's public names that the port does not carry, each with the
one line that says what takes its place here, or why nothing does.

Every other public name of a ``repro`` module (re-exports included, the six
Pallas kernel files and ``compat`` aside) resolves in the ``repro_torch``
module of the same path, so that code written against ``repro`` can change
its imports. ``tests/test_torch_api_parity.py`` holds the two packages to
that, and holds each entry here to a name that the reference has and the
port lacks. ROADMAP's "Not to port" lists the same entries.
"""
from __future__ import annotations

_CONSTRAIN = ("a JAX sharding constraint on an activation; the port places "
              "tensors explicitly (sharding.place, TensorParallel's Act)")
_PALLAS = ("the Pallas TPU entry; the wrapper of the same name without "
           "_pallas launches the port's CUDA kernel")

# "module.name" (the path under ``repro`` / ``repro_torch``) -> reason
NOT_PORTED = {
    "core.engine.constrain_worker_rows":
        "a JAX sharding constraint on the worker rows; the port's round "
        "takes the rows as explicit blocks (sharding.WorkerShards)",
    "core.engine.split_round_keys":
        "splits a JAX PRNG key into the round's keys; the port's rounds "
        "draw through an rng.Draws provider (rng.TorchDraws)",
    "core.secagg.RING_DTYPE":
        "the jnp unsigned dtypes of the pad ring; the port keeps ring "
        "words in int64 / uint8 masked to secagg.RING_BITS",
    "core.secagg.edge_pad_key":
        "a JAX PRNG key per directed edge; the port's pads come from its "
        "own Threefry-2x32 counters (secagg.edge_pad, pad_block)",
    "kernels.ops.flash_attention_pallas": _PALLAS,
    "kernels.ops.gossip_mix_pallas": _PALLAS,
    "kernels.ops.gossip_mix_quant_pallas": _PALLAS,
    "kernels.ops.gossip_mix_sparse_pallas": _PALLAS,
    "kernels.ops.moe_router_pallas": _PALLAS,
    "kernels.ops.ssd_chunk_pallas": _PALLAS,
    "models.attention.constrain": _CONSTRAIN,
    "models.blocks.constrain": _CONSTRAIN,
    "models.layers.constrain": _CONSTRAIN,
    "models.model.constrain": _CONSTRAIN,
    "models.moe.constrain": _CONSTRAIN,
    "models.ssm.constrain": _CONSTRAIN,
    "models.moe_eplocal.shard_map":
        "JAX's shard_map; the port runs each device's block in a loop "
        "inside counting.device (moe_eplocal's per-device work)",
    "sharding.worker_mesh":
        "a 1-D JAX Mesh of the worker axis; sharding.worker_shards gives "
        "the port's WorkerShards over cards or ['cpu'] * S",
}
