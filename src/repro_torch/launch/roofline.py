"""The gossip wire's byte contracts and the privacy wire's budget (the
port's copy of five names of ``repro.launch.roofline``; a test pins the
functions source for source).

The rest of the reference module costs a TPU mesh from compiled HLO and
is not ported. ``WIRE_BYTES`` is the gossip wire's bytes per parameter
(the reference's ``core.gossip.WIRE_BYTES`` plus the config spellings).
``sharded_ring_bytes`` is the independent re-derivation that
``core.gossip.WorkerShardPlan.ring_bytes`` and the sharded transport's
byte counter (``gossip.RING``) are held to.
"""
from __future__ import annotations

from typing import Dict

WIRE_BYTES = {None: 4, "fp32": 4, "bf16": 2, "int8": 1,
              "float32": 4, "bfloat16": 2}


def gossip_wire_bytes(n_params: int, wire=None, *, rows: int = 1) -> int:
    """Bytes of ONE serialized model payload under a gossip wire format:
    payload + the fp32 per-row quantization scales int8 ships alongside
    (``rows`` = number of quantization rows, one per worker×leaf)."""
    b = n_params * WIRE_BYTES[wire]
    if WIRE_BYTES[wire] == 1:
        b += 4 * rows
    return b


def sharded_ring_bytes(n_params: int, adjacency, shards: int, wire=None, *,
                       rows: int = 1) -> Dict[str, float]:
    """Cross-shard wire contract of ONE worker-axis-sharded gossip round
    (``core.gossip.mix_pytree_sharded`` — the independent re-derivation
    ``WorkerShardPlan.ring_bytes`` is tested against).

    The W×W support pads to ``shards × block`` and splits at shard-block
    granularity: DIAGONAL blocks stay on-device (``intra_edges``, priced
    at zero wire bytes), OFF-DIAGONAL blocks ride a block-granular
    ppermute ring where a (src, dst) shard pair is on the schedule iff its
    block has ≥ 1 real edge — and then ships the WHOLE src block once
    (``bytes_per_boundary`` = block × payload). Total ring bytes scale
    with used shard pairs × block, not with the cross-edge count: dense
    cross-shard coupling amortizes, a single stray edge costs a full
    boundary.
    """
    import numpy as np
    a0 = np.asarray(adjacency, bool)
    w = a0.shape[0]
    s = int(shards)
    b = -(-w // s)                            # ceil(w / shards)
    wp = s * b
    a = np.zeros((wp, wp), bool)
    a[:w, :w] = a0
    np.fill_diagonal(a, True)
    pairs = sum(1 for src in range(s) for dst in range(s)
                if src != dst and
                a[dst * b:(dst + 1) * b, src * b:(src + 1) * b].any())
    at = a0 | np.eye(w, dtype=bool)           # true-W support, self-loops
    intra = sum(int(at[si * b:min((si + 1) * b, w),
                       si * b:min((si + 1) * b, w)].sum())
                for si in range(s))
    payload = gossip_wire_bytes(n_params, wire, rows=rows)
    boundary = b * payload
    return {
        "shards": s,
        "block": b,
        "intra_edges": intra,
        "cross_edges": int(at.sum()) - intra,
        "used_pairs": pairs,
        "bytes_per_boundary": float(boundary),
        "ring_bytes": float(pairs * boundary),
    }



def secagg_pad_bytes(adjacency, n_params: int, wire=None, *,
                     rows: int = 1) -> Dict[str, float]:
    """Privacy-wire roofline of ONE secure-aggregation gossip round.

    The OTP masks ride IN PLACE in the wire format's integer ring
    (``core.secagg``): the wire bytes of a masked round equal the
    plaintext round exactly — privacy costs pad GENERATION, not
    bandwidth. Per directed edge the PRG emits one payload-sized pad
    (int8 adds one uint32 pad per quantization row for the scale
    channel), so ``pad_bytes = nnz(adjacency) × payload``. This is the
    independent re-derivation the bench's mask-accounting gate checks
    ``core.secagg.secagg_mask_bytes`` against.
    """
    import numpy as np
    a = np.asarray(adjacency, bool).copy()
    np.fill_diagonal(a, False)          # self-loop never crosses the wire
    edges = int(a.sum())
    per_edge = n_params * WIRE_BYTES[wire]
    if WIRE_BYTES[wire] == 1:
        per_edge += 4 * rows
    return {
        "directed_edges": edges,
        "pad_bytes_per_edge": float(per_edge),
        "pad_bytes": float(edges * per_edge),
        "wire_overhead_bytes": 0.0,     # in-place OTP: wire unchanged
    }


def dp_epsilon(sigma: float, rounds: int, *, delta: float = 1e-5) -> float:
    """Naive per-round Gaussian-mechanism accountant: each round of the
    clipped-update noise stage (sensitivity = the L2 clip, noise
    N(0,(σ·clip)²)) is (ε₀, δ)-DP with ε₀ = √(2 ln(1.25/δ))/σ, and T
    rounds basic-compose to ε = T·ε₀. Deliberately the LOOSE bound — no
    moments accountant, no subsampling amplification — so the costing
    column is an upper bound a reader can check by hand."""
    import math
    if sigma <= 0:
        return float("inf")
    return rounds * math.sqrt(2.0 * math.log(1.25 / delta)) / sigma
