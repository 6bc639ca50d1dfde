"""The privacy wire's byte and budget contracts (the port's copy of three
names of ``repro.launch.roofline``; a test pins them source for source).

The rest of the reference module costs a TPU mesh from compiled HLO and
is not ported. ``WIRE_BYTES`` is the gossip wire's bytes per parameter
(the reference's ``core.gossip.WIRE_BYTES`` plus the config spellings).
"""
from __future__ import annotations

from typing import Dict

WIRE_BYTES = {None: 4, "fp32": 4, "bf16": 2, "int8": 1,
              "float32": 4, "bfloat16": 2}


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
