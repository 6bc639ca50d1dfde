"""Roofline accounting on the H100 (the port of ``repro.launch.roofline``).

Three terms per (arch x shape x mesh), per step, each a device's share:

    compute    = flops      / PEAK_FLOPS   (bf16 tensor cores, dense)
    memory     = bytes      / HBM_BW
    collective = coll bytes / ICI_BW       (NVLink inside a node)
               + the bytes that cross pods / DCN_BW   (between nodes)

The reference reads flops and bytes from XLA's ``cost_analysis()`` and
parses collective bytes from HLO text; the port never produces HLO, so
``shape_bytes`` and ``collective_bytes`` are not ported (as ``compat.py``,
a JAX version shim, is not). Its counts come from a counting pass on
torch's ``meta`` device instead (``repro_torch.counting``), and
``analyze`` takes them as ``coll_override`` (and, in ``dcn_override``,
the part of them that crosses pods: a pod is one node).

Also here: the gossip wire's byte contracts and the privacy wire's budget
(seven names copied from the reference; a test pins them source for
source), and the bounds of the port's kernels (``bound``,
``flash_bound``, ``router_bound``, ``route_slots_bound`` and
``ssd_bound``: the bound columns of ``chip_smoke.py`` and PERF.md's
kernel table, built from ``kernels.cost``, the costs the counting pass
records). ``WIRE_BYTES`` is the gossip wire's bytes per parameter
(``core.gossip``'s table with the config spellings, as in the reference).
``sharded_ring_bytes`` is the independent re-derivation that
``core.gossip.WorkerShardPlan.ring_bytes`` and the sharded transport's
byte counter (``gossip.RING``) are held to; ``ppermute_ring_bytes`` the
one the cross-pod ring's (``core.gossip.mix_pytree_ppermute``) is.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Dict

from repro_torch.core.gossip import WIRE_BYTES as _WIRE_BYTES
from repro_torch.kernels import cost

# NVIDIA H100 80GB HBM3 (SXM5, 700 W) data sheet; each time this module
# reports is a prediction for that card at that power limit
PEAK_FLOPS = 989e12          # bf16 FLOP/s, tensor cores, dense
HBM_BW = 3.35e12             # bytes/s, HBM3
ICI_BW = 450e9               # bytes/s a direction, NVLink 4, inside a node
DCN_BW = 50e9                # bytes/s a GPU across nodes (NDR 400 Gb/s)
BF16_FLOPS = PEAK_FLOPS
TF32_FLOPS = 495e12          # TF32 tensor cores, dense
FP32_FLOPS = 67e12           # fp32 outside the tensor cores
CARD = "NVIDIA H100 80GB HBM3, 700 W"

WIRE_BYTES = {**_WIRE_BYTES, "float32": 4, "bfloat16": 2}


def gossip_wire_bytes(n_params: int, wire=None, *, rows: int = 1) -> int:
    """Bytes of ONE serialized model payload under a gossip wire format:
    payload + the fp32 per-row quantization scales int8 ships alongside
    (``rows`` = number of quantization rows, one per worker×leaf)."""
    b = n_params * WIRE_BYTES[wire]
    if WIRE_BYTES[wire] == 1:
        b += 4 * rows
    return b


def gossip_round_wire_bytes(n_params: int, w: int, out_degree: float,
                            wire=None, *, rows: int = 1) -> float:
    """Cluster-total gossip wire bytes for one DeFTA round: every worker
    ships its payload to ``out_degree`` outbound peers. The sparse-topology
    economy (bytes ∝ nnz edges = w·out_degree, not w²) and the wire-format
    economy (1/2/4 B per param) compose."""
    return w * out_degree * gossip_wire_bytes(n_params, wire, rows=rows)


def ppermute_ring_bytes(n_params: int, adjacency, wire=None, *,
                        rows: int = 1):
    """Cluster-total wire bytes of ONE ``mix_pytree_ppermute`` round over
    a static topology, as ``(nnz_bytes, dense_rotation_bytes)``:

    * ``nnz_bytes`` — with the padded-CSR nnz row selection fused into the
      ring schedule (each offset's ppermute names only real edges), a pod
      ships one payload per out-edge: total = nnz(adjacency) × payload —
      the algorithmic wire contract of ``gossip_round_wire_bytes``.
    * ``dense_rotation_bytes`` — the pre-selection schedule (every used
      offset rotates every pod's whole local stack): |used offsets| × W ×
      payload. The ratio is the row-selection win.
    """
    import numpy as np
    a = np.asarray(adjacency, bool).copy()
    np.fill_diagonal(a, False)              # offset 0 never crosses a link
    w = a.shape[0]
    payload = gossip_wire_bytes(n_params, wire, rows=rows)
    used = [o for o in range(1, w)
            if np.any(a[np.arange(w), (np.arange(w) - o) % w])]
    return int(a.sum()) * payload, len(used) * w * payload


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


# ---------------------------------------------------------------------------
# The port's kernels' bounds (their costs: ``kernels.cost``)
# ---------------------------------------------------------------------------

def _bound(t_bytes: float, t_ops: float):
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops \
        else "operations"


_RATE = {"fp32": FP32_FLOPS, "tf32": TF32_FLOPS, "bf16": BF16_FLOPS}


def bound(name, w, k_nnz, k_slots, f, in_bytes, tensor_cores=False):
    """(bound_ms, bound_by) of a gossip mix: bytes over the card's memory
    rate vs the operations over their peak rate, each input read once and
    the output written once. The operations are fp32 FMAs on the CUDA
    cores, or, for the dense mix's tile regime (``tensor_cores``), its TF32
    products on the tensor cores: three per product for an f32 payload,
    two for bf16 and int8."""
    kw = dict(w=w, f=f, in_bytes=in_bytes)
    if name == "gossip_mix":
        kw["tensor_cores"] = tensor_cores
    else:
        kw.update(k=k_slots, nnz=k_nnz)
    pipes, nbytes = cost.pipes(name, **kw)
    (pipe, ops), = pipes.items()
    return _bound(nbytes / HBM_BW, ops / _RATE[pipe])


def flash_bound(b, h, s, d, itemsize, causal=True, sk=None):
    """(bound_ms, bound_by): q and out [B, H, S, D], k and v [B, H, Sk, D]
    (Sk = S unless given) read or written once, against 4*D flops per
    visible (q, k) pair at the bf16 tensor-core peak (bf16 inputs) or the
    fp32 CUDA-core peak."""
    pipes, nbytes = cost.pipes("flash_attention", b=b, h=h, s=s, d=d,
                           itemsize=itemsize, causal=causal, sk=sk)
    (pipe, ops), = pipes.items()
    return _bound(nbytes / HBM_BW, ops / _RATE[pipe])


def router_bound(t, e, k, itemsize):
    """Logits read once, gates and indices written once, against the
    softmax's 3 and the k rounds' k fp32 operations per logit."""
    pipes, nbytes = cost.pipes("moe_router", t=t, e=e, k=k, itemsize=itemsize)
    return _bound(nbytes / HBM_BW, pipes["fp32"] / FP32_FLOPS)


def route_slots_bound(t, e, k, cap, itemsize):
    """Logits read once; gates, indices, slots and the inverse map written
    once; against ``router_bound``'s operations."""
    pipes, nbytes = cost.pipes("moe_route_slots", t=t, e=e, k=k, cap=cap,
                           itemsize=itemsize)
    return _bound(nbytes / HBM_BW, pipes["fp32"] / FP32_FLOPS)


def ssd_bound(g, h, t, n, p):
    """(bound_ms, bound_by, cuda_core_ms) of the SSD intra-chunk term for a
    kernel on the tensor cores: C, B, acum, dt, x read and y written once
    (fp32) over the memory rate, against the operations: the products (2N
    flops per causal (q, k) pair for the scores, 2P per pair and head for
    w . x), three TF32 products each in 3xTF32, at the TF32 tensor-core
    rate, and the exponent and the two scalings (4 per pair and head) at
    the fp32 CUDA-core rate; the two pipes run side by side, so the larger
    of the two. ``cuda_core_ms`` is the earlier yardstick, every operation
    (2N per pair, 2P + 4 per pair and head) at the fp32 CUDA-core rate,
    which a kernel on the CUDA cores cannot beat but one on the tensor
    cores can."""
    pipes, nbytes = cost.pipes("ssd_chunk_tc", g=g, h=h, t=t, n=n, p=p)
    t_bytes = nbytes / HBM_BW
    t_ops = max(pipes["tf32"] / TF32_FLOPS, pipes["fp32"] / FP32_FLOPS)
    cuda_core = max(t_bytes, (pipes["products"] + pipes["fp32"])
                    / FP32_FLOPS)
    ms, by = _bound(t_bytes, t_ops)
    return ms, by, cuda_core * 1e3


# ---------------------------------------------------------------------------
# The step roofline (the reference's Roofline, analyze and
# model_flops_estimate)
# ---------------------------------------------------------------------------

@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_gflops_total: float          # cluster-total (counted, not HLO)
    hlo_gbytes_total: float
    collective_gbytes_per_chip: float
    collective_breakdown: Dict[str, float]
    t_compute: float                 # seconds
    t_memory: float
    t_collective: float
    bottleneck: str
    model_gflops: float              # 6·N·D (or 2·N·D serving)
    useful_ratio: float              # model_flops / counted flops
    bytes_per_device: float          # counted peak live bytes a device

    def to_dict(self):
        return asdict(self)


def collective_seconds(coll: Dict[str, float],
                       dcn: Dict[str, float] = None) -> float:
    """A device's collective time: the bytes of ``coll`` (by kind) that
    stay inside a pod over NVLink (``ICI_BW``), the part ``dcn`` (by kind)
    that crosses pods over the link between nodes (``DCN_BW``)."""
    total = float(sum(coll.values()))
    across = float(sum((dcn or {}).values()))
    return (total - across) / ICI_BW + across / DCN_BW


def analyze(arch, shape, mesh_name, chips, cost, hlo_text, model_flops,
            peak_bytes, coll_override=None, *, dcn_override=None):
    """The reference's ``analyze`` with the H100's constants. ``cost``:
    {"flops", "bytes accessed"} of one device (``repro_torch.counting``);
    ``coll_override``: the counted collective bytes of one device by kind,
    ``dcn_override`` the part of them that crosses pods (priced at
    ``DCN_BW``, the rest at ``ICI_BW``: ``collective_seconds``). The port
    has no HLO: a non-empty ``hlo_text`` raises, and ``coll_override`` is
    required."""
    if hlo_text:
        raise ValueError("analyze: the port produces no HLO; pass the "
                         "counted collectives as coll_override")
    if coll_override is None:
        raise ValueError("analyze: coll_override is required (the port "
                         "does not parse HLO)")
    flops_dev = float(cost.get("flops", 0.0))
    bytes_dev = float(cost.get("bytes accessed", 0.0))
    flops_total = flops_dev * chips
    bytes_total = bytes_dev * chips
    coll = coll_override
    coll_dev = float(sum(coll.values()))

    t_comp = flops_total / (chips * PEAK_FLOPS)
    t_mem = bytes_total / (chips * HBM_BW)
    t_coll = collective_seconds(coll, dcn_override)
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    bottleneck = max(terms, key=terms.get)
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_gflops_total=flops_total / 1e9,
        hlo_gbytes_total=bytes_total / 1e9,
        collective_gbytes_per_chip=coll_dev / 1e9,
        collective_breakdown={k: v / 1e9 for k, v in coll.items()},
        t_compute=t_comp, t_memory=t_mem, t_collective=t_coll,
        bottleneck=bottleneck,
        model_gflops=model_flops / 1e9,
        useful_ratio=(model_flops / flops_total) if flops_total else 0.0,
        bytes_per_device=peak_bytes,
    )


def model_flops_estimate(cfg, shape) -> float:
    """6·N·D for training, 2·N·D for prefill, 2·N_active·B for decode
    (N_active = top-k expert params for MoE; attention cache reads are
    captured by the memory term, not counted as useful FLOPs here)."""
    n_active = cfg.param_count(active_only=True)
    if shape.mode == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.mode == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch   # decode: one token
