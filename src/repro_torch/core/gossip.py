"""The gossip aggregation op ``out = P @ stacked_params``, leaf by leaf (the
port of ``repro.core.gossip``'s in-process transport).

Backends, as in the reference:

* ``einsum`` — plain ``P @ payload`` in PyTorch.
* ``pallas`` — the dense ``gossip_mix`` kernel (the name is the
  reference's; here it is the CUDA kernel of ``kernels.ops``).
* ``sparse`` — the padded-CSR ``gossip_mix_sparse`` kernel, or the fused
  int8 ``gossip_mix_quant`` kernel on the int8 wire. Needs the static
  ``adjacency``; the per-round P supplies the weights.
* ``auto``  — ``sparse`` when the adjacency (self-loops included) has
  density at most ``SPARSE_DENSITY_THRESHOLD``, else ``pallas``.

Wires: ``None`` (fp32), ``"bf16"`` or ``"int8"`` (one symmetric fp32 scale
per (worker, leaf) row, rounded to nearest or, with ``wire_round=
"stochastic"``, up with probability equal to the fraction, from uniforms
the caller draws through the ``rng`` seam). With a ``residual`` the encode
is EF21: each worker sends ``row + residual`` and keeps what the decode
lost for the next round. The mix stays leaf by leaf because the int8 scale
is per (worker, leaf) row: packing the leaves into one row would change
the numbers.

With ``secagg`` (a pad root, ``secagg.secagg_base_key``) the payload
crosses the wire one-time-padded per directed edge in the wire format's
integer ring and the receiver unmasks before the weighted sum
(``_mix_pytree_secagg``). As in the reference this is a gather-sum in
plain torch over the padded-CSR support, whatever the backend: no mix
kernel runs on a secagg round.

The cross-pod ring (``mix_pytree_ppermute``) runs one pod a device: each
offset of the reference's ring schedule copies only the real edges'
encoded rows between pod devices, and each receiver accumulates them in
fp32; it runs no gossip kernel, as in the reference.

The worker-axis-sharded transport (``WorkerShardPlan``,
``mix_rows_sharded``, ``mix_pytree_sharded``) splits the rows into one
block per shard: each shard's intra-shard edges run the padded-CSR
sparse or int8 kernel on its local block, and each used (src, dst) shard
pair ships the source's whole block once (a block-granular ring); under
secagg those block channels are one-time-padded.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch import counting
from repro_torch.core import secagg as sa
from repro_torch.kernels import ops

SPARSE_DENSITY_THRESHOLD = 0.25

_WIRE_ALIASES = {
    None: None, "fp32": None, "float32": None,
    "bf16": "bf16", "bfloat16": "bf16",
    "int8": "int8",
}


def normalize_wire(wire):
    """Canonicalize a wire-format name to None | "bf16" | "int8"."""
    key = wire
    if not isinstance(key, str) and key is not None:
        key = np.dtype(key).name                  # accept dtype-likes
    if key not in _WIRE_ALIASES:
        raise ValueError(f"unknown gossip wire format {wire!r} "
                         f"(expected one of {sorted(_WIRE_ALIASES, key=str)})")
    return _WIRE_ALIASES[key]


def uses_error_feedback(cfg) -> bool:
    """Whether a DeFTAConfig runs EF21 error feedback: a lossy wire format
    with feedback enabled."""
    return bool(cfg.gossip_error_feedback) \
        and normalize_wire(cfg.gossip_dtype) is not None


def quantize_rows_int8(flat, *, rounding: str = "nearest", u=None):
    """Per-row symmetric int8 quantization of a [W, F] stack. Returns
    (q [W, F] int8, scale [W] f32) with q = round(flat / scale) clipped to
    ±127 and scale = max|row| / 127 (never zero). ``torch.round`` rounds
    half to even, as ``jnp.round`` does, so q and scale are bit-equal to
    the reference's for equal fp32 input.

    ``rounding="stochastic"`` takes ``u``, [W, F] uniforms in [0, 1), and
    sets q = floor(s) + (u < s − floor(s)) for s = flat / scale: the
    encode is unbiased. Equal uniforms give the reference's q."""
    flat = flat.float()
    amax = flat.abs().amax(dim=1)
    scale = amax.clamp_min(1e-12) / 127.0
    scaled = flat / scale[:, None]
    if rounding == "stochastic":
        if u is None:
            raise ValueError("stochastic rounding needs uniforms (u=)")
        lo = torch.floor(scaled)
        q = lo + (u < (scaled - lo)).float()
    elif rounding == "nearest":
        q = torch.round(scaled)
    else:
        raise ValueError(f"unknown wire rounding {rounding!r} "
                         f"(expected 'nearest' | 'stochastic')")
    return q.clamp(-127, 127).to(torch.int8), scale


def dequantize_rows_int8(q, scale):
    """Inverse of ``quantize_rows_int8`` (fp32)."""
    return q.float() * scale.reshape(-1, 1)


@functools.lru_cache(maxsize=64)
def _support(shape, raw: bytes):
    a0 = np.frombuffer(raw, bool).reshape(shape)
    a = a0 | np.eye(shape[0], dtype=bool)
    w = a.shape[0]
    k = int(a.sum(axis=1).max())
    idx = np.tile(np.arange(w, dtype=np.int32)[:, None], (1, k))
    valid = np.zeros((w, k), bool)
    for i in range(w):
        peers = np.flatnonzero(a[i]).astype(np.int32)
        idx[i, :peers.size] = peers
        valid[i, :peers.size] = True
    idx.setflags(write=False)
    valid.setflags(write=False)
    return idx, valid


def sparse_support(adjacency) -> tuple[np.ndarray, np.ndarray]:
    """Padded-CSR support of a topology: ``adjacency[i, j]`` = i receives
    from j. Self-loops are always added. Returns (idx [W, K] int32, valid
    [W, K] bool) with K = max row degree; a padding slot repeats the row's
    own index and is masked by ``valid``. Memoized on the adjacency bytes —
    callers must not mutate the result."""
    a = np.ascontiguousarray(adjacency, bool)
    return _support(a.shape, a.tobytes())


@functools.lru_cache(maxsize=64)
def _support_tensors(shape, raw: bytes, device: str):
    idx, valid = _support(shape, raw)
    return (torch.tensor(idx, device=device),
            torch.tensor(valid, device=device))


def sparse_weights(P, adjacency):
    """Padded-CSR form of a mixing matrix P over a static topology: returns
    (idx [W, K] int32, val [W, K] f32) on P's device, with padding slots
    zero-weighted. The one place the padding convention lives."""
    a = np.ascontiguousarray(adjacency, bool)
    idx, valid = _support_tensors(a.shape, a.tobytes(), str(P.device))
    val = P.float().gather(1, idx.long()) * valid
    return idx, val


def dynamic_mixing_matrix(sampled, eff_adj, sizes, scheme: str = "defta"):
    """Per-epoch mixing matrix under a dynamic adjacency (scenario runs):
    the outdegrees of Theorem 3.3's |D_j|/d_j correction are recomputed
    from the epoch's effective topology.

    sampled: [W, W] bool, this round's sampled peers; eff_adj: [W, W]
    bool, the epoch's effective topology (adjacency ∧ link_ok ∧ alive on
    both ends); sizes: [W] f32. Returns row-stochastic P [W, W]; every row
    keeps its self-loop, so a dead or isolated worker's row is the
    identity. P's support lies in the static adjacency (or the scenario's
    support union) plus self-loops, so the sparse backend keeps one static
    padded-CSR support and masked entries ride as zero-weight slots."""
    w = eff_adj.shape[0]
    eye = torch.eye(w, dtype=torch.bool, device=eff_adj.device)
    return mixing_rows(sampled, eff_adj, eye, (eff_adj | eye).sum(dim=0),
                       sizes, scheme)


def mixing_rows(sampled, eff_adj, eye, outdeg, sizes, scheme: str = "defta"):
    """Rows of ``dynamic_mixing_matrix`` for a block of receivers:
    ``sampled``, ``eff_adj`` and ``eye`` are the block's [r, W] rows,
    ``outdeg`` [W] the outdegrees over EVERY receiver (the column sums of
    ``eff_adj | eye``), ``sizes`` [W]."""
    outdeg = outdeg.float()
    sizes = sizes.float()
    if scheme == "defta":
        col_w = sizes / outdeg
    elif scheme == "defl":
        col_w = sizes
    else:                                   # uniform gossip
        col_w = torch.ones_like(sizes)
    mask = (sampled & eff_adj) | eye
    P = mask * col_w[None, :]
    return P / P.sum(dim=1, keepdim=True).clamp_min(1e-12)


def _resolve_backend(backend, adjacency, w):
    if backend != "auto":
        return backend
    if adjacency is None:
        return "pallas"
    a = np.asarray(adjacency, bool) | np.eye(w, dtype=bool)
    return "sparse" if a.mean() <= SPARSE_DENSITY_THRESHOLD else "pallas"


def _encode_rows(flat, r_flat, wire, *, rounding: str = "nearest", u=None):
    """Encode one worker-stacked [W, F] leaf for the wire. Returns
    (payload, scale_or_None, new_residual_or_None): with ``r_flat`` (EF21)
    the encoded row is ``flat + r_flat`` and the residual is what the
    decode loses; without it the cast is fire-and-forget."""
    send = flat.float()
    if r_flat is not None:
        send = send + r_flat.float()
    if wire == "bf16":
        payload, scale = send.to(torch.bfloat16), None
        deq = payload.float()
    else:                                         # int8
        payload, scale = quantize_rows_int8(send, rounding=rounding, u=u)
        deq = dequantize_rows_int8(payload, scale)
    new_r = (send - deq) if r_flat is not None else None
    return payload, scale, new_r


def mix_pytree(P, stacked: dict, backend: str = "einsum", *, adjacency=None,
               wire=None, residual=None, wire_round: str = "nearest",
               wire_u=None, secagg=None, secagg_round=None):
    """P: [W, W] row-stochastic f32; stacked: dict of [W, ...] leaves.

    ``adjacency``: static bool [W, W] numpy support of P (required by the
    ``sparse`` backend, enables it under ``auto``). ``wire``: None | "bf16"
    | "int8". ``residual``: EF21 buffers (dict like ``stacked``); when
    given the return value is ``(mixed, new_residual)``. ``wire_round=
    "stochastic"`` (int8 only) takes ``wire_u``, one [W, F] U[0, 1) tensor
    per leaf name (``rng.RoundDraws.wire_u``). ``secagg``: the pad root
    (``secagg.secagg_base_key``); the masked gather mix needs
    ``adjacency`` and keys its pads on ``secagg_round`` (an int or a 0-dim
    tensor; 0 when None).
    """
    w = P.shape[0]
    backend = _resolve_backend(backend, adjacency, w)
    wire = normalize_wire(wire)
    if residual is not None and wire is None:
        raise ValueError("error-feedback residual needs a lossy wire "
                         "(wire='bf16'|'int8')")
    if wire_round == "stochastic" and wire != "int8":
        raise ValueError("wire_round='stochastic' is an int8-wire option "
                         f"(wire={wire!r})")
    if secagg is not None:
        if adjacency is None:
            raise ValueError(
                "secagg needs the static topology: pass "
                "adjacency=<bool [W, W]> (the pads are per wire edge)")
        return _mix_pytree_secagg(
            P, stacked, adjacency, wire=wire, residual=residual,
            wire_round=wire_round, wire_u=wire_u, base=secagg,
            round_=secagg_round)
    if backend not in ("einsum", "pallas", "sparse"):
        raise ValueError(f"unknown gossip backend {backend!r}")
    if backend == "sparse":
        if adjacency is None:
            raise ValueError(
                "gossip backend 'sparse' needs the static topology: pass "
                "adjacency=<bool [W, W]> (or use backend='pallas')")
        idx, val = sparse_weights(P, adjacency)
    Pf = P.float()

    def mix_flat(payload, scale):
        """[W, F] mixed rows in fp32 (dequant fused, no fp32 stack)."""
        if backend == "sparse":
            if scale is not None:
                return ops.gossip_mix_quant(idx, val, scale, payload)
            return ops.gossip_mix_sparse(idx, val, payload)
        Pw = Pf * scale[None, :] if scale is not None else Pf
        if backend == "einsum":
            return Pw @ payload.float()
        return ops.gossip_mix(Pw.contiguous(), payload)

    mixed, new_res = {}, {}
    for name in sorted(stacked):
        x = stacked[name]
        flat = x.reshape(w, -1)
        if wire is None:
            out = mix_flat(flat, None)
        else:
            r = residual[name] if residual is not None else None
            r_flat = r.reshape(w, -1) if r is not None else None
            u = wire_u[name] if wire_u is not None else None
            payload, scale, nr = _encode_rows(flat, r_flat, wire,
                                              rounding=wire_round, u=u)
            out = mix_flat(payload.contiguous(), scale)
            if nr is not None:
                new_res[name] = nr.reshape(x.shape)
        mixed[name] = out.reshape(x.shape).to(x.dtype)
    if residual is not None:
        return mixed, new_res
    return mixed


def _mix_pytree_secagg(P, stacked, adjacency, *, wire, residual,
                       wire_round, wire_u, base, round_):
    """Receiver-side pairwise-masked gather mix (ref
    ``gossip._mix_pytree_secagg``). Each receiver gathers the encoded
    payload rows of its padded-CSR support; a gathered row models the
    wire, ``ring(q_j) + pad(round, j -> i)`` in the wire's integer ring,
    and the receiver subtracts the same directed-edge pad before the
    weighted sum over the K slots. The pad is exact word for word, so the
    recovered rows equal the encoded rows bit for bit and the masked mix
    equals the same gather-sum without masks (at int8 within the plain
    quantization error, EF21 residuals equal). A dead or unsampled edge
    rides P's zero weight: its recovered row is annihilated.

    The pads of every leaf (tag 2·li) and of every int8 scale channel
    (tag 2·li + 1) come from one ``secagg.pad_block`` call a round."""
    w = P.shape[0]
    round_ = 0 if round_ is None else round_
    idx, val = sparse_weights(P, adjacency)
    idx = idx.long()
    k = idx.shape[1]
    if w > sa.MAX_NODES:
        raise ValueError(f"secagg pads key workers on 16 bits: W = {w}")
    names = sorted(stacked)
    enc, channels = [], []
    for li, name in enumerate(names):
        flat = stacked[name].reshape(w, -1)
        if wire is None:
            payload, scale, nr = flat.float(), None, None
        else:
            r = residual[name] if residual is not None else None
            r_flat = r.reshape(w, -1) if r is not None else None
            u = wire_u[name] if wire_u is not None else None
            payload, scale, nr = _encode_rows(flat, r_flat, wire,
                                              rounding=wire_round, u=u)
        enc.append((payload, scale, nr))
        channels.append((2 * li, payload.shape[1]))
        if scale is not None:
            channels.append((2 * li + 1, 1))
    recv = torch.arange(w, device=P.device)[:, None]
    pads = iter(sa.pad_block(sa.domain_key(base, sa.DOMAIN_EDGE), round_,
                             idx, recv, channels))
    flat_idx = idx.reshape(-1)
    mixed, new_res = {}, {}
    for name, (payload, scale, nr) in zip(names, enc):
        x = stacked[name]
        pad = sa.ring_pad(next(pads), wire)
        gathered = payload.index_select(0, flat_idx).reshape(w, k, -1)
        rec = sa.unmask_payload(sa.mask_payload(gathered, pad, wire), pad,
                                wire)                       # == gathered
        if scale is not None:
            spad = sa.ring_pad(next(pads)[..., 0])
            s_g = scale.index_select(0, flat_idx).reshape(w, k)
            s_rec = sa.unmask_payload(sa.mask_payload(s_g, spad), spad)
            weights = val * s_rec                 # dequant into the weights
        else:
            weights = val
        out = torch.einsum("wk,wkf->wf", weights, rec.float())
        mixed[name] = out.reshape(x.shape).to(x.dtype)
        if nr is not None:
            new_res[name] = nr.reshape(x.shape)
    if residual is not None:
        return mixed, new_res
    return mixed


# ---------------------------------------------------------------------------
# The cross-pod ring and the worker-axis-sharded transport
# ---------------------------------------------------------------------------

# bytes and blocks the ring transports moved between devices: every payload
# row (cross-pod ring) or block (sharded transport) and int8 scale they
# copied from one pod or shard to another
RING = {"bytes": 0, "blocks": 0}


def ring_schedule(adjacency, w: int):
    """The cross-pod ring's static schedule (ref ``mix_pytree_ppermute``):
    ``used_offsets``, the circular offsets o at which some pod i receives
    from i - o (offset 0 is the pod itself), and ``offset_perm[o]``, the
    (src, dst) pairs of offset o with a real edge ``adjacency[dst, src]``.
    Without an adjacency every offset and every pair is used (the
    reference's dense fallback)."""
    if adjacency is None:
        used = list(range(w))
        return used, {o: [(j, (j + o) % w) for j in range(w)] for o in used}
    a = np.asarray(adjacency, bool) | np.eye(w, dtype=bool)
    used = [o for o in range(w)
            if np.any(a[np.arange(w), (np.arange(w) - o) % w])]
    return used, {o: [(j, (j + o) % w) for j in range(w)
                      if a[(j + o) % w, j]] for o in used}


def _edge_pads(base, round_, src: int, dst: int, enc_row, wire, device):
    """The one-time pads of the directed edge src -> dst on ``device``, per
    leaf li: the payload's (tag 2·li, the wire's ring) and, on the int8
    wire, its scale's (tag 2·li + 1, 32-bit ring), from one
    ``secagg.pad_block`` call."""
    channels = []
    for li, (q, s_, _) in enumerate(enc_row):
        channels.append((2 * li, q.numel()))
        if s_ is not None:
            channels.append((2 * li + 1, 1))
    words = iter(sa.pad_block(sa.domain_key(base, sa.DOMAIN_EDGE), round_,
                              torch.tensor(src, device=device),
                              torch.tensor(dst, device=device), channels))
    return [(sa.ring_pad(next(words), wire),
             sa.ring_pad(next(words)) if s_ is not None else None)
            for _, s_, _ in enc_row]


def mix_pytree_ppermute(P, pod_rows: list, devices, *, adjacency=None,
                        wire=None, residual=None, secagg=None,
                        secagg_round=None):
    """The cross-pod gossip ring (ref ``mix_pytree_ppermute``), one pod a
    device: ``pod_rows[i]`` is pod i's dict of leaves (no pod axis) on
    ``devices[i]``, P the [W, W] mixing matrix. Returns the mixed per-pod
    dicts, or ``(mixed, new_residual)`` with an EF21 ``residual`` (a list
    of per-pod dicts).

    The schedule is the reference's (``ring_schedule``): offset o carries
    the edges i - o -> i, an offset no pod uses is skipped, and at each
    offset only the real edges of the static ``adjacency`` are copied from
    the source pod's device to the receiver's (``RING`` counts the bytes;
    the reference's unnamed destinations receive zeros, which P's zero
    weight annihilates). Each pod encodes its rows for the wire on its own
    device, outside the ring (row-local, rounded to nearest; the EF21
    residual stays there too); the int8 payload travels with its per-row
    scale, which the receiver folds into its P weight. Each receiver
    accumulates weight · row in fp32, offset by offset in the reference's
    order. No gossip kernel runs.

    ``secagg`` (a pad root, ``secagg.secagg_base_key``): the sender masks
    each payload and scale with the pad of its directed edge (tags 2·li
    and 2·li + 1, keyed on ``secagg_round``) before the copy, and the
    receiver derives the same pad and unmasks after it; only real edges
    are accumulated (the reference gates its zero-filled slots by the
    static edge mask)."""
    w = P.shape[0]
    wire = normalize_wire(wire)
    if residual is not None and wire is None:
        raise ValueError("error-feedback residual needs a lossy wire "
                         "(wire='bf16'|'int8')")
    if len(pod_rows) != w or len(devices) != w:
        raise ValueError(f"the ring runs one pod a device: P is [{w}, {w}], "
                         f"got {len(pod_rows)} pods on {len(devices)} "
                         f"devices")
    used, perm = ring_schedule(adjacency, w)
    round_ = 0 if secagg_round is None else secagg_round
    names = sorted(pod_rows[0])

    # encode row-local on each pod's device (no cross-pod traffic)
    enc = []                                  # [pod][leaf] (q, s, new_r)
    for i, rows in enumerate(pod_rows):
        enc.append([])
        for name in names:
            x = rows[name]
            flat = x.reshape(1, -1)
            if wire is None:
                enc[i].append((flat, None, None))
                continue
            r = residual[i][name].reshape(1, -1) if residual is not None \
                else None
            q, s_, nr = _encode_rows(flat, r, wire)
            enc[i].append((q, s_, nr.reshape(x.shape) if nr is not None
                           else None))

    # the ring: what each receiver holds at each offset
    held = [{0: enc[i]} for i in range(w)]
    for o in used:
        for src, dst in (perm[o] if o else ()):
            if secagg is not None:
                p_out = _edge_pads(secagg, round_, src, dst, enc[src], wire,
                                   devices[src])
                p_in = p_out if devices[src] == devices[dst] else \
                    _edge_pads(secagg, round_, src, dst, enc[src], wire,
                               devices[dst])
            got = []
            for li, (q, s_, _) in enumerate(enc[src]):
                nbytes = q.numel() * q.element_size() + \
                    (4 * s_.numel() if s_ is not None else 0)
                RING["bytes"] += nbytes
                RING["blocks"] += 1
                counting.collective("collective-permute", nbytes, pod=src,
                                    across_pods=True)
                if secagg is None:
                    got.append((q.to(devices[dst]), None if s_ is None
                                else s_.to(devices[dst]), None))
                    continue
                (po, so), (pi, si) = p_out[li], p_in[li]
                qw = sa.mask_payload(q.reshape(-1), po, wire).to(devices[dst])
                qq = sa.unmask_payload(qw, pi, wire).reshape(q.shape)
                ss = None
                if s_ is not None:
                    sw = sa.mask_payload(s_, so).to(devices[dst])
                    ss = sa.unmask_payload(sw, si)
                got.append((qq, ss, None))
            held[dst][o] = got

    mixed = []
    for i in range(w):
        p_row = P[i].float().to(devices[i])
        out = {}
        for li, name in enumerate(names):
            acc = torch.zeros_like(enc[i][li][0], dtype=torch.float32)
            for o in used:
                if o not in held[i]:
                    continue
                q, s_, _ = held[i][o][li]
                weight = p_row[(i - o) % w]
                if s_ is not None:
                    weight = weight * s_[0]
                acc = torch.addcmul(acc, weight, q.float())
            x = pod_rows[i][name]
            out[name] = acc.reshape(x.shape).to(x.dtype)
        mixed.append(out)
    if residual is not None:
        return mixed, [{name: e[2] for name, e in zip(names, row)}
                       for row in enc]
    return mixed


def reset_ring() -> None:
    RING["bytes"] = RING["blocks"] = 0


class WorkerShardPlan:
    """The static schedule of one sharded gossip round (the reference's,
    numpy only, field for field).

    The W worker rows are padded to ``wp = shards × block`` and split into
    per-shard blocks of ``block`` consecutive workers. The adjacency
    support then splits into:

    * the DIAGONAL blocks — intra-shard edges, compiled to one padded-CSR
      support per shard (``idx``/``valid`` [S, B, K], local coordinates,
      K = the max local row degree across shards) so the
      ``gossip_mix_sparse``/``gossip_mix_quant`` kernels run unchanged on
      the local block;
    * the OFF-DIAGONAL blocks — cross-shard edges, compiled to a
      block-granular ring: shard-offset ``d`` is used iff some shard
      receives from the shard ``d`` ring positions behind it, and its
      permutation names only the (src, dst) shard pairs with at least one
      real edge. A shard therefore ships its whole block once per
      DISTINCT destination shard — ring bytes scale with the number of
      used shard PAIRS × block, not with W².

    Padded worker rows get a self-loop only (weight supplied by the
    identity padding of P), so the schedule never depends on W being
    divisible by the shard count.
    """

    def __init__(self, adjacency, shards: int):
        a0 = np.asarray(adjacency, bool)
        w = a0.shape[0]
        s = int(shards)
        b = -(-w // s)                       # ceil(w / shards)
        wp = s * b
        a = np.zeros((wp, wp), bool)
        a[:w, :w] = a0
        np.fill_diagonal(a, True)            # self-loops (incl. padding)

        # diagonal blocks -> per-shard padded-CSR support, local coords
        k = 1
        for si in range(s):
            blk = a[si * b:(si + 1) * b, si * b:(si + 1) * b]
            k = max(k, int(blk.sum(axis=1).max()))
        idx = np.tile(np.arange(b, dtype=np.int32)[None, :, None],
                      (s, 1, k))
        valid = np.zeros((s, b, k), bool)
        for si in range(s):
            blk = a[si * b:(si + 1) * b, si * b:(si + 1) * b]
            for i in range(b):
                peers = np.flatnonzero(blk[i]).astype(np.int32)
                idx[si, i, :peers.size] = peers
                valid[si, i, :peers.size] = True

        # off-diagonal blocks -> block-granular ring schedule
        pairs = []
        for src in range(s):
            for dst in range(s):
                if src == dst:
                    continue
                if a[dst * b:(dst + 1) * b, src * b:(src + 1) * b].any():
                    pairs.append((src, dst))
        perms = {}
        for src, dst in pairs:
            perms.setdefault((dst - src) % s, []).append((src, dst))

        at = a0 | np.eye(w, dtype=bool)      # true-W support, self-loops in
        intra = 0
        for si in range(s):
            intra += int(at[si * b:min((si + 1) * b, w),
                            si * b:min((si + 1) * b, w)].sum())

        idx.setflags(write=False)
        valid.setflags(write=False)
        self.w, self.shards, self.block, self.wp = w, s, b, wp
        self.idx, self.valid = idx, valid
        self.pairs = tuple(pairs)
        self.used_offsets = tuple(sorted(perms))
        self.perms = {d: tuple(p) for d, p in perms.items()}
        self.intra_edges = intra
        self.cross_edges = int(at.sum()) - intra
        # the sources each shard receives a block from, in the order the
        # transport adds them (used offsets ascending)
        self.sources = tuple(
            tuple((si - d) % s for d in self.used_offsets
                  if ((si - d) % s, si) in self.perms[d])
            for si in range(s))

    def ring_bytes(self, n_params: int, wire=None, *, rows: int = 1) -> int:
        """Cross-shard wire bytes of ONE sharded round: every used shard
        pair ships one block of ``block`` worker payloads (int8 payloads
        carry their per-row scales). This is the contract
        ``launch.roofline.sharded_ring_bytes`` must reproduce."""
        from repro_torch.launch.roofline import gossip_wire_bytes
        payload = gossip_wire_bytes(n_params, wire, rows=rows)
        return len(self.pairs) * self.block * payload


_PLAN_CACHE: dict = {}
_PLAN_CACHE_MAX = 16


def worker_shard_plan(adjacency, shards: int) -> WorkerShardPlan:
    """Memoized ``WorkerShardPlan`` (a 16-entry LRU, as the reference's)."""
    a = np.asarray(adjacency, bool)
    key = (a.shape, a.tobytes(), int(shards))
    cached = _PLAN_CACHE.get(key)
    if cached is not None:
        _PLAN_CACHE[key] = _PLAN_CACHE.pop(key)
        return cached
    while len(_PLAN_CACHE) >= _PLAN_CACHE_MAX:
        _PLAN_CACHE.pop(next(iter(_PLAN_CACHE)))
    plan = WorkerShardPlan(a, shards)
    _PLAN_CACHE[key] = plan
    return plan


@functools.lru_cache(maxsize=64)
def _plan_tensors(plan: WorkerShardPlan, device: str):
    """A plan's local-block supports on one device: idx [S, B, K] int32
    and valid [S, B, K] f32."""
    return (torch.tensor(plan.idx, device=device),
            torch.tensor(plan.valid, dtype=torch.float32, device=device))


def _pad_mixing(P, wp: int):
    """P [W, W] -> [wp, wp] f32 with identity rows (and columns) for the
    padding workers, so every padded row is row-stochastic."""
    w = P.shape[0]
    Pp = torch.zeros((wp, wp), dtype=torch.float32, device=P.device)
    Pp[:w, :w] = P.float()
    pad = torch.arange(w, wp, device=P.device)
    Pp[pad, pad] = 1.0
    return Pp


def _shard_pads(plan, base, round_, src: int, dst: int, widths, wire,
                device):
    """The one-time pads of the (src shard -> dst shard) block channel on
    ``device``: per leaf li the payload pad (tag 2·li, in the wire's ring)
    and, on the int8 wire, the scale pad (tag 2·li + 1, 32-bit ring)."""
    channels = []
    for li, width in enumerate(widths):
        channels.append((2 * li, width))
        if wire == "int8":
            channels.append((2 * li + 1, plan.block))
    words = iter(sa.pad_block(sa.domain_key(base, sa.DOMAIN_SHARD), round_,
                              torch.tensor(src, device=device),
                              torch.tensor(dst, device=device), channels))
    out = []
    for _ in widths:
        pay = sa.ring_pad(next(words), wire)
        out.append((pay, sa.ring_pad(next(words)) if wire == "int8"
                    else None))
    return out


def mix_rows_sharded(P_rows, stacked_rows, shards, *, adjacency=None,
                     wire=None, residual_rows=None, secagg=None,
                     secagg_round=None, plan=None):
    """The sharded mix over row blocks (the transport of a sharded round).

    ``P_rows``: a list of [r, W] row blocks of P, one per placement block
    (``WorkerShards.bounds``); ``stacked_rows``: the matching list of dicts
    of [r, ...] leaves (and ``residual_rows`` their EF21 residuals);
    ``shards``: the ``sharding.WorkerShards``. With one block per shard the
    blocks are the shards' blocks; with a single block (W not divisible by
    the shard count) its rows are padded to ``shards × block`` and split
    onto the shard devices. Returns ``(mixed_rows, new_residual_rows)``
    (the latter None without a residual), block for block.

    The order of operations is the reference's ``mix_pytree_sharded``:
    encode row-local at true W (nearest rounding); pad payload rows with
    zeros and int8 scales with 1.0, P with identity rows; each shard's
    accumulator starts from the local-block kernel
    (``ops.gossip_mix_sparse`` / ``ops.gossip_mix_quant`` on
    ``val = P_diag[idx] · valid``), then, offset by used offset, the source
    shard's block is copied to the receiver's device and ``blk @ q_src``
    added, the int8 scales folded into the columns of the P sub-block.
    A (src, dst) pair with no real edge ships nothing (the reference's
    ring delivers zeros there and gates them to a zero term).

    ``secagg`` (a pad root, ``secagg.secagg_base_key``): each used (src,
    dst) block channel is masked by a one-time pad of
    ``secagg.domain_key(base, DOMAIN_SHARD)`` keyed on (round, src, dst,
    tag) before the block leaves its shard's device, and unmasked after
    it arrives; the intra-shard diagonal is not masked (the privacy
    boundary is the device, as in the reference).

    ``plan``: the adjacency's ``WorkerShardPlan`` when the caller holds
    it (the transport builds it once: the memo's key is the adjacency's
    bytes, 100 MB at W = 10,000); else it is looked up."""
    wire = normalize_wire(wire)
    if residual_rows is not None and wire is None:
        raise ValueError("error-feedback residual needs a lossy wire "
                         "(wire='bf16'|'int8')")
    w = sum(int(p.shape[0]) for p in P_rows)
    if adjacency is None:                    # documented dense fallback
        adjacency = np.ones((w, w), bool)
    devs = shards.devices
    s_n = shards.shards
    if plan is None:
        plan = worker_shard_plan(adjacency, s_n)
    b = plan.block
    names = sorted(stacked_rows[0])
    round_ = 0 if secagg_round is None else secagg_round

    # encode at true W, row-local (the numerics of the other transports)
    enc = []                                 # [block][leaf] (q, s, new_r)
    for bi, rows in enumerate(stacked_rows):
        enc.append([])
        for name in names:
            x = rows[name]
            flat = x.reshape(x.shape[0], -1)
            if wire is None:
                enc[-1].append((flat, None, None))
                continue
            r = residual_rows[bi][name] if residual_rows is not None \
                else None
            payload, scale, nr = _encode_rows(
                flat, r.reshape(r.shape[0], -1) if r is not None else None,
                wire)
            enc[-1].append((payload, scale,
                            nr.reshape(x.shape) if nr is not None else None))

    direct = len(P_rows) == s_n
    if direct:                               # one placement block a shard
        Ps = [p.float() for p in P_rows]
        qs = [[e[0].contiguous() for e in blk] for blk in enc]
        ss = [[e[1] for e in blk] for blk in enc]
    else:                                    # one block: pad, then split
        Pp = _pad_mixing(P_rows[0], plan.wp)
        Ps = [Pp[si * b:(si + 1) * b].to(devs[si]) for si in range(s_n)]
        qs = [[] for _ in range(s_n)]
        ss = [[] for _ in range(s_n)]
        for q, s_, _ in enc[0]:
            qp = torch.nn.functional.pad(q, (0, 0, 0, plan.wp - w))
            sp = None if s_ is None else torch.nn.functional.pad(
                s_, (0, plan.wp - w), value=1.0)
            for si in range(s_n):
                qs[si].append(qp[si * b:(si + 1) * b].to(devs[si])
                              .contiguous())
                ss[si].append(None if sp is None else
                              sp[si * b:(si + 1) * b].to(devs[si]))
    widths = [b * q.shape[1] for q in qs[0]]

    def ship(src, dst):
        """The source shard's blocks as they arrive on dst's device, per
        leaf (q, s): copied, and masked and unmasked under secagg."""
        out = []
        if secagg is not None:
            pads_out = _shard_pads(plan, secagg, round_, src, dst, widths,
                                   wire, devs[src])
            pads_in = pads_out if devs[src] == devs[dst] else _shard_pads(
                plan, secagg, round_, src, dst, widths, wire, devs[dst])
        for li, (q, s_) in enumerate(zip(qs[src], ss[src])):
            nbytes = q.numel() * q.element_size() + \
                (4 * s_.numel() if s_ is not None else 0)
            RING["bytes"] += nbytes
            RING["blocks"] += 1
            counting.collective("collective-permute", nbytes, device=src)
            if secagg is None:
                out.append((q.to(devs[dst]),
                            None if s_ is None else s_.to(devs[dst])))
                continue
            (po, so), (pi, si_) = pads_out[li], pads_in[li]
            qw = sa.mask_payload(q.reshape(-1), po, wire).to(devs[dst])
            qq = sa.unmask_payload(qw, pi, wire).reshape(q.shape)
            sq = None
            if s_ is not None:
                sw = sa.mask_payload(s_, so).to(devs[dst])
                sq = sa.unmask_payload(sw, si_)
            out.append((qq, sq))
        return out

    outs = []
    for si in range(s_n):
        dev = devs[si]
        idx_all, valid_all = _plan_tensors(plan, str(dev))
        idx_l, valid_l = idx_all[si], valid_all[si]
        p_diag = Ps[si][:, si * b:(si + 1) * b]
        val = (p_diag.gather(1, idx_l.long()) * valid_l).contiguous()
        acc = []
        for q, s_ in zip(qs[si], ss[si]):
            acc.append(ops.gossip_mix_quant(idx_l, val, s_, q)
                       if s_ is not None
                       else ops.gossip_mix_sparse(idx_l, val, q))
        for src in plan.sources[si]:
            blk = Ps[si][:, src * b:(src + 1) * b]
            for li, (qq, sq) in enumerate(ship(src, si)):
                blk_l = blk * sq[None, :] if sq is not None else blk
                acc[li] = acc[li] + blk_l @ qq.float()
        outs.append(acc)

    if direct:
        mixed = [{name: o.reshape(rows[name].shape).to(rows[name].dtype)
                  for name, o in zip(names, out)}
                 for out, rows in zip(outs, stacked_rows)]
    else:
        rows = stacked_rows[0]
        mixed = [{name: torch.cat([outs[si][li].to(devs[0])
                                   for si in range(s_n)])[:w]
                  .reshape(rows[name].shape).to(rows[name].dtype)
                  for li, name in enumerate(names)}]
    new_res = None
    if residual_rows is not None:
        new_res = [{name: e[2] for name, e in zip(names, blk)}
                   for blk in enc]
    return mixed, new_res


def mix_pytree_sharded(P, stacked: dict, shards, *, adjacency=None,
                       wire=None, residual=None, secagg=None,
                       secagg_round=None, plan=None):
    """Worker-axis-sharded gossip on whole [W, ...] tensors (the
    reference's ``mix_pytree_sharded`` contract): P [W, W] row-stochastic
    with support ⊆ adjacency ∪ self-loops, ``stacked`` a dict of [W, ...]
    leaves, ``shards`` a ``sharding.WorkerShards``; the rows are padded to
    ``shards × block`` and split onto the shard devices
    (``mix_rows_sharded``), and the result comes back whole on P's
    device. Returns the mixed dict, or ``(mixed, new_residual)`` with an
    EF21 ``residual``."""
    mixed, new_res = mix_rows_sharded(
        [P], [stacked], shards, adjacency=adjacency, wire=wire,
        residual_rows=None if residual is None else [residual],
        secagg=secagg, secagg_round=secagg_round, plan=plan)
    if residual is not None:
        return mixed[0], new_res[0]
    return mixed[0]
