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
"""
from __future__ import annotations

import functools

import numpy as np
import torch

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
    outdeg = (eff_adj | eye).sum(dim=0).float()
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
