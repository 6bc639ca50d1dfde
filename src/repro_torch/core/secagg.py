"""Secure aggregation composed with DeFTA (port of ``repro.core.secagg``).

Two layers, as in the reference:

* **Legacy float masks** (``pair_seed``, ``mask_for``, ``mask_model``,
  ``unmask_model``, ``secure_roundtrip``): a symmetric N(0, 1) mask per
  unordered pair and round, added in float. The wire is not the model and
  the unmask is exact up to float addition.
* **One-time pads in the wire format's own integer ring**, which is what
  the engine runs (``gossip._mix_pytree_secagg``). The encoded payload is
  viewed as fixed-width unsigned words (fp32 -> 32 bits, bf16 -> 16,
  int8 -> 8; int8's fp32 row scales -> 32) and a uniform pad is added mod
  2^n. The wire word is then uniform and independent of the payload, and
  the receiver's subtraction recovers the encoded payload bit for bit, so
  the masked mix equals the unmasked gather-sum exactly.

Ring words are held as ``int64`` in [0, 2^n) for the 32- and 16-bit rings
(torch's unsigned dtypes support few operations; the arithmetic is done
in ``int64`` and reduced with a mask) and as ``uint8`` for the int8 ring,
whose addition wraps natively.

The pads come from Threefry-2x32 (20 rounds; Salmon et al., SC 2011),
written in plain torch on ``int64`` words under a 32-bit mask: it needs
only add, xor and rotate, so the same inputs give the same pads on the CPU
and on the card, with no Python loop over edges. The pads need not equal
the reference's ``jax.random.bits``; what both packages hold is "masked
equals unmasked". A pad word is keyed on (run base, domain, round, sender,
receiver, tag, word index):

    key     = domain_key(base, domain) with the round added to its
              second word (mod 2^32)
    counter = (sender << 16 | receiver, tag << 24 | word pair)

Each Threefry call yields two words, for words 2p and 2p + 1 of a
channel. Pads are DIRECTED: i -> j and j -> i have different counters, so
no pad is used twice in a round (a two-time pad would leak the payload
difference). ``tag`` separates the channels that share an edge: 2·li for
leaf li, 2·li + 1 for the int8 wire's scale of that leaf. ``pad_block``
draws every channel of a round in ONE Threefry evaluation (the tags are a
coordinate of the counter), so its ~170 elementwise launches are paid
once a round, not once a leaf. The round may be a 0-dim device tensor: it
is used in arithmetic only, never for indexing.

The group-sum construction (``pair_pad``, ``group_mask``, ``group_wire``,
``dropout_correction``) is the Bonawitz shape for an unweighted sum:
symmetric pair pads with antisymmetric signs cancel in the group sum, and
a dropped sender's pads are reconstructed and subtracted by the
survivors.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

M32 = 0xFFFFFFFF
RING_BITS = {None: 32, "fp32": 32, "bf16": 16, "int8": 8}

# pad-key domains: worker-edge pads, shard-block pads, cross-device
# cohort-slot pads (disjoint keys, so one (round, src, dst) triple never
# collides across transports)
DOMAIN_EDGE = 0x0e
DOMAIN_SHARD = 0x51
DOMAIN_COHORT = 0xc0

# counter fields: sender and receiver 16 bits each, tag 8, word pair 24
MAX_NODES = 1 << 16
_MAX_TAG, _MAX_PAIRS = 1 << 8, 1 << 24
_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA


def pair_seed(i: int, j: int, round_: int, salt: int = 0x5eca) -> int:
    a, b = (i, j) if i < j else (j, i)
    return (a * 1_000_003 + b * 7919 + round_ * 104_729 + salt) % (2**31)


def mask_for(shape_tree: dict, i: int, j: int, round_: int) -> dict:
    """Deterministic pairwise N(0, 1) mask dict (the same for both
    endpoints), drawn leaf by leaf in sorted-name order from a CPU
    generator seeded with ``pair_seed``, then moved to each leaf's
    device."""
    g = torch.Generator()
    g.manual_seed(pair_seed(i, j, round_))
    return {k: torch.randn(tuple(v.shape), generator=g,
                           dtype=v.dtype).to(v.device)
            for k, v in sorted(shape_tree.items())}


def mask_model(params: dict, sender: int, receiver: int,
               round_: int) -> dict:
    """What ``sender`` puts on the wire toward ``receiver``."""
    m = mask_for(params, sender, receiver, round_)
    return {k: v + m[k] for k, v in params.items()}


def unmask_model(wire: dict, sender: int, receiver: int,
                 round_: int) -> dict:
    """Receiver-side unmask (shared pair seed)."""
    m = mask_for(wire, sender, receiver, round_)
    return {k: v - m[k] for k, v in wire.items()}


def secure_roundtrip(params: dict, sender: int, receiver: int,
                     round_: int):
    """mask -> wire -> unmask; returns (wire, recovered)."""
    wire = mask_model(params, sender, receiver, round_)
    return wire, unmask_model(wire, sender, receiver, round_)


# ---------------------------------------------------------------------------
# The counter-based generator
# ---------------------------------------------------------------------------

def threefry2x32(k0, k1, c0, c1):
    """Threefry-2x32 with 20 rounds on 32-bit words held in Python ints or
    ``int64`` tensors (which broadcast): returns the two output words.
    Every intermediate stays below 2^63, so ``int64`` never overflows."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (c0 + ks[0]) & M32
    x1 = (c1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[4 * (i % 2):4 * (i % 2) + 4]:
            x0 = (x0 + x1) & M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def secagg_base_key(seed: int) -> int:
    """The pad root of a run, derived from ``cfg.seed`` alone by the
    reference's formula; it consumes nothing from the round's draws, so
    turning secagg on never moves another draw."""
    return (int(seed) * 2_654_435_761 + 0x5eca66) % (2**31)


def domain_key(base: int, domain: int) -> tuple:
    """The Threefry key of one pad domain under a run's base."""
    return threefry2x32(int(base) & M32, 0, int(domain), 0)


@functools.lru_cache(maxsize=64)
def _counters(channels: tuple, device: str):
    """The low counter words of a pad block (tag << 24 | word pair, channel
    after channel) and each channel's (first word, width) in the block.
    Made on the device by ``arange`` (no host copy, so no synchronisation)
    and kept: a round's channels repeat every round."""
    parts, spans, off = [], [], 0
    for tag, width in channels:
        pairs = (width + 1) // 2
        if not 0 <= tag < _MAX_TAG or pairs > _MAX_PAIRS:
            raise ValueError(f"secagg channel (tag {tag}, width {width}) "
                             f"outside the counter's fields")
        parts.append(torch.arange(pairs, dtype=torch.int64, device=device)
                     + (tag << 24))
        spans.append((2 * off, width))
        off += pairs
    return torch.cat(parts), tuple(spans)


def pad_block(dkey: tuple, round_, senders, receivers, channels) -> list:
    """Pads of every channel on every directed edge of a support, in one
    Threefry evaluation. ``senders`` and ``receivers`` are integer
    tensors (or ints) broadcasting to a common shape S, each below
    ``MAX_NODES``; ``channels`` is a sequence of (tag, width) with tags
    below 256.
    Returns one ``int64`` tensor of shape S + (width,) of 32-bit words per
    channel, in order (views of one block; reduce them to a ring with
    ``ring_pad``)."""
    senders = torch.as_tensor(senders)
    receivers = torch.as_tensor(receivers, device=senders.device)
    c1, spans = _counters(tuple((int(t), int(n)) for t, n in channels),
                          str(senders.device))
    c0 = ((senders.long() << 16) | receivers.long()).unsqueeze(-1)
    k0, k1 = dkey
    x0, x1 = threefry2x32(k0, (k1 + round_) & M32, c0, c1)
    words = torch.stack(torch.broadcast_tensors(x0, x1), dim=-1).flatten(-2)
    return [words[..., s:s + n] for s, n in spans]


def ring_pad(words, wire=None):
    """32-bit pad words reduced to the wire's ring representation."""
    if wire == "int8":
        return (words & 0xFF).to(torch.uint8)
    return words & ((1 << RING_BITS[wire]) - 1)


def edge_pads(dkey: tuple, round_, senders, receivers, width: int,
              wire=None, tag: int = 0):
    """Vectorized pads for a [*, K] support: senders and receivers
    broadcast to a common shape S; returns the ring's pads of shape
    S + (width,)."""
    return ring_pad(pad_block(dkey, round_, senders, receivers,
                              ((tag, width),))[0], wire)


def edge_pad(dkey: tuple, round_, sender: int, receiver: int, shape,
             wire=None, tag: int = 0, device=None):
    """One directed edge's pad of ``shape``, in the wire's ring."""
    if not (0 <= int(sender) < MAX_NODES and 0 <= int(receiver) < MAX_NODES):
        raise ValueError(f"secagg pads key nodes on 16 bits: edge "
                         f"{sender} -> {receiver}")
    width = int(np.prod(shape, dtype=np.int64))
    s = torch.tensor(int(sender), device=device)
    r = torch.tensor(int(receiver), device=device)
    return edge_pads(dkey, round_, s, r, width, wire, tag).reshape(
        tuple(shape))


def ring_bits(payload, wire=None):
    """An encoded wire payload as words of its ring: fp32 -> ``int64`` in
    [0, 2^32), bf16 -> ``int64`` in [0, 2^16), int8 -> ``uint8`` (two's
    complement)."""
    if wire in (None, "fp32"):
        return payload.float().view(torch.int32).long() & M32
    if wire == "bf16":
        return payload.view(torch.int16).long() & 0xFFFF
    return payload.view(torch.uint8)


def _narrow(bits, n: int, dtype):
    half = 1 << (n - 1)
    return (((bits + half) & ((1 << n) - 1)) - half).to(dtype)


def ring_payload(bits, wire=None):
    """Inverse of ``ring_bits``, exact for every word (NaN, inf, -0 and
    subnormals included)."""
    if wire in (None, "fp32"):
        return _narrow(bits, 32, torch.int32).view(torch.float32)
    if wire == "bf16":
        return _narrow(bits, 16, torch.int16).view(torch.bfloat16)
    return bits.view(torch.int8)


def _ring_add(a, b, wire):
    if wire == "int8":
        return a + b                               # uint8 wraps
    return (a + b) & ((1 << RING_BITS[wire]) - 1)


def _ring_sub(a, b, wire):
    if wire == "int8":
        return a - b
    return (a - b) & ((1 << RING_BITS[wire]) - 1)


def mask_payload(payload, pads, wire=None):
    """payload -> wire words: its ring words plus the pad, mod 2^n."""
    return _ring_add(ring_bits(payload, wire), pads, wire)


def unmask_payload(wire_bits, pads, wire=None):
    """wire words -> payload, bit for bit."""
    return ring_payload(_ring_sub(wire_bits, pads, wire), wire)


# ---------------------------------------------------------------------------
# Group-sum construction and dropout recovery
# ---------------------------------------------------------------------------

def _ring_zeros(shape, wire, device):
    dtype = torch.uint8 if wire == "int8" else torch.int64
    return torch.zeros(tuple(shape), dtype=dtype, device=device)


def pair_pad(dkey: tuple, round_, i: int, j: int, shape, wire=None,
             tag: int = 0, device=None):
    """Symmetric pair pad: keyed on the unordered pair, so both endpoints
    derive the same M_ij (the ± signs give the antisymmetry)."""
    a, b = (i, j) if int(i) < int(j) else (j, i)
    return edge_pad(dkey, round_, a, b, shape, wire, tag, device)


def group_mask(dkey: tuple, round_, i: int, group, shape, wire=None,
               tag: int = 0, device=None):
    """The net pad sender i adds in the group-sum construction:
    Σ_{j in group, j != i} ±M_ij, + when i < j."""
    net = _ring_zeros(shape, wire, device)
    for j in group:
        if int(j) == int(i):
            continue
        p = pair_pad(dkey, round_, i, j, shape, wire, tag, device)
        net = _ring_add(net, p, wire) if int(i) < int(j) \
            else _ring_sub(net, p, wire)
    return net


def group_wire(payload_row, dkey: tuple, round_, i: int, group, wire=None,
               tag: int = 0):
    """What sender i ships for an unweighted in-neighborhood sum."""
    bits = ring_bits(payload_row, wire)
    return _ring_add(bits, group_mask(dkey, round_, i, group, bits.shape,
                                      wire, tag, bits.device), wire)


def dropout_correction(dkey: tuple, round_, dropped: int, survivors, shape,
                       wire=None, tag: int = 0, device=None):
    """Σ_{i in survivors} ±M_i,d: the pads a dropped sender left
    uncancelled in the survivors' wire sum. Subtract it and the group sum
    over the survivors is exact again."""
    corr = _ring_zeros(shape, wire, device)
    for i in survivors:
        if int(i) == int(dropped):
            continue
        p = pair_pad(dkey, round_, i, dropped, shape, wire, tag, device)
        corr = _ring_add(corr, p, wire) if int(i) < int(dropped) \
            else _ring_sub(corr, p, wire)
    return corr


def secagg_mask_bytes(n_edges: int, n_params: int, wire=None,
                      *, rows: int = 1) -> int:
    """Pad bytes the PRG generates per round: one payload-sized pad per
    directed wire edge (int8 adds one uint32 pad per row for the scale).
    The WIRE bytes are unchanged — the OTP is in place, word for word —
    which is what the bench_guard mask-accounting gate pins."""
    per_edge = n_params * {None: 4, "fp32": 4, "bf16": 2, "int8": 1}[wire]
    if wire == "int8":
        per_edge += 4 * rows
    return int(n_edges) * per_edge
