"""The fused route-and-slot op (``repro_torch.kernels.ops.moe_route_slots``)
on the CPU: its plain version against a live JAX run of the reference's
own formulation (``repro.models.moe.router_probs``, ``jax.lax.top_k``, then
the one-hot ``cumsum`` rank of ``repro/models/moe.py:95-100``); an
emulation of the CUDA kernel's decomposition (32-row tiles, per-tile
expert bitmasks, decoupled look-back over tiles) against the ``cumsum``
rank, with mutants it must reject; and the wrapper's card-side branch
with the launch stubbed.

Logits come from numpy with a seed; the JAX side reads them through a
router of the identity (an exact product), so both sides route the same
fp32 logits. Indices, ranks, keep, slots and the inverse map are
integers and must be equal; gates within atol 1e-6 (the fp32 softmax
summed in another order).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe

from repro_torch.kernels import ops, ref
from repro_torch.models.moe import grouped_capacity

EK = [(64, 6), (16, 2), (384, 8)]       # DeepSeekMoE, Jamba, Kimi K2
TS = [1, 96, 1000, 4096]
KINDS = ["normal", "ties", "skewed"]


def logits_of(kind, t, e, seed):
    """[T, E] fp32 logits: normal draws; ``ties``: every third row has half
    the experts at 6.0 (an exact tie across the top) and every third row
    from the second on rounded (ties inside the top-k); ``skewed``: expert
    3 raised by 4 on 80 % of the rows, so it overflows any capacity of
    the grouped dispatch."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(t, e)).astype(np.float32)
    if kind == "ties":
        x[::3, : e // 2] = 6.0
        x[1::3] = np.round(x[1::3])
    elif kind == "skewed":
        x[rng.random(t) < 0.8, 3] += 4.0
    return x


def jax_route(x, k, cap):
    """The reference's routing and slots: router_probs (here through an
    identity router) and jax.lax.top_k as moe_grouped calls them
    (repro/models/moe.py:88-90), then its rank, keep and slot
    (:95-100)."""
    e = x.shape[1]
    probs, logits = jmoe.router_probs({"router": jnp.eye(e)}, jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(logits), x)
    gate_vals, gate_idx = jax.lax.top_k(probs, k)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdims=True) + 1e-9)
    flat_e = gate_idx.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, e, dtype=jnp.int32)
    rank = jnp.cumsum(onehot, axis=0) - 1
    rank = jnp.take_along_axis(rank, flat_e[:, None], axis=1)[:, 0]
    keep = rank < cap
    slot = jnp.where(keep, rank, cap)
    return tuple(np.asarray(a) for a in (gate_vals, gate_idx, rank, keep,
                                         slot))


def src_of(idx, slot, e, cap):
    """The inverse map that (idx, slot) imply: the token of each kept
    pair at e*cap + slot, T elsewhere."""
    t, k = idx.shape
    src = np.full(e * cap, t, np.int64)
    tok = np.repeat(np.arange(t), k)
    kept = slot.reshape(-1) < cap
    src[idx.reshape(-1)[kept] * cap + slot.reshape(-1)[kept]] = tok[kept]
    return src


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("t", TS)
@pytest.mark.parametrize("e,k", EK)
def test_plain_version_equals_the_jax_reference(e, k, t, kind):
    x = logits_of(kind, t, e, seed=t + e + KINDS.index(kind))
    cap = grouped_capacity(t, e, k)
    jg, ji, jrank, jkeep, jslot = jax_route(x, k, cap)
    gates, idx, slot, src = ops.moe_route_slots(torch.tensor(x), k, cap)
    assert (gates.dtype, idx.dtype, slot.dtype, src.dtype) == (
        torch.float32, torch.int32, torch.int32, torch.int32)
    assert slot.shape == (t, k) and src.shape == (e * cap,)
    np.testing.assert_array_equal(idx.numpy(), ji)
    np.testing.assert_allclose(gates.numpy(), jg, rtol=0, atol=1e-6)
    # the rank itself: slots at a capacity that keeps every pair
    rank, _ = ref.route_slots_ref(idx, e, t * k + 1)
    np.testing.assert_array_equal(rank.numpy().reshape(-1), jrank)
    np.testing.assert_array_equal(slot.numpy().reshape(-1), jslot)
    np.testing.assert_array_equal((slot < cap).numpy().reshape(-1), jkeep)
    np.testing.assert_array_equal(src.numpy(), src_of(ji, jslot.reshape(
        t, k), e, cap))
    if kind == "ties":                  # the lower index first on a tie
        np.testing.assert_array_equal(idx.numpy()[0], np.arange(k))
    if kind == "skewed" and t >= 96:    # the case must overflow
        assert not jkeep.all()


# ---------------------------------------------------------------------------
# The kernel's decomposition, emulated
# ---------------------------------------------------------------------------

ROUTE_THREADS = 1024         # threads per CTA (moe_route_slots.cu, THREADS)


def emulate_kernel(idx, e, cap, rng, prefix_share, mutant=None):
    """moe_route_slots.cu's slot assignment on the CPU, step for step, for
    the experts idx [T, k] of its routing: tiles of ``ops.ROUTE_TILE``
    rows in ticket order; per tile a bitmask rows_of[e] of its rows that
    chose e, its counts popc(rows_of) and each pair's in-tile rank
    popc(rows_of[e] & ((1 << r) - 1)); each tile's exclusive prefix by the
    look-back, in rounds over a window of Q = ROUTE_THREADS // E rows of
    U = 4 words each (window position q*U + u, newest first), over
    predecessors whose words hold their inclusive prefix (PREFIX) with
    probability ``prefix_share`` at the time of reading and their count
    (AGG) otherwise (tile 0 always PREFIX): each expert takes the lowest
    position holding a PREFIX and adds the values down to and including
    it, or all of them and moves its window back. ``mutant``:
    "inclusive_rank" counts the pair's own row in its in-tile rank;
    "prefix_dropped" leaves out the PREFIX's own value. Returns (slot
    [T, k], src [E*cap])."""
    t, k = idx.shape
    rows, window = ops.ROUTE_TILE, ROUTE_THREADS // e * 4
    tiles = -(-t // rows)
    rows_of = np.zeros((tiles, e), np.int64)
    for row in range(t):
        for ex in idx[row]:
            rows_of[row // rows, ex] |= 1 << (row % rows)
    counts = np.vectorize(lambda m: bin(m).count("1"))(rows_of)
    incl = np.cumsum(counts, axis=0)
    pos = np.arange(window)[:, None]
    cols = np.arange(e)
    slot = np.zeros((t, k), np.int64)
    src = np.full(e * cap, t, np.int64)
    for tile in range(tiles):
        prefix = rng.random((tiles, e)) < prefix_share
        prefix[0] = True
        excl = np.zeros(e, np.int64)
        done = np.full(e, tile == 0)
        hi = np.full(e, tile)
        while not done.all():
            p = hi[None, :] - 1 - pos                            # [W, E]
            pc = np.maximum(p, 0)
            is_pre = (p >= 0) & prefix[pc, cols]
            val = np.where(p < 0, 0, np.where(is_pre, incl[pc, cols],
                                               counts[pc, cols]))
            has = is_pre.any(axis=0)
            first = np.where(has, is_pre.argmax(axis=0), window)
            take = pos < first if mutant == "prefix_dropped" \
                else pos <= first
            excl = np.where(done, excl, excl + (val * take).sum(axis=0))
            hi = np.where(done | has, hi, hi - window)
            done |= has
        for r in range(min(rows, t - tile * rows)):
            row = tile * rows + r
            below = (1 << (r + 1 if mutant == "inclusive_rank" else r)) - 1
            for j, ex in enumerate(idx[row]):
                rank = excl[ex] + bin(rows_of[tile, ex] & below).count("1")
                slot[row, j] = min(rank, cap)
                if rank < cap:
                    src[ex * cap + rank] = row
    return slot, src


@pytest.mark.parametrize("kind", ["normal", "skewed"])
@pytest.mark.parametrize("t", [1, 31, 33, 1000, 4096])
@pytest.mark.parametrize("e,k", EK[:2])
def test_kernel_decomposition_equals_the_cumsum_rank(e, k, t, kind):
    """T not a multiple of the tile (31, 33, 1000) and T spanning many
    tiles (4096: 128 tiles, beyond one look-back window at both E), with
    predecessors' words found in every mix of states."""
    x = logits_of(kind, t, e, seed=7 * t + e)
    cap = grouped_capacity(t, e, k)
    _, idx = ref.moe_router_topk_ref(torch.tensor(x), k)
    want_slot, want_src = ref.route_slots_ref(idx, e, cap)
    rng = np.random.default_rng(t)
    for share in (0.0, 0.2, 1.0):
        slot, src = emulate_kernel(idx.numpy(), e, cap, rng, share)
        np.testing.assert_array_equal(slot, want_slot.numpy())
        np.testing.assert_array_equal(src, want_src.numpy())


@pytest.mark.parametrize("mutant", ["inclusive_rank", "prefix_dropped"])
def test_kernel_decomposition_mutants_are_caught(mutant):
    """An off-by-one in the in-tile rank, and a look-back that leaves out
    the inclusive prefix it stops at, both move slots on DeepSeekMoE's
    shape."""
    x = logits_of("normal", 1000, 64, seed=5)
    _, idx = ref.moe_router_topk_ref(torch.tensor(x), 6)
    cap = grouped_capacity(1000, 64, 6)
    want, _ = ref.route_slots_ref(idx, 64, cap)
    slot, _ = emulate_kernel(idx.numpy(), 64, cap,
                             np.random.default_rng(0), 0.2, mutant=mutant)
    assert (slot != want.numpy()).any()


# ---------------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------------

def test_wrapper_checks_inputs_and_counts_only_kernel_launches():
    x = torch.tensor(logits_of("normal", 8, 16, 0))
    before = dict(ops.LAUNCHES)
    ops.moe_route_slots(x, 2, 8)
    assert ops.LAUNCHES == before            # plain version: no launches
    for bad, err in (((x, 17, 8), ValueError),            # k > E
                     ((torch.zeros(4, 513), 2, 8), ValueError),  # E > 512
                     ((torch.zeros(4, 64), 33, 8), ValueError),  # k > 32
                     ((x, 2, 0), ValueError),              # cap < 1
                     ((x.double(), 2, 8), TypeError),
                     ((x.t(), 2, 8), ValueError),          # not contiguous
                     ((x[0], 2, 8), ValueError)):          # not [T, E]
        with pytest.raises(err):
            ops.moe_route_slots(*bad)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_side_branch_and_launch_arguments(monkeypatch, dtype):
    """The card-side branch, driven on the CPU with the launch stubbed:
    the C entry receives the seven pointers, T, E, k, cap, the scratch's
    word count and the dtype code; the scratch holds ceil(T / 32) * E
    words at least (2**15, a power of two), is made once per device and
    reused, grows for a larger T and keeps the buffer it outgrew; T = 0
    launches nothing and leaves every slot empty; bad input is refused
    before any launch."""
    calls = []
    monkeypatch.setattr(ops, "_ROUTE_SCRATCH", {})
    monkeypatch.setattr(ops, "_ROUTE_RETIRED", [])
    monkeypatch.setattr(ops, "_on_card", lambda *ts: True)
    monkeypatch.setattr(ops, "_launch",
                        lambda name, out, *args: calls.append(
                            (name, args)) or out)
    x = torch.zeros(100, 64, dtype=dtype)
    gates, idx, slot, src = ops.moe_route_slots(x, 6, 24)
    assert (gates.shape, idx.shape, slot.shape, src.shape) == (
        (100, 6), (100, 6), (100, 6), (64 * 24,))
    assert (idx.dtype, slot.dtype, src.dtype) == (torch.int32,) * 3
    name, args = calls.pop()
    state, words = ops._ROUTE_SCRATCH[x.device]
    assert name == "moe_route_slots"
    assert args == (x.data_ptr(), gates.data_ptr(), idx.data_ptr(),
                    slot.data_ptr(), src.data_ptr(), words.data_ptr(),
                    state.data_ptr(), 100, 64, 6, 24, 2 ** 15,
                    ops._DTYPE_CODE[dtype])
    assert state.dtype == torch.int32 and state.shape == (4,)
    assert words.dtype == torch.int64 and not words.any()
    ops.moe_route_slots(x, 6, 24)            # the same scratch again
    assert calls.pop()[1][5] == words.data_ptr() and not ops._ROUTE_RETIRED
    big = torch.zeros(40000, 64, dtype=dtype)  # 1250 tiles * 64 > 2**15
    ops.moe_route_slots(big, 6, 8)
    args = calls.pop()[1]
    assert args[7:12] == (40000, 64, 6, 8, 2 ** 17)
    assert ops._ROUTE_RETIRED == [(state, words)]
    g, i, s, src0 = ops.moe_route_slots(torch.zeros(0, 16, dtype=dtype), 2, 8)
    assert calls == [] and s.shape == (0, 2) and src0.shape == (128,)
    assert not src0.any()                    # every slot empty: T = 0
    with pytest.raises(ValueError):
        ops.moe_route_slots(x, 6, 0)
    with pytest.raises(ValueError):
        ops.moe_route_slots(torch.zeros(4, 513, dtype=dtype), 2, 8)
    assert calls == []
