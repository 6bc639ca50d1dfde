"""The router kernels' row code as redesigned (``csrc/router_row.cuh``,
shared by ``moe_router.cu`` and ``moe_route_slots.cu``), emulated on the
CPU and held to chip_smoke's unchanged limits against the JAX package's
router; the faults those limits must catch.

The emulation (``emulate``) computes what a group of G lanes computes, in
its order (``router_lanes``: G lanes a row, EPL contiguous experts a
lane, experts at or past E at -inf): the lane's max and its sum of e =
exp(x - max) as trees (element i + w into i, w = EPL/2 .. 1), then
butterflies over ``lane ^ off`` for off = G/2 .. 1, in fp32; masked
experts at -1; k rounds, each the best remaining (e, expert) of each lane
(the larger e, the lower expert on a tie: the head of the lane's sorted
list), then the best of the lanes' heads, the lower expert winning an
equal value (the kernel's ballot takes the lowest lane of the largest
head, and lanes hold ascending runs), the winner dropped; round r kept by
lane r % G in slot
r / G, which forms p = e / sum; the renormalising sum each lane's slots in
order, then the butterfly; gate = p / (sum + 1e-9).

The JAX side runs once per (E, k) for the module (``jax_outputs``): the
Pallas router in interpret mode through ``repro.kernels.ops
.moe_router_topk`` and the JAX reference ``repro.kernels.ref
.moe_router_topk_ref``, on f32 logits and on bf16-rounded logits read as
f32 (the kernel widens bf16 exactly). Logits are ``chip_smoke
.router_rows``' kind: normal draws, every third row half the experts at
6.0 (an exact tie across the top), every fifth row rounded (ties inside
the top k). The limits are chip_smoke's: gates within 1e-6, indices equal
on the tie rows, at most two rows elsewhere with near-equal experts
swapped.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref

from repro_torch.kernels import ops, ref

from torch_threads import one_torch_thread  # noqa: F401

EK = [(e, k) for e in (16, 48, 64, 128, 512) for k in (1, 2, 6, 8, 32)
      if k <= e]
DTYPES = ("float32", "bfloat16")
ROWS = 40
MUTANTS = ("tie_to_higher_index", "winner_unmasked", "partial_renorm",
           "tail_at_zero")


def logits(e, seed, dtype):
    """[ROWS, E] fp32 logits (bf16-rounded for ``bfloat16``) and the mask
    of tie rows, as ``chip_smoke.router_rows`` makes them."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(ROWS, e)).astype(np.float32)
    x[::3, : e // 2] = 6.0
    x[1::5] = np.round(x[1::5])
    ties = np.zeros(ROWS, dtype=bool)
    ties[::3] = True
    ties[1::5] = True
    if dtype == "bfloat16":
        x = torch.tensor(x).to(torch.bfloat16).float().numpy()
    return x, ties


def router_lanes(e: int):
    """(G, EPL): the lanes that route one row of ``e`` experts and the
    experts each lane holds, as ``csrc/router_row.cuh``'s
    ``dispatch_lanes`` picks them: the least power of two G with 4 G >= E,
    at most 32, 4 experts a lane; past 128 experts, 32 lanes of 8, then
    of 16."""
    if not 1 <= e <= ops.ROUTER_MAX_EXPERTS:
        raise ValueError(f"E = {e}")
    g, epl = 1, 4
    while g * epl < e:
        if g < 32:
            g *= 2
        else:
            epl *= 2
    return g, epl


def tree(v, op):
    """v [T, G, EPL] -> [T, G]: element i + w combined into i for w =
    EPL/2 .. 1, as the kernel's lane-local reductions run."""
    v = v.copy()
    w = v.shape[2] // 2
    while w:
        v[..., :w] = op(v[..., :w], v[..., w:2 * w])
        w //= 2
    return v[..., 0]


def butterfly(v, op):
    """v [T, G]: every lane combines its value with lane ^ off's, off =
    G/2 .. 1, as ``__shfl_xor_sync`` levels do."""
    g = v.shape[1]
    lanes = np.arange(g)
    off = g // 2
    while off:
        v = op(v, v[:, lanes ^ off])
        off //= 2
    return v


def emulate(x, k, mutant=None):
    """(gates [T, k] fp32, idx [T, k] int32) as the row code computes
    them on fp32 logits x [T, E]. ``mutant``: one of ``MUTANTS``: a tie
    won by the higher index, a round's winner left unmasked, the
    renormalising sum over each lane's own slots (its butterfly
    skipped), experts past E at 0 and routed as experts."""
    t, e = x.shape
    g, epl = router_lanes(e)
    kpl = -(-min(g * epl, 32) // g)
    f32 = np.float32
    tail = 0.0 if mutant == "tail_at_zero" else -np.inf
    xp = np.full((t, g * epl), tail, dtype=f32)
    xp[:, :e] = x
    valid = np.arange(g * epl) < (g * epl if mutant == "tail_at_zero" else e)
    p = xp.reshape(t, g, epl)
    valid = valid.reshape(g, epl)

    mx = butterfly(tree(p, np.maximum), np.maximum)
    ex = np.where(valid, np.exp(p - mx[..., None]), f32(0))
    s = butterfly(tree(ex, np.add), np.add)
    p = np.where(valid, ex, f32(-1))

    lanes = np.arange(g)
    first = lanes * epl
    kept = np.zeros((t, g, kpl), dtype=f32)
    idx = np.zeros((t, k), dtype=np.int32)
    rows = np.arange(t)
    for r in range(k):
        if mutant == "tie_to_higher_index":     # the last of equal values
            li = epl - 1 - np.argmax(p[..., ::-1], axis=2)
        else:
            li = np.argmax(p, axis=2)
        bv = np.take_along_axis(p, li[..., None], axis=2)[..., 0]
        bi = first + li
        off = g // 2
        while off:
            ov, oi = bv[:, lanes ^ off], bi[:, lanes ^ off]
            if mutant == "tie_to_higher_index":
                take = (ov > bv) | ((ov == bv) & (oi > bi))
            else:
                take = (ov > bv) | ((ov == bv) & (oi < bi))
            bv, bi = np.where(take, ov, bv), np.where(take, oi, bi)
            off //= 2
        assert (bi == bi[:, :1]).all() and (bv == bv[:, :1]).all()
        kept[:, r % g, r // g] = bv[:, 0]
        idx[:, r] = bi[:, 0]
        if mutant != "winner_unmasked":
            win = bi[:, 0]
            p.reshape(t, -1)[rows, win] = f32(-1)

    part = np.zeros((t, g), dtype=f32)
    kept = kept / s[..., None]
    for s_ in range(kpl):
        slot_used = s_ * g + lanes < k
        part = part + np.where(slot_used, kept[..., s_], f32(0))
    if mutant == "partial_renorm":
        total = part                        # a lane's own slots only
    else:
        total = butterfly(part, np.add)
    total = total + f32(1e-9)
    gates = np.zeros((t, k), dtype=f32)
    for r in range(k):
        gates[:, r] = kept[:, r % g, r // g] / total[:, r % g]
    return gates, idx


def limit_faults(gates, idx, want_gates, want_idx, ties):
    """chip_smoke's router limits, as a list of what broke them (empty:
    inside): gates within 1e-6, indices equal on the tie rows, at most two
    other rows whose indices differ."""
    faults = []
    err = float(np.abs(gates - want_gates).max())
    if not err <= 1e-6:
        faults.append(f"gate error {err:.3e}")
    differ = (idx != want_idx).any(axis=1)
    if (differ & ties).any():
        faults.append(f"{int((differ & ties).sum())} tie rows differ")
    if int(differ.sum()) > 2:
        faults.append(f"{int(differ.sum())} rows differ")
    return faults


@pytest.fixture(scope="module")
def jax_outputs():
    """{(E, k, dtype): (x, ties, [(gates, idx) of the JAX Pallas router,
    of the JAX reference])}: one JAX call of each per (E, k), on the f32
    and the bf16-rounded rows stacked."""
    out = {}
    for e, k in EK:
        cases = [(dt,) + logits(e, 7 * e + k, dt) for dt in DTYPES]
        x = jnp.asarray(np.concatenate([c[1] for c in cases]))
        runs = [tuple(np.asarray(a) for a in fn(x, k))
                for fn in (jops.moe_router_topk, jref.moe_router_topk_ref)]
        for i, (dt, xs, ties) in enumerate(cases):
            rows = slice(i * ROWS, (i + 1) * ROWS)
            out[e, k, dt] = (xs, ties, [(g[rows], j[rows]) for g, j in runs])
    return out


@pytest.mark.parametrize("e,want", [
    (1, (1, 4)), (4, (1, 4)), (5, (2, 4)), (16, (4, 4)), (48, (16, 4)),
    (64, (16, 4)), (65, (32, 4)), (128, (32, 4)), (129, (32, 8)),
    (256, (32, 8)), (257, (32, 16)), (384, (32, 16)), (512, (32, 16))])
def test_lanes_a_row_follow_from_the_experts(e, want):
    """G lanes a row: the least power of two with 4 G >= E, at most 32; 4
    experts a lane, 8 past E = 128, 16 past 256. A lane's experts fill
    whole vector loads: 16 bytes for f32, 8 or 16 for bf16."""
    g, epl = router_lanes(e)
    assert (g, epl) == want
    assert g * epl >= e and 32 % g == 0
    assert epl * 4 % 16 == 0 and epl * 2 % 8 == 0
    with pytest.raises(ValueError):
        router_lanes(513)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("e,k", EK)
def test_emulation_inside_the_limits(jax_outputs, e, k, dtype):
    """The row code's numerics stay inside chip_smoke's limits against the
    JAX package's Pallas router (interpret mode), the JAX reference and
    the port's plain version; on the tie rows the indices are exact and
    the lower index comes first."""
    x, ties, jax_runs = jax_outputs[e, k, dtype]
    gates, idx = emulate(x, k)
    assert gates.dtype == np.float32 and idx.dtype == np.int32
    assert np.isfinite(gates).all()
    plain = tuple(a.numpy() for a in ref.moe_router_topk_ref(
        torch.tensor(x), k))
    for want_gates, want_idx in jax_runs + [plain]:
        assert limit_faults(gates, idx, want_gates, want_idx, ties) == []
    srt = np.sort(idx, axis=1)
    assert (srt[:, 1:] != srt[:, :-1]).all()         # k distinct experts
    if k <= e // 2:                 # row 0: experts 0 .. E/2 - 1 tie at 6
        np.testing.assert_array_equal(idx[0], np.arange(k))


@pytest.mark.parametrize("mutant", MUTANTS)
def test_the_limits_reject_faulty_row_code(jax_outputs, mutant):
    """Each fault breaks chip_smoke's limits against the JAX Pallas router
    on some case of the set: a tie won by the higher index (tie rows), a
    round's winner left unmasked (a repeated index), the renormalisation
    over a lane's own slots, experts past E at 0 (picked at E = 48, k =
    32)."""
    broken = []
    for (e, k, dtype), (x, ties, jax_runs) in jax_outputs.items():
        gates, idx = emulate(x, k, mutant)
        if limit_faults(gates, idx, *jax_runs[0], ties):
            broken.append((e, k, dtype))
    assert broken, mutant
    if mutant == "tail_at_zero":
        assert (48, 32, "float32") in broken
    elif mutant == "partial_renorm":
        assert (64, 6, "float32") in broken
    else:
        assert all((e, k, "float32") in broken for e, k in EK if k > 1)
