"""Worker-axis sharding: the port's shard plan, ring contract, placement
and sharded mix against the reference's.

``WorkerShardPlan`` takes only numbers, so the reference's plan is built in
this process and held field for field against the port's (W in {16, 22,
60, 100} x shards in {1, 2, 4, 8} on a sparse and a dense topology, and 30
hypothesis-drawn adjacencies). The reference's ``mix_pytree_sharded``
needs a mesh of 8 devices, so it runs once in a forced-8-device JAX
subprocess (``test_distributed.run_py``; jitted, its Pallas kernels in
interpret mode as the JAX package runs them on the CPU) on inputs this
module draws with numpy; the port's mix runs on ``["cpu"] * S`` shards
beside it. Limits:
1e-6 on the fp32 and bf16 wires (EF21 residuals included), one
quantization step of the row sent on the int8 wire.

The port's mix is also held to its own contracts: secagg sharded equals
plaintext sharded bit for bit, the bytes it moves between shards equal
``roofline.sharded_ring_bytes``, the padding rows of P are identity rows,
the cross-shard blocks are added in used-offset order (an input where
float addition does not associate tells the orders apart), and on the
card (``ops._launch`` stubbed) each shard launches one local-block kernel
per leaf at the block's shape.
"""
from __future__ import annotations

import json
import warnings

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import gossip as jgossip
from repro.core import engine as jengine
from repro.config import DeFTAConfig as JDeFTAConfig
from repro.launch import roofline as jroofline
from test_distributed import run_py

from repro_torch import sharding
from repro_torch.config import DeFTAConfig
from repro_torch.core import engine, gossip
from repro_torch.core.secagg import secagg_base_key
from repro_torch.core.topology import make_topology
from repro_torch.kernels import ops
from repro_torch.launch import roofline

PLAN_FIELDS = ("w", "shards", "block", "wp", "pairs", "used_offsets",
               "perms", "intra_edges", "cross_edges")


def cpu_shards(s):
    return sharding.WorkerShards((torch.device("cpu"),) * s)


def assert_plans_equal(adj, s):
    ours = gossip.WorkerShardPlan(adj, s)
    theirs = jgossip.WorkerShardPlan(adj, s)
    for f in PLAN_FIELDS:
        assert getattr(ours, f) == getattr(theirs, f), f
    np.testing.assert_array_equal(ours.idx, theirs.idx)
    np.testing.assert_array_equal(ours.valid, theirs.valid)
    assert ours.idx.dtype == theirs.idx.dtype
    return ours


@pytest.mark.parametrize("w", [16, 22, 60, 100])
@pytest.mark.parametrize("s", [1, 2, 4, 8])
@pytest.mark.parametrize("kind", ["random_kout", "dense"])
def test_plan_equals_the_references(w, s, kind):
    plan = assert_plans_equal(make_topology(kind, w, 4, 0), s)
    if s == 1:
        assert plan.pairs == () and plan.used_offsets == () \
            and plan.cross_edges == 0
    # each shard's sources are the used offsets' senders it is named for
    for si, srcs in enumerate(plan.sources):
        assert sorted(srcs) == sorted(a for a, b in plan.pairs if b == si)


@settings(max_examples=30, deadline=None)
@given(w=st.integers(1, 40), s=st.integers(1, 8),
       seed=st.integers(0, 2 ** 31 - 1), density=st.floats(0.0, 0.6))
def test_plan_equals_the_references_on_drawn_adjacencies(w, s, seed,
                                                         density):
    adj = np.random.default_rng(seed).random((w, w)) < density
    assert_plans_equal(adj, s)


@pytest.mark.parametrize("wire", [None, "bf16", "int8"])
@pytest.mark.parametrize("w,s", [(16, 4), (22, 4), (100, 8), (60, 1)])
def test_ring_bytes_equal_the_roofline_contract(wire, w, s):
    adj = make_topology("random_kout", w, 4, 0)
    plan = gossip.worker_shard_plan(adj, s)
    for n_params, rows in ((1000, 1), (22_890, 4)):
        want = roofline.sharded_ring_bytes(n_params, adj, s, wire,
                                           rows=rows)
        assert want == jroofline.sharded_ring_bytes(n_params, adj, s, wire,
                                                    rows=rows)
        assert plan.ring_bytes(n_params, wire, rows=rows) \
            == want["ring_bytes"]
        assert (plan.intra_edges, plan.cross_edges, len(plan.pairs)) == \
            (want["intra_edges"], want["cross_edges"], want["used_pairs"])


def test_plan_memo_is_a_16_entry_lru():
    gossip._PLAN_CACHE.clear()
    adjs = [make_topology("random_kout", 10, 3, seed) for seed in range(17)]
    first = gossip.worker_shard_plan(adjs[0], 2)
    assert gossip.worker_shard_plan(adjs[0].copy(), 2) is first
    assert gossip.worker_shard_plan(adjs[0], 5) is not first
    for a in adjs[1:15]:
        gossip.worker_shard_plan(a, 2)
    assert gossip.worker_shard_plan(adjs[0], 2) is first     # refreshed
    gossip.worker_shard_plan(adjs[15], 2)                    # evicts (0, 5)
    gossip.worker_shard_plan(adjs[16], 2)
    assert len(gossip._PLAN_CACHE) == gossip._PLAN_CACHE_MAX == 16
    assert gossip.worker_shard_plan(adjs[0], 2) is first


# ---------------------------------------------------------------------------
# The sharded mix against the reference's
# ---------------------------------------------------------------------------

# (W, shards) x (wire, EF21 residual, secagg)
MIX_WORLDS = [(16, 4), (100, 8)]
MIX_WIRES = [(None, False, False), ("bf16", True, False),
             ("int8", True, False), (None, False, True),
             ("int8", True, True)]
LEAVES = {"a": (3, 5), "b": (7,)}


def mix_inputs(w):
    rng = np.random.default_rng(w)
    adj = make_topology("random_kout", w, 4, 1)
    mask = (adj | np.eye(w, dtype=bool)) & (rng.random((w, w)) < 0.8)
    np.fill_diagonal(mask, True)
    P = mask * rng.random((w, w)).astype(np.float32)
    P = (P / P.sum(axis=1, keepdims=True)).astype(np.float32)
    stacked = {k: rng.normal(size=(w,) + s).astype(np.float32)
               for k, s in LEAVES.items()}
    residual = {k: 0.01 * rng.normal(size=(w,) + s).astype(np.float32)
                for k, s in LEAVES.items()}
    return adj, P, stacked, residual


REF_CODE = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.core.gossip import mix_pytree_sharded
from repro.core.secagg import secagg_base_key
from repro.sharding import worker_mesh
spec = json.loads(sys.argv[1])
out = {}
for case in spec["cases"]:
    w, s, wire, ef, sec = case
    z = np.load(spec["inputs"][str(w)])
    adj = z["adj"]
    stacked = {k: jnp.asarray(z["x_" + k]) for k in "ab"}
    res = {k: jnp.asarray(z["r_" + k]) for k in "ab"} if ef else None
    mesh = worker_mesh(s)
    base = secagg_base_key(0) if sec else None
    got = jax.jit(lambda P, x, r: mix_pytree_sharded(
        P, x, mesh, axis="worker", adjacency=adj, wire=wire, residual=r,
        secagg=base, secagg_round=3))(jnp.asarray(z["P"]), stacked, res)
    mixed, new_r = got if ef else (got, None)
    tag = f"{w}_{s}_{wire}_{int(ef)}_{int(sec)}"
    for k in "ab":
        out[f"{tag}_m_{k}"] = np.asarray(mixed[k], np.float32)
        if ef:
            out[f"{tag}_r_{k}"] = np.asarray(new_r[k], np.float32)
np.savez(spec["out"], **out)
print("ok")
"""


def case_tag(w, s, wire, ef, sec):
    return f"{w}_{s}_{wire}_{int(ef)}_{int(sec)}"


@pytest.fixture(scope="module")
def reference_mixes(tmp_path_factory):
    """The reference's sharded mix of every case, from one forced-8-device
    JAX subprocess."""
    d = tmp_path_factory.mktemp("shard_mix")
    inputs = {}
    for w, _ in MIX_WORLDS:
        adj, P, stacked, residual = mix_inputs(w)
        path = d / f"in_{w}.npz"
        np.savez(path, adj=adj, P=P,
                 **{f"x_{k}": v for k, v in stacked.items()},
                 **{f"r_{k}": v for k, v in residual.items()})
        inputs[str(w)] = str(path)
    cases = [(w, s, wire, ef, sec) for w, s in MIX_WORLDS
             for wire, ef, sec in MIX_WIRES]
    spec = {"inputs": inputs, "cases": cases, "out": str(d / "out.npz")}
    code = ("import sys; sys.argv = ['ref', %r]\n" % json.dumps(spec)
            + REF_CODE)
    assert "ok" in run_py(code)
    return dict(np.load(d / "out.npz"))


def port_mix(w, s, wire, ef, sec, secagg_round=3):
    adj, P, stacked, residual = mix_inputs(w)
    gossip.reset_ring()
    got = gossip.mix_pytree_sharded(
        torch.tensor(P), {k: torch.tensor(v) for k, v in stacked.items()},
        cpu_shards(s), adjacency=adj, wire=wire,
        residual={k: torch.tensor(v) for k, v in residual.items()}
        if ef else None,
        secagg=secagg_base_key(0) if sec else None,
        secagg_round=secagg_round)
    mixed, new_r = got if ef else (got, None)
    return adj, stacked, mixed, new_r


@pytest.mark.parametrize("wire,ef,sec", MIX_WIRES)
@pytest.mark.parametrize("w,s", MIX_WORLDS)
def test_sharded_mix_matches_the_references(reference_mixes, w, s, wire,
                                            ef, sec):
    _, stacked, mixed, new_r = port_mix(w, s, wire, ef, sec)
    tag = case_tag(w, s, wire, ef, sec)
    for k, x in stacked.items():
        want = reference_mixes[f"{tag}_m_{k}"]
        got = mixed[k].numpy()
        assert got.shape == want.shape == x.shape
        if wire == "int8":
            # one quantization step of the largest row a receiver mixes
            step = np.abs(x.reshape(w, -1)).max() / 127.0
            assert np.abs(got - want).max() <= step, k
            limit = step
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6,
                                       err_msg=k)
            limit = 1e-6
        if ef:
            assert np.abs(new_r[k].numpy()
                          - reference_mixes[f"{tag}_r_{k}"]).max() <= limit


@pytest.mark.parametrize("wire,ef", [(None, False), ("bf16", True),
                                     ("int8", True)])
@pytest.mark.parametrize("w,s", MIX_WORLDS)
def test_secagg_sharded_equals_plaintext_bit_for_bit(w, s, wire, ef):
    """The block-channel pads cancel word for word: the masked mix, its
    residuals and the bytes it moves equal the plaintext mix's."""
    _, _, plain, plain_r = port_mix(w, s, wire, ef, False)
    plain_bytes = gossip.RING["bytes"]
    for round_ in (0, 7):
        _, _, masked, masked_r = port_mix(w, s, wire, ef, True, round_)
        assert gossip.RING["bytes"] == plain_bytes
        for k in plain:
            assert torch.equal(masked[k], plain[k]), k
            if ef:
                assert torch.equal(masked_r[k], plain_r[k]), k


def test_shard_pads_are_directed_fresh_and_tagged():
    """A block channel's pads differ by direction, round and leaf tag, and
    the payload and scale channels of a leaf differ."""
    plan = gossip.worker_shard_plan(make_topology("random_kout", 16, 4, 0),
                                    4)
    base = secagg_base_key(0)

    def pads(src, dst, round_):
        return gossip._shard_pads(plan, base, round_, src, dst, [12, 12],
                                  "int8", "cpu")
    a, b, c = pads(0, 1, 2), pads(1, 0, 2), pads(0, 1, 3)
    assert not torch.equal(a[0][0], b[0][0])
    assert not torch.equal(a[0][0], c[0][0])
    assert not torch.equal(a[0][0], a[1][0])               # leaf tags
    assert not torch.equal(a[0][1], a[1][1])               # scale tags
    assert torch.equal(a[0][0], pads(0, 1, 2)[0][0])       # keyed, not drawn
    seen = []
    block = gossip.sa.pad_block
    gossip.sa.pad_block = lambda *args: seen.append(args[4]) or block(*args)
    try:
        pads(2, 3, 0)
    finally:
        gossip.sa.pad_block = block
    assert seen == [[(0, 12), (1, 4), (2, 12), (3, 4)]]    # 2·li, 2·li + 1


@pytest.mark.parametrize("wire", [None, "bf16", "int8"])
@pytest.mark.parametrize("w,s", [(16, 4), (22, 4), (100, 8)])
def test_the_transport_moves_the_contracts_ring_bytes(w, s, wire):
    adj, stacked, _, _ = port_mix(w, s, wire, False, False)
    n_params = sum(int(np.prod(v.shape[1:])) for v in stacked.values())
    want = roofline.sharded_ring_bytes(n_params, adj, s, wire,
                                       rows=len(stacked))
    assert gossip.RING["bytes"] == want["ring_bytes"]
    assert gossip.RING["blocks"] == want["used_pairs"] * len(stacked)


def test_padding_rows_of_p_are_identity_rows():
    P = torch.rand(5, 5)
    Pp = gossip._pad_mixing(P / P.sum(1, keepdim=True), 8)
    assert torch.equal(Pp[5:, 5:], torch.eye(3))
    assert torch.equal(Pp[5:, :5], torch.zeros(3, 5))
    assert torch.equal(Pp[:5, 5:], torch.zeros(5, 3))
    torch.testing.assert_close(Pp.sum(1), torch.ones(8))


def test_cross_shard_blocks_are_added_in_used_offset_order():
    """Receiver 0 of shard 0 (W = 16, four shards of 4) takes 1.0 from
    itself and 2^30, -2^30 and 1.0 from one worker of shards 3, 2 and 1:
    offsets 1, 2, 3 in that order give ((1 + 2^30) - 2^30) + 1 = 1 in
    float32, where the reverse order gives 0."""
    w, s = 16, 4
    adj = np.zeros((w, w), bool)
    adj[0, [12, 8, 4]] = True
    P = torch.zeros(w, w)
    P[0, [0, 12, 8, 4]] = 1.0
    P[1:] = torch.eye(w)[1:]
    x = torch.zeros(w, 1)
    x[0], x[12], x[8], x[4] = 1.0, 2.0 ** 30, -2.0 ** 30, 1.0
    plan = gossip.worker_shard_plan(adj, s)
    assert plan.used_offsets == (1, 2, 3) and plan.sources[0] == (3, 2, 1)
    got = gossip.mix_pytree_sharded(P, {"x": x}, cpu_shards(s),
                                    adjacency=adj)
    assert float(got["x"][0, 0]) == 1.0


def test_placement_splits_even_rows_and_warns_on_uneven():
    sh = cpu_shards(4)
    st_ = engine.DeFTAState(params={"a": torch.arange(16.).reshape(8, 2)},
                            backup={"a": torch.zeros(8, 2)},
                            conf=torch.rand(8, 8), best_loss=torch.zeros(8),
                            last_loss=torch.zeros(8),
                            epoch=torch.arange(8, dtype=torch.int32))
    blocks = sh.shard_leading(st_, 8)
    assert [tuple(b.conf.shape) for b in blocks] == [(2, 8)] * 4
    assert blocks[1].params["a"].data_ptr() != \
        st_.params["a"][2:4].data_ptr()                  # owns its rows
    back = sh.gather_leading(blocks, 8)
    assert torch.equal(back.conf, st_.conf) and \
        torch.equal(back.params["a"], st_.params["a"])
    sharding._DEMOTION_WARNED.clear()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        assert len(cpu_shards(3).shard_leading(st_, 8)) == 1
    assert any("not divisible" in str(r.message) for r in rec)


def test_worker_shards_resolves_devices(monkeypatch):
    assert sharding.worker_shards(None, "cpu") is None
    assert sharding.worker_shards(1, "cpu") is None
    assert sharding.worker_shards(4, "cpu").devices == \
        (torch.device("cpu"),) * 4
    assert sharding.worker_shards(None, "cpu", ["cpu"] * 2).shards == 2
    with pytest.raises(ValueError, match="2 shard devices"):
        sharding.worker_shards(3, "cpu", ["cpu"] * 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="only 1 devices are visible"):
        sharding.worker_shards(4, "cuda")
    assert sharding.worker_shards(2, "cuda").devices == (
        torch.device("cuda", 0), torch.device("cuda", 1)) \
        if torch.cuda.device_count() >= 2 else True
    got = sharding.worker_shards(None, "cuda", ["cuda:0"] * 4)
    assert got.devices == (torch.device("cuda", 0),) * 4
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sharding.worker_shards(None, "cuda", ["cuda:0"] * 4)


# ---------------------------------------------------------------------------
# Refusals: the reference's classes, in its order
# ---------------------------------------------------------------------------

REFUSALS = [
    dict(gossip_dtype="int8", gossip_wire_round="stochastic"),
    dict(secagg="pairwise", aggregation="krum"),
    dict(secagg="pairwise", aggregation="median", gossip_dtype="int8"),
    dict(secagg="bogus", gossip_dtype="int8",
         gossip_wire_round="stochastic"),
    dict(gossip_dtype="int8"),
    dict(secagg="pairwise", gossip_dtype="int8"),
]


def outcome(fn):
    try:
        fn()
    except Exception as e:                      # noqa: BLE001
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("change", REFUSALS)
def test_sharded_transport_refusals_equal_the_references(change):
    from repro.sharding import WorkerShards as JWorkerShards
    from repro.sharding import worker_mesh
    from repro.scenarios.robust_agg import ROBUST_RULES as JROBUST
    jcfg = JDeFTAConfig(**change)
    jshard = JWorkerShards(mesh=worker_mesh(1))
    want = outcome(lambda: jengine.make_transport(
        jcfg, robust=jcfg.aggregation in JROBUST, shard=jshard))
    cfg = DeFTAConfig(**change)
    got = outcome(lambda: engine.make_transport(
        cfg, robust=cfg.aggregation in engine.ROBUST_RULES,
        shard=cpu_shards(2)))
    assert got == want
    assert outcome(lambda: engine.check_supported(cfg, shard=cpu_shards(2))) \
        == want


# ---------------------------------------------------------------------------
# The card-side branch (``ops._launch`` stubbed)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wire,kernel", [(None, "gossip_mix_sparse"),
                                         ("bf16", "gossip_mix_sparse"),
                                         ("int8", "gossip_mix_quant")])
@pytest.mark.parametrize("w,s", [(16, 4), (100, 8)])
def test_each_shard_launches_one_local_block_kernel_per_leaf(
        monkeypatch, w, s, wire, kernel):
    calls = []
    monkeypatch.setattr(ops, "_on_card", lambda *ts: True)
    monkeypatch.setattr(ops, "_launch", lambda name, out, *args: calls.append(
        (name, args)) or out.zero_())
    ops.reset_launches()
    adj, _, mixed, _ = port_mix(w, s, wire, False, False)
    plan = gossip.worker_shard_plan(adj, s)
    b, k = plan.block, plan.idx.shape[2]
    assert [c[0] for c in calls] == [kernel] * (s * len(LEAVES))
    # per shard, the sorted leaves at the block's shape (W_local = b)
    fs = [int(np.prod(LEAVES[name])) for name in sorted(LEAVES)] * s
    at = 5 if kernel == "gossip_mix_quant" else 4   # after the pointers
    for (_, args), f in zip(calls, fs):
        assert args[at:at + 3] == (b, k, f)
    assert sum(ops.REGIMES.values()) == s * len(LEAVES)
    assert all(v.shape[0] == w for v in mixed.values())
