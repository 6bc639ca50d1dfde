"""The port's cross-device participation against the reference, piece by
piece: the compiled world (``scenarios/cross_device.py``, a copy) and the
runner's numpy helpers on the launcher's default world, vacancy, attacks
and hypothesis-drawn specs; the refusals; the confidence decay; the dense
mix's card-side branch at the launcher's cohort (k = 64, the tile regime
on every wire); and the degradation ladder of the round on the CPU (the
``k_min`` identity rows, the decay applied at gather only, absent and
non-firing users' rows unchanged, stamps filled in order). The whole
round against live JAX is ``test_torch_cross_device_slice.py``.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.core.cross_device as jcd
import repro.scenarios.cross_device as jworld
from repro.config import DeFTAConfig as JDeFTAConfig
from repro.config import TrainConfig as JTrainConfig
from repro.core import engine as jengine
from repro.core.tasks import mlp_task as jmlp_task
from repro.data.synthetic import federated_dataset as jfederated_dataset

import repro_torch.core.cross_device as tcd
import repro_torch.scenarios.cross_device as tworld
from repro_torch.config import DeFTAConfig, TrainConfig
from repro_torch.convert import (cross_device_state_from_jax,
                                 cross_device_state_to_numpy)
from repro_torch.core import engine
from repro_torch.core.tasks import mlp_task
from repro_torch.kernels import ops
from repro_torch.rng import TorchDraws
from repro_torch.scenarios.spec import ATTACK_KINDS

ARRAYS = ("part_ix", "filled", "survive", "complete", "adj", "attack_kind",
          "attack_scale", "malicious")
TRAIN = dict(learning_rate=0.05, batch_size=8)
LAUNCHER = dict(attacks=(("label_flip", 0.15), ("alie", 0.14)))


def assert_worlds_equal(a, b):
    for name in ARRAYS:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert a.kinds_present == b.kinds_present
    assert (a.name, a.enrolled, a.sample_k, a.k_min, a.epochs) == \
        (b.name, b.enrolled, b.sample_k, b.k_min, b.epochs)
    assert a.summary() == b.summary()


@pytest.mark.parametrize("change,epochs", [
    ({}, 3),                                   # the launcher's default
    (LAUNCHER, 3),                             # its attacked example
    (dict(enrolled=40, sample_k=16, availability=0.3, k_min=2,
          attacks=(("sign_flip", 0.1), ("noise", 0.05)),
          attack_scale=2.5, seed=4), 9),       # vacancy, scale given
    (dict(enrolled=12, sample_k=12, avg_peers=0, dropout=0.0,
          straggle=0.0, availability=1.0), 2),  # no links, everyone
])
def test_compile_world_copy_equal(change, epochs):
    a = tworld.compile_world(tworld.CrossDeviceSpec(**change), epochs)
    b = jworld.compile_world(jworld.CrossDeviceSpec(**change), epochs)
    assert_worlds_equal(a, b)
    if change.get("availability") == 0.3:
        assert not a.filled.all()              # vacancies were padded


@st.composite
def spec_description(draw):
    enrolled = draw(st.integers(1, 60))
    n_att = draw(st.integers(0, 3))
    attacks = tuple(
        (draw(st.sampled_from(ATTACK_KINDS)),
         draw(st.sampled_from([0.0, 0.05, 0.2, 0.4])))
        for _ in range(n_att))
    return dict(
        enrolled=enrolled, sample_k=draw(st.integers(1, enrolled + 2)),
        k_min=draw(st.integers(1, 3)), avg_peers=draw(st.integers(0, 5)),
        availability=draw(st.sampled_from([0.0, 0.1, 0.5, 0.7, 1.0])),
        dropout=draw(st.sampled_from([0.0, 0.05, 0.5])),
        straggle=draw(st.sampled_from([0.0, 0.1, 0.5])),
        attacks=attacks, attack_scale=draw(st.sampled_from([0.0, 2.5])),
        seed=draw(st.integers(0, 5))), draw(st.integers(0, 6))


@settings(max_examples=30, deadline=None)
@given(spec_description())
def test_random_specs_compile_like_the_reference(desc):
    """Either both packages refuse the spec (or the horizon) with the same
    ValueError, or they compile equal worlds."""
    kw, epochs = desc
    results = []
    for mod in (tworld, jworld):
        try:
            results.append(mod.compile_world(mod.CrossDeviceSpec(**kw),
                                             epochs))
        except ValueError as e:
            results.append(str(e))
    a, b = results
    if isinstance(b, str):
        assert a == b
    else:
        assert_worlds_equal(a, b)


@pytest.mark.parametrize("kw,match", [
    (dict(enrolled=4, sample_k=8), "exceeds"),
    (dict(availability=0.0), "availability"),
    (dict(attacks=(("nonesuch", 0.1),)), "unknown attack kind"),
    (dict(attacks=(("noise", 1.0),)), "out of"),
    (dict(attacks=(("noise", 0.6), ("alie", 0.5))), "nobody honest"),
])
def test_spec_value_errors_match_the_reference(kw, match):
    for mod in (tworld, jworld):
        with pytest.raises(ValueError, match=match):
            mod.CrossDeviceSpec(**kw)
    for mod in (tworld, jworld):
        with pytest.raises(ValueError, match="epochs > 0"):
            mod.compile_world(mod.CrossDeviceSpec(enrolled=4, sample_k=2), 0)


@pytest.mark.parametrize("probe,seed", [(32, 0), (5, 3), (500, 1)])
def test_resolve_world_and_probe_indices_equal(probe, seed):
    spec = dict(enrolled=60, sample_k=8, attacks=(("alie", 0.3),), seed=2)
    a = tcd.resolve_world(tworld.CrossDeviceSpec(**spec), 4)
    b = jcd.resolve_world(jworld.CrossDeviceSpec(**spec), 4)
    assert_worlds_equal(a, b)
    assert tcd.resolve_world(a, 3) is a
    pa, pb = tcd.probe_indices(a, probe, seed), jcd.probe_indices(b, probe,
                                                                  seed)
    assert pa.dtype == pb.dtype
    np.testing.assert_array_equal(pa, pb)
    assert not a.malicious[pa].any()
    for mod, w in ((tcd, a), (jcd, b)):
        with pytest.raises(ValueError, match="compiled for 4 rounds"):
            mod.resolve_world(w, 5)
        with pytest.raises(TypeError, match="CrossDeviceSpec"):
            mod.resolve_world(object(), 4)
        with pytest.raises(ValueError, match="no honest users"):
            mod.probe_indices(dataclasses.replace(
                w, malicious=np.ones_like(w.malicious)), 4)


@pytest.mark.parametrize("decay", [0.98, 0.9, 0.5])
def test_confidence_decay_matches_the_reference(decay):
    """float32(decay) ** gap with gap in float32, at every gap up to the
    120-round horizon of the cross-device benchmark: within one ulp of
    ``jnp.power``."""
    gap = np.arange(0, 121, dtype=np.float32)
    got = torch.tensor(decay, dtype=torch.float32).pow(
        torch.tensor(gap)).numpy()
    want = np.asarray(jnp.power(jnp.float32(decay), jnp.asarray(gap)))
    assert got.dtype == np.float32
    np.testing.assert_array_max_ulp(got, want, maxulp=1)


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------

def small_world(enrolled=12):
    return jfederated_dataset("vector", enrolled, np.random.default_rng(3),
                              n_per_worker=24, dim=8, num_classes=4)


def run_pkg(pkg, data, cfg_kw, spec_kw, epochs=2, **kw):
    cfg_kw = dict(dict(num_workers=12, avg_peers=2, num_sampled=2,
                       local_epochs=1), **cfg_kw)
    spec_kw = dict(dict(enrolled=12, sample_k=4), **spec_kw)
    if pkg == "jax":
        return jcd.run_cross_device(
            jax.random.PRNGKey(0), jmlp_task(8, 4, hidden=16),
            JDeFTAConfig(**cfg_kw), JTrainConfig(**TRAIN), data,
            world=kw.pop("world", None) or jworld.CrossDeviceSpec(**spec_kw),
            epochs=epochs, **kw)
    return tcd.run_cross_device(
        0, mlp_task(8, 4, hidden=16), DeFTAConfig(**cfg_kw),
        TrainConfig(**TRAIN), data,
        world=kw.pop("world", None) or tworld.CrossDeviceSpec(**spec_kw),
        epochs=epochs, device="cpu", **kw)


@pytest.mark.parametrize("case", ["robust", "short_world", "mismatched_n",
                                  "zero_rounds", "label_flip_no_classes"])
def test_refusals_raise_the_references_exception(case):
    data = small_world()
    for pkg, mod in (("jax", jworld), ("torch", tworld)):
        if case == "robust":
            call = lambda: run_pkg(pkg, data,  # noqa: E731
                                   dict(aggregation="krum"), {})
            match = "robust aggregation"
        elif case == "short_world":
            w = mod.compile_world(mod.CrossDeviceSpec(enrolled=12,
                                                      sample_k=4), 2)
            call = lambda: run_pkg(pkg, data, {}, {}, epochs=3,  # noqa
                                   world=w)
            match = "compiled for 2 rounds"
        elif case == "mismatched_n":
            call = lambda: run_pkg(pkg, small_world(10), {}, {})  # noqa
            match = "sharded over 10 users"
        else:
            w = mod.compile_world(mod.CrossDeviceSpec(
                enrolled=12, sample_k=4, attacks=(("label_flip", 0.2),)), 2)
            if case == "zero_rounds":
                w = dataclasses.replace(w, epochs=0)
                match, classes = "0 rounds", 4
            else:
                match, classes = "num_classes > 0", 0
            if pkg == "jax":
                call = lambda: jengine.build_cross_device_round(  # noqa
                    jmlp_task(8, 4, hidden=16), JDeFTAConfig(num_workers=12),
                    JTrainConfig(**TRAIN), w, data["sizes"],
                    num_classes=classes)
            else:
                call = lambda: engine.build_cross_device_round(  # noqa
                    mlp_task(8, 4, hidden=16), DeFTAConfig(num_workers=12),
                    TrainConfig(**TRAIN), w, data["sizes"], draws=None,
                    device="cpu", num_classes=classes)
        with pytest.raises(ValueError, match=match):
            call()


@pytest.mark.parametrize("change,kw,item", [
    (dict(secagg="pairwise"), {}, "item 5: privacy wire"),
    (dict(dp_sigma=0.5), {}, "item 5: privacy wire"),
    (dict(dp_clip=1.0), {}, "item 5: privacy wire"),
    ({}, dict(shards=2), "item 7: multi-device transports"),
])
def test_unported_parts_name_their_item(change, kw, item):
    """The privacy wire (item 5) and the sharded enrolled axis (item 7)
    are ported: their worlds run a round (the sharded one equal to the
    unsharded run bit for bit, ``test_torch_shard_slice`` holds it against
    the reference)."""
    engine.check_supported(DeFTAConfig(**change))
    st, _ = run_pkg("torch", small_world(), change, {}, **kw)
    assert bool(torch.isfinite(st.conf).all())
    if kw:
        one, _ = run_pkg("torch", small_world(), change, {})
        assert torch.equal(one.conf, st.conf)
        assert all(torch.equal(one.params[k], st.params[k])
                   for k in one.params)


def test_telemetry_names_its_item():
    """Telemetry (item 6) is ported: the round builds with a registry and
    returns, beside the state, a frame that carries ``cross_device_specs``
    in declaration order, with the round stamp and the world's cohort."""
    from repro_torch.core.defta import to_device_data
    from repro_torch.telemetry import Telemetry, cross_device_specs
    w = tworld.compile_world(tworld.CrossDeviceSpec(enrolled=12,
                                                    sample_k=4), 2)
    reg = Telemetry()
    gen = torch.Generator()
    gen.manual_seed(0)
    rnd = engine.build_cross_device_round(
        mlp_task(8, 4, hidden=16), DeFTAConfig(num_workers=12),
        TrainConfig(**TRAIN), w, np.full(12, 24), draws=TorchDraws(gen),
        device="cpu", num_classes=4, telemetry=reg)
    assert rnd.telemetry is reg and reg.specs == cross_device_specs(4)
    st = engine.init_cross_device_state(gen, mlp_task(8, 4, hidden=16), 12)
    st, frame = rnd(st, to_device_data(small_world(), "cpu"), 1)
    assert list(frame) == [s.name for s in cross_device_specs(4)]
    for s in cross_device_specs(4):
        assert tuple(frame[s.name].shape) == s.shape, s.name
    assert int(frame["round"]) == 1
    np.testing.assert_array_equal(frame["cohort"].numpy(), w.part_ix[1])
    assert int(frame["scatter_writes"]) == int(frame["fire"].sum())
    assert st.epoch.sum() == frame["scatter_writes"]


def test_run_cross_device_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcd.run_cross_device(0, mlp_task(8, 4, hidden=16),
                             DeFTAConfig(num_workers=12),
                             TrainConfig(**TRAIN), small_world(),
                             world=tworld.CrossDeviceSpec(enrolled=12,
                                                          sample_k=4),
                             epochs=1)


# ---------------------------------------------------------------------------
# The dense mix's card-side branch at the launcher's cohort
# ---------------------------------------------------------------------------

TILE_SMEM = {torch.float32: 3 * (128 * 36 * 4 + 32 * 72 * 4),
             torch.bfloat16: 3 * (128 * 36 * 4 + 32 * 72 * 2),
             torch.int8: 3 * (128 * 36 * 4 + 32 * 80)}


@pytest.mark.parametrize("wire,dtype", [("float32", torch.float32),
                                        ("bf16", torch.bfloat16),
                                        ("int8", torch.int8)])
def test_cohort_round_launches_the_tile_regime(monkeypatch, wire, dtype):
    """One round of a k = 64 cohort (mlp_task(32, 10): leaves of F = 64,
    10, 2048 and 640) on ``auto`` with the launch stubbed: the cohort has
    no static support, so each leaf is one dense mix in the tile regime
    (W = 64 > ``GOSSIP_STREAM_MAX_W``), with W, F, the payload's dtype
    code, the tile's shared memory and P rows aligned; nothing else of the
    gossip family launches."""
    calls = []
    monkeypatch.setattr(ops, "_on_card", lambda *ts: True)
    monkeypatch.setattr(ops, "_launch", lambda name, out, *args: calls.append(
        (name, args)) or out.zero_())
    ops.reset_launches()
    enrolled, k = 80, 64
    data = jfederated_dataset("vector", enrolled, np.random.default_rng(0),
                              n_per_worker=16)
    cfg = DeFTAConfig(num_workers=enrolled, num_sampled=2, local_epochs=1,
                      gossip_dtype=wire, dts_signal="all")
    world = tworld.compile_world(tworld.CrossDeviceSpec(
        enrolled=enrolled, sample_k=k, availability=1.0), 1)
    gen = torch.Generator()
    gen.manual_seed(0)
    st, _ = tcd.run_cross_device(0, mlp_task(32, 10), cfg,
                                 TrainConfig(batch_size=16), data,
                                 world=world, epochs=1, device="cpu",
                                 draws=TorchDraws(gen))
    assert [c[0] for c in calls] == ["gossip_mix"] * 4
    assert ops.REGIMES == {"gossip_mix/tile": 4}
    size = torch.empty((), dtype=dtype).element_size()
    for (_, args), f in zip(calls, (64, 10, 2048, 640)):   # sorted leaves
        flags = (ops.W_ROWS16 * (f * size % 16 == 0)
                 | ops.OUT_ROWS16 * (f % 4 == 0) | ops.P_ROWS16)
        assert args[3:] == (k, f, ops._DTYPE_CODE[dtype], 1, 0, flags,
                            TILE_SMEM[dtype])              # tile regime
    assert int(st.epoch.sum()) > 0


# ---------------------------------------------------------------------------
# The degradation ladder, on the port alone
# ---------------------------------------------------------------------------

def build_round(enrolled=8, k=3, *, cfg_kw=None, spec_kw=None, epochs=6):
    data = small_world(enrolled)
    cfg = DeFTAConfig(**dict(dict(num_workers=enrolled, avg_peers=2,
                                  num_sampled=2, local_epochs=1),
                             **(cfg_kw or {})))
    world = tworld.compile_world(tworld.CrossDeviceSpec(
        **dict(dict(enrolled=enrolled, sample_k=k, avg_peers=2, seed=1),
               **(spec_kw or {}))), epochs)
    gen = torch.Generator()
    gen.manual_seed(0)
    rnd = engine.build_cross_device_round(
        mlp_task(8, 4, hidden=16), cfg, TrainConfig(**TRAIN), world,
        data["sizes"], draws=TorchDraws(gen), device="cpu", num_classes=4)
    state = engine.init_cross_device_state(
        gen, mlp_task(8, 4, hidden=16), enrolled,
        wire_error=cfg.gossip_dtype != "float32",
        sketch=engine.sketch_shape(cfg))
    tdata = {kk: torch.as_tensor(data[kk]) for kk in ("x", "y", "mask")}
    return world, rnd, state, tdata


def stages_until(rnd, state, data, t, last):
    c = {"state": state, "data": data, "epoch": t}
    for name, fn in rnd.stages:
        fn(c)
        if name == last:
            return c
    raise AssertionError(last)


def test_stage_names_and_contract_docs():
    _, rnd, _, _ = build_round()
    assert engine.stage_names(rnd) == (
        "participation", "split_draws", "peer_sample", "transport",
        "damage_check", "local_train", "attack_inject", "trust_update",
        "scatter_merge")
    for name, fn in rnd.stages:
        assert "reads" in fn.__doc__ and "writes" in fn.__doc__, name


def test_k_min_shortfall_degrades_to_identity_mixing():
    _, rnd, state, data = build_round(spec_kw=dict(
        k_min=3, avg_peers=1, dropout=0.0, straggle=0.0, availability=1.0))
    c = stages_until(rnd, state, data, 0, "transport")
    np.testing.assert_array_equal(c["P"].numpy(), np.eye(3))
    for name, x in c["g_params"].items():       # identity rows: exact
        torch.testing.assert_close(c["agg"][name], x, rtol=0, atol=0)


def test_decay_applies_at_gather_only():
    decay, t = 0.5, 4
    _, rnd, state, data = build_round(
        cfg_kw=dict(dts_conf_decay=decay),
        spec_kw=dict(availability=1.0, dropout=0.0, straggle=0.0))
    state.conf.fill_(2.0)
    c = stages_until(rnd, state, data, t, "participation")
    np.testing.assert_allclose(c["g_conf_rows"].numpy(), 2.0 * decay ** t,
                               rtol=1e-6)
    np.testing.assert_array_equal(c["g_conf_raw"].numpy(),
                                  np.full((3, 8), 2.0))
    np.testing.assert_array_equal(c["conf"].numpy(),
                                  np.full((3, 3), 2.0 * decay ** t))


def test_rows_of_users_who_do_not_fire_are_unchanged():
    """Over a run with vacancy, dropout and stragglers, every row of a
    user who never fired is bit-equal to its initial row (params, backup,
    residuals, conf, sketch, stamps, losses, counters), each user's epoch
    and obs count its fired rounds, its last_part is its last fired
    round, and its stamps hold exactly the rounds it fired, in order."""
    enrolled, rounds = 12, 6
    world, rnd, state, data = build_round(
        enrolled, 3, epochs=rounds,
        cfg_kw=dict(dts_signal="all", gossip_dtype="int8",
                    dts_conf_decay=0.9),
        spec_kw=dict(availability=0.5, dropout=0.2, straggle=0.2,
                     attacks=(("label_flip", 0.25),), seed=5))
    init = cross_device_state_to_numpy(state)
    for t in range(rounds):
        state = rnd(state, data, t)
    got = cross_device_state_to_numpy(state)
    fire = world.filled & world.survive & world.complete
    fired = {u: [t for t in range(rounds)
                 if u in world.part_ix[t][fire[t]]] for u in range(enrolled)}
    never = np.array([u for u in range(enrolled) if not fired[u]])
    assert never.size and len(never) < enrolled
    for f, v in init.items():
        for a, b in ([(v[n], got[f][n]) for n in v] if isinstance(v, dict)
                     else [(v, got[f])]):
            np.testing.assert_array_equal(b[never], a[never], err_msg=f)
    for u, ts in fired.items():
        assert got["epoch"][u] == got["obs"][u] == len(ts)
        assert got["last_part"][u] == (ts[-1] if ts else 0)
        stamps = got["sketch_round"][u]
        want = [-1] * (len(stamps) - len(ts)) + ts[-len(stamps):]
        assert stamps.tolist() == want


def test_cross_device_state_converters_carry_every_field():
    jcfg = JDeFTAConfig(num_workers=10, dts_signal="corr",
                        gossip_dtype="int8")
    init = jengine.init_cross_device_state(
        jax.random.PRNGKey(1), jmlp_task(8, 4, hidden=16), 10,
        wire_error=True, sketch=jengine.sketch_shape(jcfg))
    fields = {f.name: jax.tree.map(np.asarray, getattr(init, f.name))
              for f in dataclasses.fields(init) if f.name != "key"}
    rng = np.random.default_rng(0)
    fields["sketch_round"] = rng.integers(-1, 9, (10, 8)).astype(np.int32)
    fields["obs"] = rng.integers(0, 5, 10).astype(np.int32)
    st = cross_device_state_from_jax(fields, device="cpu")
    assert st.sketch_round.dtype == torch.int32
    back = cross_device_state_to_numpy(st)
    assert sorted(back) == sorted(fields)
    for f, v in fields.items():
        if isinstance(v, dict):
            for n in v:
                np.testing.assert_array_equal(back[f][n], v[n])
        else:
            assert back[f].dtype == v.dtype, f
            np.testing.assert_array_equal(back[f], v, err_msg=f)
    cfg = DeFTAConfig(num_workers=12, dts_signal="corr")
    bad = cross_device_state_from_jax(
        dict(fields, sketch_round=None, wire_err=None), device="cpu")
    with pytest.raises(ValueError, match="init state does not fit"):
        tcd.run_cross_device(0, mlp_task(8, 4, hidden=16), cfg,
                             TrainConfig(**TRAIN), small_world(10),
                             world=tworld.CrossDeviceSpec(enrolled=10,
                                                          sample_k=4),
                             epochs=1, device="cpu", init=bad)
