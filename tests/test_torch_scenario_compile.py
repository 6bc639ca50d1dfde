"""The port's scenario compiler against the reference's: the copied
``ScenarioSpec`` grammar, ``compile_scenario``'s arrays (numpy on the host,
tensors on the device), ``epoch_view`` at every epoch and past the
horizon, and the compile errors. Presets, a time-varying topology and
random specs drawn with hypothesis; each spec is built once with each
package's own classes."""
from __future__ import annotations

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.scenarios.spec as jspec
from repro.scenarios.compile import compile_scenario as jcompile
from repro.scenarios.compile import epoch_view as jepoch_view

import repro_torch.scenarios.spec as tspec
from repro_torch.scenarios import compile as tcompile

ARRAYS = ("seg_of_epoch", "alive", "link_ok", "fire", "attack_on",
          "attack_kind", "attack_scale")


def np_of(x):
    return None if x is None else (x.cpu().numpy() if hasattr(x, "cpu")
                                   else np.asarray(x))


def assert_compiled_equal(got, want):
    for name in ARRAYS + ("adj_seg",):
        a, b = np_of(getattr(got, name)), np_of(getattr(want, name))
        if b is None:
            assert a is None, name
            continue
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ("malicious", "alive_np", "link_ok_np", "seg_of_epoch_np",
                 "adj_union", "adj_seg_np"):
        a, b = getattr(got, name), getattr(want, name)
        if b is None:
            assert a is None, name
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.kinds_present == want.kinds_present
    assert (got.num_workers, got.num_vanilla, got.epochs) == \
        (want.num_workers, want.num_vanilla, want.epochs)


def assert_views_equal(got, want):
    for e in range(want.epochs + 1):           # one past the horizon: clamp
        a, b = tcompile.epoch_view(got, e), jepoch_view(want, e)
        assert sorted(a) == sorted(b)
        for k in b:
            if b[k] is None:
                assert a[k] is None, (e, k)
            else:
                np.testing.assert_array_equal(np_of(a[k]), np_of(b[k]),
                                              err_msg=f"epoch {e} {k}")


def both(build, num_vanilla, epochs):
    """Compile ``build(module)`` with each package; returns (port, ref)."""
    return (tcompile.compile_scenario(build(tspec), num_vanilla, epochs,
                                      device="cpu"),
            jcompile(build(jspec), num_vanilla, epochs))


def test_spec_copy_is_verbatim():
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    assert (root / "src/repro_torch/scenarios/spec.py").read_text() == \
        (root / "src/repro/scenarios/spec.py").read_text()
    assert tcompile.ATTACK_CODE == \
        __import__("repro.scenarios.compile", fromlist=["x"]).ATTACK_CODE
    assert tcompile.DEFAULT_SCALE == \
        __import__("repro.scenarios.compile", fromlist=["x"]).DEFAULT_SCALE


@pytest.mark.parametrize("name,num_vanilla", [
    (name, nv) for name in ("paper_noise@40", "paper_noise",
                            "churn_signflip", "storm")
    for nv in (1, 2, 5, 20)
    if not (name == "storm" and nv == 1)])     # storm splits two halves
def test_presets_compile_equal(name, num_vanilla):
    got, want = both(lambda m: m.get_scenario(name, num_vanilla),
                     num_vanilla, 12)
    assert_compiled_equal(got, want)
    assert_views_equal(got, want)


def test_time_varying_topology_compiles_equal():
    def build(m):
        return m.ScenarioSpec(
            attacks=(m.AttackSpec("noise"), m.AttackSpec("alie")),
            churn=(m.ChurnSpec(worker=2, leave=5),),
            topology=m.TopologySpec("random_kout", avg_peers=3, every=3),
            seed=4)
    got, want = both(build, 10, 11)
    assert got.adj_seg is not None and got.num_segments > 3
    assert_compiled_equal(got, want)
    assert_views_equal(got, want)


def test_epoch_view_clamps_past_the_horizon():
    got, _ = both(lambda m: m.get_scenario("storm", 6), 6, 10)
    last = tcompile.epoch_view(got, 9)
    for e in (10, 25, -3):
        v = tcompile.epoch_view(got, e)
        ref = last if e > 0 else tcompile.epoch_view(got, 0)
        for k in ("alive", "link_ok", "fire", "attack_on"):
            assert bool((v[k] == ref[k]).all()), (e, k)


@st.composite
def spec_description(draw):
    """A random scenario as plain data: (num_vanilla, epochs, fields)."""
    nv = draw(st.integers(1, 6))
    epochs = draw(st.integers(1, 14))
    kinds = jspec.ATTACK_KINDS
    attacks = draw(st.lists(st.tuples(
        st.sampled_from(kinds), st.sampled_from([0.0, 0.5, 3.0]),
        st.integers(-1, nv + 1), st.integers(0, 6), st.integers(0, 10),
        st.integers(0, 5), st.integers(0, 3)), max_size=4))
    w_guess = nv + sum(1 for a in attacks if a[2] < 0) + 1
    worker = st.integers(-1, w_guess)
    churn = draw(st.lists(st.tuples(worker, st.integers(0, 6),
                                    st.integers(0, 12)), max_size=3))
    links = draw(st.lists(st.tuples(worker, worker, st.integers(0, 8),
                                    st.integers(0, 12)), max_size=3))
    parts = draw(st.lists(st.tuples(
        st.lists(st.integers(0, w_guess), min_size=1, max_size=3),
        st.lists(st.integers(0, w_guess), min_size=1, max_size=3),
        st.integers(0, 6), st.integers(0, 12)), max_size=2))
    strag = draw(st.lists(st.tuples(worker, st.sampled_from(
        [0.0, 0.25, 0.5, 1.0, 1.5]), st.integers(0, 5), st.integers(0, 12)),
        max_size=3))
    topo = draw(st.one_of(st.none(), st.tuples(
        st.sampled_from(["ring", "random_kout", "erdos", "dense"]),
        st.integers(1, 3), st.integers(0, 4))))
    seed = draw(st.integers(0, 5))
    return nv, epochs, dict(attacks=attacks, churn=churn, links=links,
                            parts=parts, strag=strag, topo=topo, seed=seed)


def build_from(m, d):
    return m.ScenarioSpec(
        attacks=tuple(m.AttackSpec(k, scale=s, worker=wk, start=a, stop=b,
                                   period=p, duty=du)
                      for k, s, wk, a, b, p, du in d["attacks"]),
        churn=tuple(m.ChurnSpec(worker=wk, join=j, leave=lv)
                    for wk, j, lv in d["churn"]),
        links=tuple(m.LinkSpec(src=s, dst=t, start=a, stop=b)
                    for s, t, a, b in d["links"]),
        partitions=tuple(m.PartitionSpec(groups=(tuple(g0), tuple(g1)),
                                         start=a, stop=b)
                         for g0, g1, a, b in d["parts"]),
        stragglers=tuple(m.StragglerSpec(worker=wk, speed=sp, start=a,
                                         stop=b)
                         for wk, sp, a, b in d["strag"]),
        topology=None if d["topo"] is None else m.TopologySpec(
            d["topo"][0], avg_peers=d["topo"][1], every=d["topo"][2]),
        seed=d["seed"])


def compile_or_error(compile_fn, m, nv, epochs, d):
    try:
        return compile_fn(build_from(m, d), nv, epochs), None
    except (ValueError, IndexError) as e:
        return None, (type(e).__name__, str(e))


@settings(max_examples=60, deadline=None)
@given(spec_description())
def test_random_specs_compile_equal_or_fail_alike(desc):
    nv, epochs, d = desc
    got, got_err = compile_or_error(
        lambda s, n, e: tcompile.compile_scenario(s, n, e, device="cpu"),
        tspec, nv, epochs, d)
    want, want_err = compile_or_error(jcompile, jspec, nv, epochs, d)
    assert got_err == want_err
    if want is not None:
        assert_compiled_equal(got, want)
        assert_views_equal(got, want)


@pytest.mark.parametrize("build,match", [
    (lambda m: m.ScenarioSpec(churn=(m.ChurnSpec(worker=1, leave=2),
                                     m.ChurnSpec(worker=1, join=3))),
     "multiple ChurnSpecs"),
    (lambda m: m.ScenarioSpec(stragglers=(m.StragglerSpec(0, 1.5),)),
     "straggler speed"),
    (lambda m: m.ScenarioSpec(attacks=(m.AttackSpec("noise", worker=9),)),
     "attack targets worker 9"),
    (lambda m: m.ScenarioSpec(attacks=(m.AttackSpec("noise", worker=0),
                                       m.AttackSpec("alie", worker=0))),
     "already has an attack"),
    (lambda m: m.ScenarioSpec(links=(m.LinkSpec(src=-1, dst=0, start=0),)),
     "negative indices"),
])
def test_compile_errors_match_the_reference(build, match):
    with pytest.raises(ValueError, match=match):
        jcompile(build(jspec), 3, 5)
    with pytest.raises(ValueError, match=match):
        tcompile.compile_scenario(build(tspec), 3, 5, device="cpu")
    for m, fn in ((jspec, jcompile), (tspec, tcompile.compile_scenario)):
        with pytest.raises(ValueError, match="horizon must be >= 1"):
            fn(m.ScenarioSpec(), 3, 0)
        with pytest.raises(ValueError, match="unknown attack kind"):
            m.AttackSpec("no_such_attack")
        with pytest.raises(ValueError, match="unknown scenario"):
            m.get_scenario("paper_noise_40", 3)
