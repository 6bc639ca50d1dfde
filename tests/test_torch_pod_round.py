"""The port's multi-pod gossip round and cross-pod ring against live JAX.

* The pod round (``engine.build_pod_round``) on the reference pod tests'
  worlds (``test_dts_trust.py``'s ``_pod_setup``: 4 pods on a dense
  topology, one [4, 16] leaf): the loss, geometry, correlation and time
  machine channels, ``start_params``, a compiled scenario, the int8 wire
  with EF21 and secagg, and the ring transport; three rounds each, both
  packages from one initial state on the reference's replayed draws
  (``JaxPodDraws``). Every float field within 1e-4 (the int8 worlds'
  params and EF21 residuals within 1e-6: the two packages' int8 codes
  agree), rounds exact. The reference's ``ValueError``s,
  in its order.
* The ring (``gossip.mix_pytree_ppermute``) against the reference's
  ``mix_pytree_ppermute`` run jitted on a forced 8-device mesh in one JAX
  subprocess: ``test_extensions.py``'s ring world and
  ``test_distributed.py``'s sparse / dense-fallback / int8 / int8 + EF21
  payloads, each with and without secagg, within the reference's own 1e-5
  (int8 within 1e-6, the codes equal); its byte counter equal to
  ``roofline.ppermute_ring_bytes``. The secagg cases run again with pods
  on devices that compare unequal, so receivers derive their own pads.
* The two ring roofline functions against the reference's.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.scenarios as jscen
from repro.config import DeFTAConfig as JDeFTAConfig
from repro.core import engine as jengine
from repro.core.topology import make_topology
from repro.launch import roofline as jroofline
from repro.scenarios.compile import ATTACK_CODE
from test_torch_slice import replay_noise

import repro_torch.scenarios as tscen
from repro_torch.config import DeFTAConfig
from repro_torch.convert import pod_state_from_jax, pod_state_to_numpy
from repro_torch.core import engine, gossip
from repro_torch.core.aggregation import mixing_matrix
from repro_torch.launch import roofline
from repro_torch.rng import RoundDraws
from torch_threads import one_torch_thread  # noqa: F401

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TOL = dict(rtol=1e-4, atol=1e-4)
PODS = 4


class JaxPodDraws:
    """The reference pod round's draws: ``split(pstate.key, 3)`` into key,
    k_sample, k_noise (a fourth, k_wire, on the stochastic int8 wire),
    ``split(k_sample, npods)`` for the Gumbel rows, each random attack
    kind's noise from ``fold_in(k_noise, ATTACK_CODE[kind])`` and the
    wire's uniforms from ``split(k_wire, n_leaves)``."""

    def __init__(self, key, stochastic: bool = False):
        self.key, self.stochastic, self.calls = key, stochastic, 0

    def __call__(self, w, local_epochs, n, noise_shapes, *, kind_noise=None,
                 wire_shapes=None, **unused):
        assert (wire_shapes is not None) == self.stochastic
        assert noise_shapes is None and not unused
        self.calls += 1
        ks = jax.random.split(self.key, 4 if self.stochastic else 3)
        self.key = ks[0]
        gumbel = jax.vmap(lambda k: jax.random.gumbel(k, (w,)))(
            jax.random.split(ks[1], w))
        d = RoundDraws(gumbel=torch.tensor(np.asarray(gumbel)),
                       perm=torch.zeros((w, 0, 0), dtype=torch.long),
                       noise=None)
        if kind_noise is not None:
            d.kind_noise = {k: replay_noise(
                jax.random.fold_in(ks[2], ATTACK_CODE[k]), shapes)
                for k, shapes in kind_noise.items()}
        if wire_shapes is not None:
            names = sorted(wire_shapes)
            keys = jax.random.split(ks[3], len(names))
            d.wire_u = {nm: torch.tensor(np.asarray(jax.random.uniform(
                k, wire_shapes[nm], jnp.float32)))
                for nm, k in zip(names, keys)}
        return d


# Port and reference quantize alike (round half to even on the same f32
# scale), so their int8 codes agree on every element of these worlds: the
# decoded values and the EF21 residuals differ only by f32 rounding. One
# code apart moves a value by a whole step (~1e-2 here), and a residual
# zeroed, sign-flipped or swapped between pods by up to half of one.
INT8_TOL = dict(rtol=0, atol=1e-6)


def pod_fields(ps):
    return {f.name: jax.tree.map(np.asarray, getattr(ps, f.name))
            for f in dataclasses.fields(ps) if f.name != "key"}


def jax_self_eval(stacked):
    return jax.vmap(lambda p: jnp.abs(p["w"]).mean())(stacked)


def port_self_eval(pod_params):
    return torch.stack([p["w"].abs().mean() for p in pod_params])


def pod_world(*, rounds=3, ring=False, start=False, scenario=None,
              poison_round=None, **cfg_kw):
    """``_pod_setup``'s world through both packages for ``rounds`` gossip
    rounds; losses and (with ``start``) start params drawn from numpy.
    Returns [(reference state, params), ...] and the port's, per round."""
    kw = dict(num_workers=PODS, avg_peers=PODS - 1, num_sampled=2,
              topology="dense", use_dts=True, time_machine=False)
    kw.update(cfg_kw)
    jcfg, cfg = JDeFTAConfig(**kw), DeFTAConfig(**kw)
    adj = make_topology("dense", PODS, PODS - 1)
    sizes = np.full(PODS, 8)
    tm = kw["time_machine"]
    jsc = tsc = None
    if scenario is not None:
        vanilla = PODS - jscen.get_scenario(scenario, PODS) \
            .num_appended_attackers()
        jsc = jscen.compile_scenario(jscen.get_scenario(scenario, vanilla),
                                     vanilla, rounds)
        tsc = tscen.compile_scenario(tscen.get_scenario(scenario, vanilla),
                                     vanilla, rounds, device="cpu")
    jtr = jengine.make_transport(jcfg, adjacency=adj)
    jrnd = jax.jit(jengine.build_pod_round(
        jcfg, PODS, sizes, transport=jtr, adj=adj, scenario=jsc,
        self_eval=jax_self_eval if tm else None))
    params = {"w": jax.random.normal(jax.random.PRNGKey(0), (PODS, 16))}
    ef = jengine.uses_error_feedback(jcfg)
    jps = jengine.init_pod_state(jax.random.PRNGKey(1), PODS, params,
                                 wire_error=ef, time_machine=tm,
                                 sketch=jengine.sketch_shape(jcfg))
    devices = ["cpu"] * PODS
    tr = engine.make_transport(cfg, adjacency=adj,
                               pods=devices if ring else None)
    draws = JaxPodDraws(jps.key, tr.stochastic)
    rnd = engine.build_pod_round(cfg, PODS, sizes, transport=tr, adj=adj,
                                 draws=draws, device="cpu", scenario=tsc,
                                 self_eval=port_self_eval if tm else None)
    ps = pod_state_from_jax(pod_fields(jps), devices)
    rng = np.random.default_rng(7)
    jp, tp = params, [{"w": torch.tensor(np.asarray(params["w"][p]))}
                      for p in range(PODS)]
    want, got = [], []
    for r in range(rounds):
        losses = rng.random(PODS).astype(np.float32) + 1.0
        st = None
        if start:
            st = rng.normal(size=(PODS, 16)).astype(np.float32) * 0.5 \
                + np.asarray(jp["w"])
        if poison_round == r:
            bad = np.asarray(jp["w"]).copy()
            bad[3] = 1e8
            jp = {"w": jnp.asarray(bad)}
            tp = [{"w": torch.tensor(bad[p])} for p in range(PODS)]
        jps, jp = jrnd(jps, jp, jnp.asarray(losses),
                       {"w": jnp.asarray(st)} if start else None)
        ps, tp = rnd(ps, tp, torch.tensor(losses),
                     [{"w": torch.tensor(st[p])} for p in range(PODS)]
                     if start else None)
        want.append((pod_fields(jps), np.asarray(jp["w"])))
        got.append((pod_state_to_numpy(ps),
                    np.stack([t["w"].numpy() for t in tp])))
    assert draws.calls == rounds
    np.testing.assert_array_equal(np.asarray(draws.key),
                                  np.asarray(jps.key))
    return want, got, rnd


def assert_rounds_close(want, got, int8=False):
    for r, ((wf, wp), (gf, gp)) in enumerate(zip(want, got)):
        np.testing.assert_allclose(gp, wp, err_msg=f"params r{r}",
                                   **(INT8_TOL if int8 else TOL))
        assert int(gf["round"]) == int(wf["round"]) == r + 1
        for f in ("conf", "last_loss", "best_loss", "sketch"):
            if wf[f] is None:
                assert gf[f] is None, f
                continue
            np.testing.assert_allclose(gf[f], wf[f], err_msg=f"{f} r{r}",
                                       **TOL)
        for f in ("wire_err", "backup"):
            if wf[f] is None:
                assert gf[f] is None, f
                continue
            np.testing.assert_allclose(gf[f]["w"], wf[f]["w"],
                                       err_msg=f"{f} r{r}",
                                       **(INT8_TOL if int8 else TOL))


WORLDS = {
    "loss": dict(),
    "geom": dict(dts_signal="geom"),
    "geom_start": dict(dts_signal="geom", start=True),
    "corr": dict(dts_signal="corr"),
    "all_start_tm": dict(dts_signal="all", start=True, time_machine=True),
    "tm_explosion": dict(time_machine=True, poison_round=1),
    "no_dts": dict(use_dts=False),
    "ring_loss": dict(ring=True),
    "ring_all_start": dict(ring=True, dts_signal="all", start=True),
    "scenario_noise": dict(scenario="paper_noise@1", dts_signal="both",
                           start=True),
    "scenario_signflip": dict(scenario="churn_signflip"),
    "median": dict(aggregation="median", use_dts=False),
    "bf16_ef": dict(gossip_dtype="bf16"),
    "secagg_fp32": dict(secagg="pairwise"),
    "ring_secagg": dict(ring=True, secagg="pairwise"),
}


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_pod_round_matches_jax(world):
    want, got, rnd = pod_world(**WORLDS[world])
    assert_rounds_close(want, got)
    tm = WORLDS[world].get("time_machine", False)
    assert ("damage_check" in engine.stage_names(rnd)) == tm
    if world == "tm_explosion":
        # the poisoned pod's listeners restored their backups
        assert float(np.abs(got[1][1][:3]).max()) < 1e3
        assert float(got[1][0]["conf"].min()) < -100.0


@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("secagg", [None, "pairwise"])
def test_pod_round_int8_ef_matches_jax(ring, secagg):
    want, got, _ = pod_world(ring=ring, gossip_dtype="int8", secagg=secagg,
                             dts_signal="geom", start=True)
    assert_rounds_close(want, got, int8=True)


def test_pod_round_stochastic_int8_matches_jax():
    want, got, _ = pod_world(gossip_dtype="int8",
                             gossip_wire_round="stochastic")
    assert_rounds_close(want, got, int8=True)


ROBUST = ("trimmed_mean", "median", "krum")


def _refusal(pkg, cfg_kw, *, ring=False, scenario_pods=None, tm=False):
    """The first error building the pod transport (robust under a robust
    rule, as ``build_pod_gossip_step`` builds it) and round raises."""
    adj = make_topology("dense", PODS, PODS - 1)
    sizes = np.full(PODS, 8)
    kw = dict(num_workers=PODS, avg_peers=PODS - 1, topology="dense",
              **cfg_kw)
    if pkg == "jax":
        cfg = JDeFTAConfig(**kw)
        mesh = jax.make_mesh((1,), ("pod",)) if ring else None
        sc = None if scenario_pods is None else jscen.compile_scenario(
            jscen.get_scenario("storm", scenario_pods), scenario_pods, 2)
        try:
            tr = jengine.make_transport(cfg, adjacency=adj, mesh=mesh,
                                        robust=cfg.aggregation in ROBUST)
            jengine.build_pod_round(cfg, PODS, sizes, transport=tr,
                                    adj=adj, scenario=sc)
        except ValueError as e:
            return str(e)
        return None
    cfg = DeFTAConfig(**kw)
    sc = None if scenario_pods is None else tscen.compile_scenario(
        tscen.get_scenario("storm", scenario_pods), scenario_pods, 2,
        device="cpu")
    try:
        tr = engine.make_transport(cfg, adjacency=adj,
                                   pods=["cpu"] * PODS if ring else None,
                                   robust=cfg.aggregation in ROBUST)
        engine.build_pod_round(cfg, PODS, sizes, transport=tr, adj=adj,
                               draws=None, device="cpu", scenario=sc)
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("case", [
    dict(cfg_kw=dict(aggregation="median", gossip_dtype="int8")),
    dict(cfg_kw=dict(gossip_dtype="int8", gossip_wire_round="stochastic"),
         ring=True),
    dict(cfg_kw=dict(secagg="pairwise", secagg_mode="masked_geom")),
    dict(cfg_kw=dict(dts_signal="bogus", secagg="pairwise",
                     secagg_mode="masked_geom")),
    dict(cfg_kw=dict(secagg="pairwise", aggregation="krum")),
    dict(cfg_kw=dict(secagg_mode="bogus", gossip_dtype="int8",
                     gossip_wire_round="stochastic"), ring=True),
    dict(cfg_kw=dict(), scenario_pods=3),
    dict(cfg_kw=dict(dts_signal="bogus"), scenario_pods=3),
], ids=lambda c: "-".join(f"{k}={v}" for k, v in c["cfg_kw"].items())
   + ("-ring" if c.get("ring") else "")
   + (f"-scenario{c['scenario_pods']}" if c.get("scenario_pods") else ""))
def test_pod_refusals_are_the_references_in_its_order(case):
    want = _refusal("jax", **case)
    assert want is not None
    assert _refusal("torch", **case) == want


def test_init_pod_state_needs_params():
    with pytest.raises(ValueError, match="params"):
        jengine.init_pod_state(jax.random.PRNGKey(0), 4, None,
                               time_machine=True)
    with pytest.raises(ValueError, match="params"):
        engine.init_pod_state(4, None, time_machine=True, device="cpu")


# ---------------------------------------------------------------------------
# The ring against the reference's mix_pytree_ppermute (8 forced devices)
# ---------------------------------------------------------------------------

RING_CASES = [
    # name, topology (None: the dense fallback), wire, ef, secagg
    ("extensions_ring", "ring", None, False, False),
    ("sparse", "ring_seed0", None, False, False),
    ("dense_fallback", None, None, False, False),
    ("int8", "ring_seed0", "int8", False, False),
    ("int8_ef", "ring_seed0", "int8", True, False),
    ("sparse_secagg", "ring_seed0", None, False, True),
    ("dense_fallback_secagg", None, None, False, True),
    ("int8_secagg", "ring_seed0", "int8", False, True),
    ("int8_ef_secagg", "ring_seed0", "int8", True, True),
    ("bf16_ef_secagg", "ring_seed0", "bf16", True, True),
]


def ring_inputs(topo):
    from repro.core.topology import ring
    w = 8
    adj = None if topo is None else (
        ring(w, 2) if topo == "ring" else make_topology("ring", w, 2, seed=0))
    sizes = np.arange(1, w + 1) * 10
    P = np.asarray(mixing_matrix(adj if adj is not None else
                                 make_topology("ring", w, 2, seed=0),
                                 sizes, "defta"), np.float32)
    stacked = {"a": np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                                 (w, 33))),
               "b": np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                                 (w, 4, 5)))}
    return adj, P, stacked


@pytest.fixture(scope="module")
def jax_ring_outputs(tmp_path_factory):
    """Every ring case through the reference's jitted ``mix_pytree_ppermute``
    on an 8-device mesh, in one subprocess."""
    d = tmp_path_factory.mktemp("ring")
    cases = []
    for name, topo, wire, ef, sec in RING_CASES:
        adj, P, stacked = ring_inputs(topo)
        np.savez(d / f"{name}_in.npz", P=P, adj=adj if adj is not None
                 else np.zeros(0), **stacked)
        cases.append(dict(name=name, wire=wire, ef=ef, sec=sec,
                          dense=adj is None))
    (d / "cases.json").write_text(json.dumps(cases))
    code = f"""
        import json, jax, jax.numpy as jnp, numpy as np
        from repro.core.gossip import mix_pytree_ppermute
        from repro.core import secagg as sa
        d = {str(d)!r}
        mesh = jax.make_mesh((8,), ("pod",))
        for c in json.load(open(d + "/cases.json")):
            z = np.load(d + "/" + c["name"] + "_in.npz")
            stacked = {{"a": jnp.asarray(z["a"]), "b": jnp.asarray(z["b"])}}
            adj = None if c["dense"] else z["adj"]
            res = jax.tree.map(lambda x: jnp.zeros(x.shape, jnp.float32),
                               stacked) if c["ef"] else None
            sec = sa.secagg_base_key(0) if c["sec"] else None
            with mesh:
                f = jax.jit(lambda p, s, r: mix_pytree_ppermute(
                    p, s, mesh, adjacency=adj, wire=c["wire"], residual=r,
                    secagg=sec, secagg_round=3))
                out = f(jnp.asarray(z["P"]), stacked, res)
            mixed, err = out if c["ef"] else (out, None)
            arrs = {{"m_" + k: np.asarray(v) for k, v in mixed.items()}}
            if err is not None:
                arrs.update({{"e_" + k: np.asarray(v)
                             for k, v in err.items()}})
            np.savez(d + "/" + c["name"] + "_out.npz", **arrs)
        print("ok")
    """
    env = dict(os.environ, PYTHONPATH=SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    return {c["name"]: dict(np.load(d / f"{c['name']}_out.npz"))
            for c in cases}


# every case on one device kind, and each secagg case again on pod devices
# that compare unequal (``cpu`` and ``cpu:0``), where the receiver derives
# the pads of each edge between the two kinds on its own device
RING_RUNS = [(c, False) for c in RING_CASES] + \
    [(c, True) for c in RING_CASES if c[4]]


@pytest.mark.parametrize("case,split", RING_RUNS,
                         ids=[c[0] + ("-split_devices" if split else "")
                              for c, split in RING_RUNS])
def test_ring_matches_the_references_ppermute(case, split, jax_ring_outputs,
                                              monkeypatch):
    name, topo, wire, ef, sec = case
    adj, P, stacked = ring_inputs(topo)
    w = P.shape[0]
    devices = [torch.device("cpu") if i % 2 or not split
               else torch.device("cpu", 0) for i in range(w)]
    rows = [{k: torch.tensor(v[i]) for k, v in stacked.items()}
            for i in range(w)]
    res = [{k: torch.zeros(v.shape[1:]) for k, v in stacked.items()}
           for _ in range(w)] if ef else None
    made = []
    edge_pads = gossip._edge_pads
    monkeypatch.setattr(gossip, "_edge_pads", lambda *a: made.append(
        (a[2], a[3], str(a[-1]))) or edge_pads(*a))
    gossip.reset_ring()
    out = gossip.mix_pytree_ppermute(
        torch.tensor(P), rows, devices, adjacency=adj, wire=wire,
        residual=res, secagg=12345 if sec else None, secagg_round=3)
    mixed, err = out if ef else (out, None)
    # secagg: a sender-side pad for every copied edge, and a receiver-side
    # one for every edge whose two ends lie on unequal devices
    _, perm = gossip.ring_schedule(adj, w)
    edges = [e for o, pairs in perm.items() if o for e in pairs]
    cross = [(s, d) for s, d in edges if devices[s] != devices[d]]
    assert bool(cross) == split
    assert sorted(made) == (sorted(
        [(s, d, str(devices[s])) for s, d in edges]
        + [(s, d, str(devices[d])) for s, d in cross]) if sec else [])
    want = jax_ring_outputs[name]
    for k in stacked:
        got = np.stack([m[k].numpy() for m in mixed])
        np.testing.assert_allclose(got, want["m_" + k], err_msg=k,
                                   **(INT8_TOL if wire == "int8" else
                                      dict(rtol=0, atol=1e-5)))
        if ef:
            np.testing.assert_allclose(
                np.stack([e[k].numpy() for e in err]), want["e_" + k],
                rtol=0, atol=1e-6, err_msg=k)
    # the ring moved exactly the roofline's nnz bytes (the dense fallback
    # ships every pair of every offset but 0)
    n_params = sum(int(np.prod(v.shape[1:])) for v in stacked.values())
    support = adj if adj is not None else np.ones((w, w), bool)
    nnz, _ = roofline.ppermute_ring_bytes(n_params, support, wire,
                                          rows=len(stacked))
    assert gossip.RING["bytes"] == nnz
    # and the ring equals the in-process einsum mix of the same payload
    ref = gossip.mix_pytree(torch.tensor(P), {k: torch.tensor(v) for k, v
                                              in stacked.items()}, wire=wire)
    for k in stacked:
        got = np.stack([m[k].numpy() for m in mixed])
        np.testing.assert_allclose(got, ref[k].numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("wire", [None, "bf16", "int8"])
@pytest.mark.parametrize("topo", ["ring", "dense", "erdos"])
def test_ring_roofline_functions_equal_the_references(wire, topo):
    adj = make_topology(topo, 12, 3, seed=1)
    assert roofline.ppermute_ring_bytes(1000, adj, wire, rows=3) == \
        jroofline.ppermute_ring_bytes(1000, adj, wire, rows=3)
    assert roofline.gossip_round_wire_bytes(1000, 12, 3.0, wire, rows=3) \
        == jroofline.gossip_round_wire_bytes(1000, 12, 3.0, wire, rows=3)
