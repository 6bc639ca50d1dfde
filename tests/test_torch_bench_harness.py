"""The port's benchmark harness (``benchmarks/port_kernel_bench.py``,
``port_bench_guard.py``) against the reference's (``kernel_bench.py``,
``bench_guard.py``) on the CPU.

* ``bench_gossip``'s rows at W = 20: the adjacency, K, nnz, the wire
  bytes and the int8 / fp32 ratio equal what the reference's
  ``sparse_weights`` and ``gossip_wire_bytes`` give on the reference
  bench's adjacency; the mixes agree with the plain product.
* The contract benches: ``bench_superstep`` and ``bench_fedavg_dispatch``
  at 8 epochs, the port's runs started from the reference's state and
  fed its draws (``JaxDraws``, ``JaxFedAvgDraws``), land within 1e-4 of a
  live JAX ``run_defta`` / ``run_fedavg`` at the same key (one
  module-scoped JAX run of each); the scenario, geometry, correlation
  and telemetry benches at 4 epochs show equal chunk counts and equal
  kernel calls a round across their variants.
* The guard: ``port_bench_guard.check`` and the reference's ``check``
  give the same pass or fail on one synthetic payload and on each of its
  mutants.
"""
from __future__ import annotations

import copy
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import test_torch_fedavg as fedavg_helpers
import test_torch_slice as slice_helpers
from repro.config import DeFTAConfig as JDeFTAConfig
from repro.config import TrainConfig as JTrainConfig
from repro.core import engine as jengine
from repro.core import fedavg as jfedavg
from repro.core.defta import run_defta as jrun_defta
from repro.core.gossip import sparse_weights as jsparse_weights
from repro.core.tasks import mlp_task as jmlp_task
from repro.data.synthetic import federated_dataset as jfederated_dataset
from repro.launch.roofline import gossip_wire_bytes as jgossip_wire_bytes

from repro_torch.convert import fedavg_state_from_jax, state_from_jax
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "benchmarks"))
import bench_guard  # noqa: E402
import port_bench_guard  # noqa: E402
import port_kernel_bench as bench  # noqa: E402

EPOCHS = 8


def reference_adjacency(w, density):
    """``kernel_bench.bench_gossip``'s adjacency, as the reference draws
    it."""
    rng = np.random.default_rng(w)
    k_peers = max(1, round(density * w) - 1)
    adj = np.zeros((w, w), bool)
    for i in range(w):
        peers = rng.choice([j for j in range(w) if j != i],
                           size=min(k_peers, w - 1), replace=False)
        adj[i, peers] = True
    return adj


def test_gossip_rows_equal_the_references_accounting():
    rows = bench.gossip_rows(4096, "cpu", widths=(20,), timed=False)
    assert [(r["W"], r["density"]) for r in rows] == \
        [(20, d) for d in (0.05, 0.3, 1.0)]
    for r in rows:
        adj = reference_adjacency(20, r["density"])
        assert (bench.reference_adjacency(20, r["density"]) == adj).all()
        P = (adj | np.eye(20, dtype=bool)).astype(np.float32)
        P /= P.sum(1, keepdims=True)
        idx, _ = jsparse_weights(jnp.asarray(P), adj)
        nnz = int(adj.sum())
        want_mb = {fmt or "fp32": nnz * jgossip_wire_bytes(4096, fmt,
                                                           rows=1) / 1e6
                   for fmt in (None, "bf16", "int8")}
        want_mb["dense_fp32"] = 20 * 19 * jgossip_wire_bytes(4096) / 1e6
        assert (r["K"], r["nnz"]) == (int(idx.shape[1]), nnz)
        assert r["wire_mb"] == want_mb
        assert r["int8_fp32_byte_ratio"] == \
            want_mb["int8"] / want_mb["fp32"]
        assert r["max_err"] <= 1e-5 and r["dense_err"] <= 1e-5
        assert r["quant_kernel_err"] <= 1e-5
        assert r["launches"] == {"dense": {"gossip_mix": 1},
                                 "sparse": {"gossip_mix_sparse": 1},
                                 "quant": {"gossip_mix_quant": 1}}


def _world():
    data = jfederated_dataset("vector", 4, np.random.default_rng(0),
                              n_per_worker=64, alpha=0.5)
    cfg = dict(num_workers=4, avg_peers=2, num_sampled=1, local_epochs=1)
    return data, cfg, dict(learning_rate=0.05, batch_size=32)


@pytest.fixture(scope="module")
def reference_runs():
    """The reference's ``run_defta`` and ``run_fedavg`` of the benches'
    world at PRNGKey(0), EPOCHS epochs, with their initial states."""
    data, cfg, train = _world()
    key = jax.random.PRNGKey(0)
    jcfg, jtrain = JDeFTAConfig(**cfg), JTrainConfig(**train)
    jst, _, _, _ = jrun_defta(key, jmlp_task(32, 10), jcfg, jtrain, data,
                              epochs=EPOCHS)
    jfa = jfedavg.run_fedavg(key, jmlp_task(32, 10), jcfg, jtrain, data,
                             epochs=EPOCHS)
    init = jengine.init_state(key, jmlp_task(32, 10), 4)
    finit = jfedavg.init_state(key, jmlp_task(32, 10), "none")
    return dict(last_loss=np.asarray(jst.last_loss),
                server=jax.tree.map(np.asarray, jfa.server),
                init=init, finit=finit)


def _hooks(ref):
    """Each port run from the reference's initial state and draws."""
    init = ref["init"]
    fields = {f.name: jax.tree.map(np.asarray, getattr(init, f.name))
              for f in dataclasses.fields(init) if f.name != "key"}

    def hooks(kind):
        if kind == "defta":
            return dict(init=state_from_jax(fields, device="cpu"),
                        draws=slice_helpers.JaxDraws(init.key))
        finit = ref["finit"]
        return dict(init=fedavg_state_from_jax(
            fedavg_helpers.jax_fields(finit), "cpu"),
            draws=fedavg_helpers.JaxFedAvgDraws(finit.key))
    return hooks


def test_superstep_bench_equals_the_reference(reference_runs):
    out = bench.bench_superstep(EPOCHS, 2, device="cpu",
                                hooks=_hooks(reference_runs))
    assert (out["dispatches"], out["dispatch_budget"],
            out["dispatches_per_epoch"]) == (4, 4, EPOCHS)
    assert out["max_loss_delta"] == 0.0
    np.testing.assert_allclose(out["final_loss"],
                               reference_runs["last_loss"], rtol=0,
                               atol=1e-4)


def test_fedavg_dispatch_bench_equals_the_reference(reference_runs):
    out = bench.bench_fedavg_dispatch(EPOCHS, device="cpu",
                                      hooks=_hooks(reference_runs))
    assert out["dispatches_fedavg"] == out["dispatches_defta"] == 1
    assert out["acc_fused"] == out["acc_per_epoch"]
    want = reference_runs["server"]
    assert sorted(out["server"]) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(out["server"][k], v, rtol=1e-4,
                                   atol=1e-4, err_msg=k)


@pytest.mark.parametrize("name,variants", [
    ("bench_scenario_overhead", ("static", "scenario")),
    ("bench_geom_trust", ("loss", "geom")),
    ("bench_corr_trust", ("loss", "corr", "all")),
    ("bench_telemetry", ("off", "on"))])
def test_contract_benches_keep_chunk_and_call_parity(name, variants):
    out = getattr(bench, name)(4, device="cpu")
    chunks = {out[f"dispatches_{v}"] for v in variants}
    calls = [out[f"launches_per_round_{v}"] for v in variants]
    assert chunks == {1}
    assert all(c == calls[0] for c in calls) and sum(calls[0].values()) > 0
    entry = name.replace("bench_", "")
    assert port_bench_guard.launch_parity({entry: out},
                                          {entry: variants}) == []


def synthetic_payload():
    """A payload that passes every gate of both guards."""
    calls = {"gossip_mix_sparse": 4.0}
    return dict(
        rows=[dict(W=500, density=0.05, dense_us=20.0, sparse_us=10.0,
                   quant_us=11.0, int8_fp32_byte_ratio=0.25)],
        quant_convergence=dict(rel_delta=0.001, tolerance=0.02),
        fedavg_dispatch=dict(epochs=120, dispatches_fedavg=1,
                             dispatches_defta=1),
        scenario_overhead=dict(ratio=1.05, compile_scenario_s=0.001,
                               dispatches_static=1, dispatches_scenario=1,
                               launches_per_round_static=calls,
                               launches_per_round_scenario=calls),
        geom_trust=dict(ratio=1.1, dispatches_loss=1, dispatches_geom=1,
                        launches_per_round_loss=calls,
                        launches_per_round_geom=calls),
        corr_trust=dict(ratio_corr=1.1, ratio_all=1.2, dispatches_loss=1,
                        dispatches_corr=1, dispatches_all=1,
                        **{f"launches_per_round_{s}": calls
                           for s in ("loss", "corr", "all")}),
        trust_grid=dict(headline_ok=True, accs={"loss": 0.5, "geom": 0.6},
                        alie_headline_ok=True,
                        alie_accs={"loss": 0.4, "corr": 0.6, "all": 0.62}),
        cross_device=dict(dispatch_budget=4,
                          clean=dict(acc=0.7, dispatches=4),
                          attacked={"corr": dict(acc=0.6, dispatches=4),
                                    "all": dict(acc=0.61, dispatches=4)},
                          clean_dense_acc=0.72,
                          dense_alie_accs={"corr": 0.6, "all": 0.62}),
        w_scaling=dict(rows=[dict(W=500, shards=4, ring_bytes_ok=True)],
                       engine=[dict(W=500, shards=4, dispatches=1,
                                    dispatch_budget=1)]),
        privacy=dict(clean_acc=0.7, secagg_acc=0.7, clean_delta=0.0,
                     mask_bytes_ok=True,
                     mask_bytes={"fp32": dict(wire_overhead_bytes=0.0)},
                     dispatch_budget=4,
                     dispatches=dict(clean=4, secagg=4, dp=4),
                     attacked={m: dict(acc=0.6, dispatches=4)
                               for m in ("plain", "edge", "masked_geom")},
                     masked_geom_delta=0.0),
        telemetry=dict(ratio=1.05, probes=12, bytes_per_round=282.0,
                       dispatches_on=1, dispatches_off=1,
                       launches_per_round_off=calls,
                       launches_per_round_on=calls))


def _mutate(payload, mutant):
    p = copy.deepcopy(payload)
    if mutant == "sparse_win_shrunk":
        p["rows"][0]["sparse_us"] = 30.0
    elif mutant == "int8_bytes_above":
        p["rows"][0]["int8_fp32_byte_ratio"] = 0.35
    elif mutant == "fedavg_dispatches":
        p["fedavg_dispatch"]["dispatches_fedavg"] = 2
    elif mutant == "telemetry_ratio":
        p["telemetry"]["ratio"] = 1.2
    elif mutant == "alie_headline_lost":
        p["trust_grid"]["alie_headline_ok"] = False
    return p


@pytest.mark.parametrize("mutant", [
    "none", "sparse_win_shrunk", "int8_bytes_above", "fedavg_dispatches",
    "telemetry_ratio", "alie_headline_lost"])
def test_guard_gives_the_references_verdict(mutant):
    base = synthetic_payload()
    fresh = _mutate(base, mutant)
    want = bench_guard.check(base, fresh, 0.25)
    got = port_bench_guard.check(base, fresh, 0.25)
    assert bool(got) == bool(want) == (mutant != "none")
    assert len(got) == len(want)
