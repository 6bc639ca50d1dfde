"""The port's copies of the reference's numpy-only modules stay equal to the
originals, its configs (run configs, model config classes, ``reduced`` and
the architecture files) keep the reference's fields, defaults and values,
and the port stands alone: it imports neither ``jax`` nor any ``repro``
module and runs on the CPU only when asked to."""
from __future__ import annotations

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.config as jconfig
import repro.configs as jconfigs
from repro.core import aggregation as jaggregation
from repro.core import topology as jtopology
from repro.data import partition as jpartition
from repro.data import synthetic as jsynthetic
from repro.telemetry.ledger import RunLedger as JRunLedger

from repro_torch import config, configs, device as tdevice
from repro_torch.core import aggregation, topology
from repro_torch.data import partition, synthetic
from repro_torch.telemetry import RunLedger

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("kind", ["ring", "dense", "random_kout", "erdos"])
@pytest.mark.parametrize("n,peers", [(5, 2), (22, 4)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_topology_copy_equal(kind, n, peers, seed):
    a = topology.make_topology(kind, n, peers, seed)
    b = jtopology.make_topology(kind, n, peers, seed)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(topology.outdegrees(a),
                                  jtopology.outdegrees(b))
    assert topology.is_strongly_connected(a) == \
        jtopology.is_strongly_connected(b)


def test_aggregation_copy_is_verbatim():
    ours = (ROOT / "src" / "repro_torch" / "core" / "aggregation.py")
    theirs = (ROOT / "src" / "repro" / "core" / "aggregation.py")
    assert ours.read_text() == theirs.read_text()


@pytest.mark.parametrize("path", ["scenarios/spec.py",
                                  "core/peer_selection.py"])
def test_numpy_module_copy_is_verbatim(path):
    ours = ROOT / "src" / "repro_torch" / path
    theirs = ROOT / "src" / "repro" / path
    assert ours.read_text() == theirs.read_text()


@pytest.mark.parametrize("k,explore", [(2, 0.0), (3, 0.5)])
def test_peer_selection_copy_equal(k, explore):
    from repro.core import peer_selection as jps

    from repro_torch.core import peer_selection as ps
    rng = np.random.default_rng(k)
    y = rng.integers(0, 10, (9, 40))
    mask = (rng.random((9, 40)) < 0.8).astype(np.float32)
    a = ps.label_histograms(y, mask, 10)
    np.testing.assert_array_equal(a, jps.label_histograms(y, mask, 10))
    np.testing.assert_array_equal(
        ps.similarity_topology(a, k, np.random.default_rng(1), explore),
        jps.similarity_topology(a, k, np.random.default_rng(1), explore))


@pytest.mark.parametrize("kind,n,peers", [("ring", 5, 2),
                                          ("random_kout", 8, 3),
                                          ("random_kout", 22, 4),
                                          ("erdos", 12, 4)])
@pytest.mark.parametrize("scheme", ["defta", "defl", "uniform"])
def test_aggregation_copy_equal(kind, n, peers, scheme):
    rng = np.random.default_rng(n)
    adj = topology.make_topology(kind, n, peers, 0)
    sizes = rng.integers(20, 200, n)
    sampled = rng.random((n, n)) < 0.5
    for name, args in (("mixing_matrix", (adj, sizes, scheme)),
                       ("sampled_mixing_matrix",
                        (adj, sizes, sampled, scheme)),
                       ("aggregation_bias", (adj, sizes, scheme)),
                       ("theorem_3_3_residual", (adj, sizes, scheme))):
        np.testing.assert_array_equal(getattr(aggregation, name)(*args),
                                      getattr(jaggregation, name)(*args),
                                      err_msg=name)
    P = aggregation.mixing_matrix(adj, sizes, scheme)
    np.testing.assert_array_equal(aggregation.stationary(P),
                                  jaggregation.stationary(P))
    np.testing.assert_array_equal(aggregation.fedavg_pi(sizes),
                                  jaggregation.fedavg_pi(sizes))


@pytest.mark.parametrize("kind,kw", [("vector", {}), ("image", {"hw": 10}),
                                     ("lm", {})])
@pytest.mark.parametrize("seed", [0, 3])
def test_federated_dataset_copy_equal(kind, kw, seed):
    a = synthetic.federated_dataset(kind, 6, np.random.default_rng(seed),
                                    n_per_worker=40, **kw)
    b = jsynthetic.federated_dataset(kind, 6, np.random.default_rng(seed),
                                     n_per_worker=40, **kw)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dirichlet_partition_copy_equal(seed):
    labels = np.random.default_rng(seed).integers(0, 10, 300)
    for workers, alpha in ((5, 0.5), (60, 0.1)):    # the second tops up
        a = partition.dirichlet_partition(labels, workers, alpha,
                                          np.random.default_rng(seed))
        b = jpartition.dirichlet_partition(labels, workers, alpha,
                                           np.random.default_rng(seed))
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_run_ledger_copy_equal():
    a, b = RunLedger(), JRunLedger()
    for led in (a, b):
        led.record_dispatch(3, 0.5)
        led.record_dispatch(2, 0.25)
        led.finish("epochs", 5)
    assert a.as_stats() == b.as_stats() == {"dispatches": 2, "epochs": 5}
    assert a.wall_s == b.wall_s and a.superstep_s == b.superstep_s
    assert a.rounds_done == b.rounds_done == 5


@pytest.mark.parametrize("name", ["DeFTAConfig", "TrainConfig", "MoEConfig",
                                  "SSMConfig", "ModelConfig"])
def test_config_fields_and_defaults_equal(name):
    ours = dataclasses.fields(getattr(config, name))
    theirs = dataclasses.fields(getattr(jconfig, name))
    assert [(f.name, f.default) for f in ours] == \
        [(f.name, f.default) for f in theirs]


def test_block_kinds_equal():
    for kind in ("ATTN_DENSE", "ATTN_MOE", "MAMBA", "MAMBA_MOE"):
        assert getattr(config, kind) == getattr(jconfig, kind)


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_arch_configs_equal(arch):
    """Each architecture file is the reference's with only its import
    redirected; the configs, their reduced variants, schedules and
    parameter counts are equal."""
    name = jconfigs._modname(arch) + ".py"
    ours = (ROOT / "src" / "repro_torch" / "configs" / name).read_text()
    theirs = (ROOT / "src" / "repro" / "configs" / name).read_text()
    assert ours == theirs.replace("from repro.config import",
                                  "from repro_torch.config import")
    a, b = configs.get_config(arch), jconfigs.get_config(arch)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    for kw in ({}, {"num_layers": 3, "d_model": 128, "max_experts": 8}):
        ra, rb = config.reduced(a, **kw), jconfig.reduced(b, **kw)
        assert dataclasses.asdict(ra) == dataclasses.asdict(rb)
        assert ra.block_schedule() == rb.block_schedule()
    assert a.block_schedule() == b.block_schedule()
    assert a.param_count() == b.param_count()
    assert a.param_count(active_only=True) == \
        b.param_count(active_only=True)


def test_arch_registry_equal():
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    assert configs.get_config("qwen2-5-32b") == \
        configs.get_config("qwen2.5-32b")
    with pytest.raises(KeyError):
        configs.get_config("no-such-arch")


def test_port_runs_without_jax_or_repro():
    """A fresh interpreter imports the port, runs a tiny CPU run_defta and
    serves a reduced DeepSeekMoE on the CPU; neither jax nor any repro
    module may be loaded afterwards."""
    code = """
import sys
import numpy as np
from repro_torch.config import DeFTAConfig, TrainConfig
from repro_torch.core.defta import run_defta
from repro_torch.core.tasks import mlp_task
from repro_torch.data import federated_dataset
data = federated_dataset("vector", 4, np.random.default_rng(0),
                         n_per_worker=32)
cfg = DeFTAConfig(num_workers=4, avg_peers=2, num_sampled=1,
                  local_epochs=1, gossip_dtype="int8")
st, *_ = run_defta(0, mlp_task(32, 10), cfg, TrainConfig(batch_size=16),
                   data, epochs=2, num_malicious=1, device="cpu")
assert st.epoch.tolist() == [2] * 5
from repro_torch.core import run_async_defta, run_fedavg
st, _ = run_fedavg(0, mlp_task(32, 10), cfg, TrainConfig(batch_size=16),
                   data, epochs=2, num_malicious=1, sample_workers=2,
                   server_opt="fedadam", device="cpu")
assert st.server["w1"].shape == (32, 64)
st, *_ = run_async_defta(0, mlp_task(32, 10), cfg,
                         TrainConfig(batch_size=16), data, ticks=3,
                         num_malicious=1, device="cpu")
assert int(st.epoch.max()) <= 3
import dataclasses
from repro_torch.scenarios import attacks, robust_agg, compile
st, *_ = run_defta(0, mlp_task(32, 10), cfg, TrainConfig(batch_size=16),
                   data, epochs=3, scenario="storm", device="cpu")
assert st.epoch.tolist()[2:] == [3] * 5
st, *_ = run_defta(0, mlp_task(32, 10), dataclasses.replace(
                       cfg, gossip_dtype="float32", aggregation="krum"),
                   TrainConfig(batch_size=16), data, epochs=2,
                   scenario="paper_noise@2", device="cpu")
import importlib.util
spec = importlib.util.spec_from_file_location(
    "port_table3", "benchmarks/port_table3.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
from repro_torch.launch import serve
tokens, _ = serve.main(["--arch", "deepseek-moe-16b", "--smoke", "--device",
                        "cpu", "--batch", "2", "--prompt-len", "4",
                        "--max-new", "3"])
assert tuple(tokens.shape) == (2, 3)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
print("LOADED", bad)
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_port_sources_import_no_jax_or_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
        + [ROOT / "chip_smoke.py"] \
        + sorted((ROOT / "benchmarks").glob("port_*.py")) \
        + sorted((ROOT / "examples").glob("port_*.py"))
    pattern = re.compile(r"^\s*(import\s+(jax|repro)\b(?!_)"
                         r"|from\s+(jax|repro)(\.|\s))", re.M)
    hits = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}" for f in files
            for m in pattern.finditer(f.read_text())]
    assert len(files) > 15 and ROOT / "benchmarks" / "port_table4.py" in files
    for f in ("benchmarks/port_table3.py", "src/repro_torch/scenarios/"
              "compile.py", "src/repro_torch/scenarios/attacks.py",
              "src/repro_torch/scenarios/robust_agg.py",
              "benchmarks/port_table_trust.py",
              "benchmarks/port_bias_analysis.py",
              "examples/port_quickstart.py", "examples/port_serve_decode.py",
              "examples/port_robustness_demo.py"):
        assert ROOT / f in files, f
    assert hits == []


def test_entry_points_default_to_the_card(monkeypatch):
    """device=None means CUDA; with no CUDA it raises instead of falling
    back to the CPU."""
    from repro_torch.core.defta import run_defta
    from repro_torch.core.tasks import mlp_task
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdevice.resolve_device(None)
    data = synthetic.federated_dataset("vector", 4,
                                       np.random.default_rng(0),
                                       n_per_worker=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_defta(0, mlp_task(32, 10), config.DeFTAConfig(num_workers=4),
                  config.TrainConfig(), data, epochs=1)
    from repro_torch.core import run_async_defta, run_fedavg
    with pytest.raises(RuntimeError, match="CUDA"):
        run_fedavg(0, mlp_task(32, 10), config.DeFTAConfig(num_workers=4),
                   config.TrainConfig(), data, epochs=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_async_defta(0, mlp_task(32, 10),
                        config.DeFTAConfig(num_workers=4),
                        config.TrainConfig(), data, ticks=1)
    assert tdevice.resolve_device("cpu") == torch.device("cpu")
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "deepseek-moe-16b", "--smoke"])
    from repro_torch.configs import get_config
    from repro_torch.models import model
    cfg = config.reduced(get_config("deepseek-moe-16b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_cache(cfg, 1, 4)
    assert model.init_cache(cfg, 1, 4, device="cpu")["prefix"]["0"][
        "k"].device == torch.device("cpu")
