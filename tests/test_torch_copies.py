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
                                  "core/peer_selection.py",
                                  "telemetry/sinks.py"])
def test_numpy_module_copy_is_verbatim(path):
    ours = ROOT / "src" / "repro_torch" / path
    theirs = ROOT / "src" / "repro" / path
    assert ours.read_text() == theirs.read_text()


def test_cross_device_world_copy_differs_only_in_imports():
    """``scenarios/cross_device.py`` is the reference's line for line,
    except its two import lines, which name the port's modules."""
    ours = (ROOT / "src" / "repro_torch" / "scenarios" /
            "cross_device.py").read_text().splitlines()
    theirs = (ROOT / "src" / "repro" / "scenarios" /
              "cross_device.py").read_text().splitlines()
    assert len(ours) == len(theirs)
    differ = [(a, b) for a, b in zip(ours, theirs) if a != b]
    assert differ == [
        ("from repro_torch.scenarios.compile import ATTACK_CODE, "
         "DEFAULT_SCALE",
         "from repro.scenarios.compile import ATTACK_CODE, DEFAULT_SCALE"),
        ("from repro_torch.scenarios.spec import ATTACK_KINDS",
         "from repro.scenarios.spec import ATTACK_KINDS")]


def test_token_batcher_copy_differs_only_in_its_import():
    """``data/loader.py`` (``TokenBatcher``) is the reference's line for
    line, except the import line, which names the port's module."""
    ours = (ROOT / "src" / "repro_torch" / "data" /
            "loader.py").read_text().splitlines()
    theirs = (ROOT / "src" / "repro" / "data" /
              "loader.py").read_text().splitlines()
    assert len(ours) == len(theirs)
    differ = [(a, b) for a, b in zip(ours, theirs) if a != b]
    assert differ == [
        ("from repro_torch.data.synthetic import make_lm_stream",
         "from repro.data.synthetic import make_lm_stream")]
    from repro.data.loader import TokenBatcher as JTokenBatcher

    from repro_torch.data.loader import TokenBatcher
    for step in (0, 3):
        a, b = TokenBatcher(600, 16, 4, seed=2).batch_at(step), \
            JTokenBatcher(600, 16, 4, seed=2).batch_at(step)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("name", ["resolve_world", "probe_indices"])
def test_cross_device_runner_helpers_are_verbatim(name):
    """The runner's numpy helpers are the reference's, source for source."""
    import inspect

    from repro.core import cross_device as jcd

    from repro_torch.core import cross_device as tcd
    assert inspect.getsource(getattr(tcd, name)) == \
        inspect.getsource(getattr(jcd, name))


@pytest.mark.parametrize("module,name", [
    ("launch/roofline.py", "secagg_pad_bytes"),
    ("launch/roofline.py", "dp_epsilon"),
    ("launch/roofline.py", "gossip_wire_bytes"),
    ("launch/roofline.py", "sharded_ring_bytes"),
    ("launch/roofline.py", "gossip_round_wire_bytes"),
    ("launch/roofline.py", "ppermute_ring_bytes"),
    ("core/secagg.py", "pair_seed"),
    ("core/secagg.py", "secagg_mask_bytes")])
def test_privacy_contracts_are_verbatim(module, name):
    """The privacy wire's byte and budget contracts and the secagg module's
    plain-Python functions are the reference's, source for source."""
    import importlib
    import inspect
    mod = module[:-3].replace("/", ".")
    ours = importlib.import_module(f"repro_torch.{mod}")
    theirs = importlib.import_module(f"repro.{mod}")
    assert inspect.getsource(getattr(ours, name)) == \
        inspect.getsource(getattr(theirs, name))


def test_roofline_wire_bytes_equal():
    from repro.launch import roofline as jroofline

    from repro_torch.launch import roofline
    assert roofline.WIRE_BYTES == jroofline.WIRE_BYTES


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
                                  "SSMConfig", "ModelConfig", "ShapeConfig",
                                  "MeshConfig", "RunConfig"])
def test_config_fields_and_defaults_equal(name):
    def default(f):
        """A field's default; a record (RunConfig's nested configs, a
        class of each package) by its class name and fields."""
        d = f.default
        return (type(d).__name__, dataclasses.asdict(d)) \
            if dataclasses.is_dataclass(d) else d
    ours = dataclasses.fields(getattr(config, name))
    theirs = dataclasses.fields(getattr(jconfig, name))
    assert [(f.name, default(f)) for f in ours] == \
        [(f.name, default(f)) for f in theirs]


def test_shapes_and_mesh_configs_equal():
    """The dry run's shapes and the mesh config's derived properties."""
    assert config.SHAPES == {k: config.ShapeConfig(**dataclasses.asdict(v))
                             for k, v in jconfig.SHAPES.items()}
    for kw in ({}, {"multi_pod": True}, {"multi_pod": True, "data": 8,
                                         "model": 1, "pods": 2}):
        ours, theirs = config.MeshConfig(**kw), jconfig.MeshConfig(**kw)
        assert (ours.shape, ours.axis_names, ours.num_devices) == \
            (theirs.shape, theirs.axis_names, theirs.num_devices)


def _function_source(path: Path, name: str) -> str:
    """A top-level definition's source read from a file, not imported (the
    reference's dry run sets ``XLA_FLAGS`` when it is imported)."""
    import ast
    text = path.read_text()
    for node in ast.parse(text).body:
        targets = [t.id for t in getattr(node, "targets", [])
                   if isinstance(t, ast.Name)]
        if getattr(node, "name", None) == name or name in targets:
            return ast.get_source_segment(text, node)
    raise KeyError(name)


@pytest.mark.parametrize("module,name", [
    ("launch/sharding_rules.py", "base_rules"),
    ("launch/roofline.py", "model_flops_estimate"),
    ("launch/dryrun.py", "SKIPS"),
    ("launch/dryrun.py", "SCENARIO_HORIZON"),
    ("launch/dryrun.py", "SLIDING_WINDOW_FOR_LONG"),
    ("launch/dryrun.py", "FULL_ATTENTION_FAMILIES"),
    ("launch/dryrun.py", "pick_optimizer"),
    ("launch/dryrun.py", "pick_microbatches"),
    ("launch/dryrun.py", "pick_moe_strategy"),
    ("launch/dryrun.py", "effective_config"),
    ("data/partition.py", "shard_partition"),
    ("config.py", "RunConfig")])
def test_launch_costing_copies_are_verbatim(module, name):
    """The dry run's policies, its skips and horizon, the sharding rules
    and the model-flops estimate are the reference's, source for source;
    ``base_rules`` also gives equal rules for every variant. So are the
    numpy-only ``shard_partition`` and the ``RunConfig`` record."""
    ours = _function_source(ROOT / "src" / "repro_torch" / module, name)
    assert ours == _function_source(ROOT / "src" / "repro" / module, name)
    if name == "base_rules":
        from repro.launch.sharding_rules import base_rules as jbase

        from repro_torch.launch.sharding_rules import base_rules
        for multi in (False, True):
            for variant in ("baseline", "no_seqshard", "expert_model",
                            "pure_dp", "zero1"):
                assert base_rules(multi, variant=variant) == \
                    jbase(multi, variant=variant)


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
for name in ("port_table3", "port_cross_device", "port_secagg"):
    spec = importlib.util.spec_from_file_location(
        name, f"benchmarks/{name}.py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
from repro_torch.core import run_cross_device
from repro_torch.scenarios import CrossDeviceSpec
st, hist = run_cross_device(
    0, mlp_task(32, 10), dataclasses.replace(cfg, dts_signal="all"),
    TrainConfig(batch_size=16), data, world=CrossDeviceSpec(
        enrolled=4, sample_k=3, attacks=(("alie", 0.25),)), epochs=3,
    eval_every=3, test_x=data["test_x"], test_y=data["test_y"],
    device="cpu")
assert st.sketch_round.shape == (4, 8) and hist[0][0] == 3
from repro_torch.launch import roofline
st, *_ = run_defta(0, mlp_task(32, 10), dataclasses.replace(
                       cfg, secagg="pairwise", secagg_mode="masked_geom",
                       dts_signal="all", dp_sigma=1.0),
                   TrainConfig(batch_size=16), data, epochs=2,
                   num_malicious=1, device="cpu")
assert st.epoch.tolist() == [2] * 5 and roofline.dp_epsilon(1.0, 2) > 0
st2, *_ = run_defta(0, mlp_task(32, 10), DeFTAConfig(num_workers=4),
                    TrainConfig(), data, epochs=1, device="cpu", shards=2)
assert st2.epoch.tolist() == [1] * 4
import os, tempfile
from repro_torch.launch import train
from repro_torch.telemetry import RunLedger
path = os.path.join(tempfile.mkdtemp(), "ledger.jsonl")
assert train.main(["--device", "cpu", "--scenario", "churn_signflip",
                   "--sim-epochs", "1", "--sim-local-epochs", "1",
                   "--sim-workers", "4", "--telemetry", path]) == 0
assert open(path).read().count('"type": "round"') == 1
assert train.main(["--device", "cpu", "--fl", "--smoke", "--pods", "2",
                   "--steps", "2", "--gossip-every", "1", "--seq", "16",
                   "--transport", "ppermute"]) == 0
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
              "examples/port_robustness_demo.py",
              "benchmarks/port_cross_device.py",
              "benchmarks/port_secagg.py",
              "src/repro_torch/core/secagg.py",
              "src/repro_torch/launch/roofline.py",
              "src/repro_torch/core/cross_device.py",
              "src/repro_torch/scenarios/cross_device.py",
              "src/repro_torch/telemetry/spec.py",
              "src/repro_torch/telemetry/sinks.py",
              "src/repro_torch/launch/train.py",
              "src/repro_torch/sharding.py",
              "benchmarks/port_shard_scaling.py",
              "examples/port_train_federated.py",
              "src/repro_torch/launch/steps.py",
              "src/repro_torch/launch/costing.py",
              "src/repro_torch/counting.py",
              "src/repro_torch/kernels/cost.py",
              "src/repro_torch/launch/dryrun.py",
              "src/repro_torch/launch/mesh.py",
              "src/repro_torch/launch/sharding_rules.py",
              "src/repro_torch/core/pods.py",
              "src/repro_torch/optim/optimizers.py",
              "src/repro_torch/checkpoint/checkpoint.py",
              "src/repro_torch/data/loader.py"):
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
