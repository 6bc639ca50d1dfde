"""The port's copies of the reference's numpy-only modules stay equal to the
originals, its configs keep the reference's fields and defaults, and the
port stands alone: it imports neither ``jax`` nor any ``repro`` module and
runs on the CPU only when asked to."""
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
from repro.core import topology as jtopology
from repro.data import partition as jpartition
from repro.data import synthetic as jsynthetic
from repro.telemetry.ledger import RunLedger as JRunLedger

from repro_torch import config, device as tdevice
from repro_torch.core import topology
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


@pytest.mark.parametrize("name", ["DeFTAConfig", "TrainConfig"])
def test_config_fields_and_defaults_equal(name):
    ours = dataclasses.fields(getattr(config, name))
    theirs = dataclasses.fields(getattr(jconfig, name))
    assert [(f.name, f.default) for f in ours] == \
        [(f.name, f.default) for f in theirs]


def test_port_runs_without_jax_or_repro():
    """A fresh interpreter imports the port and runs a tiny CPU run_defta;
    neither jax nor any repro module may be loaded afterwards."""
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
        + [ROOT / "chip_smoke.py"]
    pattern = re.compile(r"^\s*(import\s+(jax|repro)\b(?!_)"
                         r"|from\s+(jax|repro)(\.|\s))", re.M)
    hits = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}" for f in files
            for m in pattern.finditer(f.read_text())]
    assert len(files) > 15
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
    assert tdevice.resolve_device("cpu") == torch.device("cpu")
