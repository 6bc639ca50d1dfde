"""The harness end to end at a CPU test's size: a run of each cell agrees
with the plain reference; each fault a training cell can have, planted in
the timed path, turns ``correct`` false; the control (the reference in
float8 put in the program's place) fails the limits that the program
meets. The last test runs the control at a cell's own size on the card."""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import pytest

from bench import readings
from bench.run import ROOT, judge, load_cell, run_cell
from bench.systems.fl_lm import FAULTS
from bench.tests.small import CELLS, small_cell

SEEDS = (7, 2**31 + 5)


def _run(cell, seed, fault=None):
    return run_cell(cell, seed, 0.05, False, device="cpu", fault=fault,
                    t_start=time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_run_agrees_with_reference(name, dtype):
    out = _run(small_cell(name, dtype), 12345678901)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 8
    assert set(out["metrics"]) == {"samples_per_s", "peak_mem_gb",
                                   "setup_s"}
    assert out["window"]["samples"] == out["window"]["attempted"] * 4 * 2 * 32
    assert list(out)[-1] == "checks"
    assert list(out["checks"]) == list(SMALL_KEYS[name])
    if dtype == "float32":          # the same arithmetic up to rounding
        assert all(r["value"] < 1e-4 for r in out["checks"].values())


SMALL_KEYS = {n: small_cell(n)["limits"]["limits"] for n in CELLS}


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", FAULTS)
def test_fault_turns_correct_false(name, fault):
    out = _run(small_cell(name), 2**31 + 5, fault)
    assert not out["correct"]
    assert any(r["value"] > r["limit"] for r in out["checks"].values())


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_control_fails_where_the_program_passes(name, seed):
    cell = small_cell(name)
    limits = cell["limits"]["limits"]
    row = readings.one_seed(cell, seed, True, device="cpu")
    assert judge(row["lower"], limits)[0], row["lower"]
    control = {k: v for k, v in row["control_fp8"].items() if k in limits}
    assert set(control) == set(limits) - {"mix_gap", "trust_gap"}
    assert any(control[k] > limits[k] for k in control), control
    assert set(row["faults"]) == set(FAULTS)
    for fault, numbers in row["faults"].items():
        assert not judge(numbers, limits)[0], (fault, numbers)


def test_no_card_no_result(tmp_path):
    """Without enough CUDA cards the command exits non-zero and prints no
    result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "bench", "run.py"),
         "--workload", CELLS[0], "--seed", "3", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=120)
    assert res.returncode != 0 and res.stdout == ""


def test_unknown_workload_is_refused():
    with pytest.raises(SystemExit):
        load_cell("no-such-cell")


@pytest.mark.chip
@pytest.mark.parametrize("name", CELLS)
def test_control_at_the_cells_size(card, name):
    """The cell's own size and limits: the program meets them, the control
    in float8 fails one."""
    cell = load_cell(name)
    limits = cell["limits"]["limits"]
    row = readings.one_seed(cell, 3_000_000_123, True, device=card)
    assert judge(row["lower"], limits)[0], json.dumps(row["lower"])
    control = {k: v for k, v in row["control_fp8"].items() if k in limits}
    assert any(control[k] > limits[k] for k in control), control


class _ToySystem:
    """A kind of system that sums numbers: what a new kind provides."""

    def __init__(self, cfg, traffic, seed, device, fault=None):
        self.n, self.bad = traffic["n"], fault is not None

    def setup(self):
        return 1, 0

    def window(self, seconds):
        return {"wall_s": 0.5, "samples": self.n, "model_flops": 0,
                "attempted": 1, "failed": 0, "sum_s": [0.25]}

    def free(self):
        pass

    def compare(self):
        return {"sum_gap": 1.0 if self.bad else 0.0}, {}


def test_a_new_kind_mix_and_metric_are_files_alone(tmp_path, monkeypatch):
    """A cell of a new kind, with its own mix, limits and per-layer metric,
    runs through the unchanged harness: every piece is found by name."""
    import types
    kind = types.ModuleType("bench.systems.toy_sum")
    kind.System, kind.NUMBERS = _ToySystem, ("sum_gap",)
    monkeypatch.setitem(sys.modules, "bench.systems.toy_sum", kind)
    files = {
        "BENCHMARK.json": {
            "configs": [{"name": "toy", "file": "bench/configs/toy.json"}],
            "workloads": [{"name": "toy.mix", "config": "toy",
                           "traffic": "mix", "chips": 1}],
            "end_to_end": [{"name": "samples_per_s", "unit": "samples/s"},
                           {"name": "setup_s", "unit": "s"}],
            "per_layer": [{"name": "sum.ms", "unit": "ms"}]},
        "bench/configs/toy.json": {},
        "bench/traffic/mix.json": {"kind": "toy_sum", "n": 300},
        "bench/workloads/toy.mix.json": {"limits": {"sum_gap": 0.5}}}
    for rel, body in files.items():
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_text(json.dumps(body))
    (tmp_path / "bench/metrics").mkdir()
    for name in ("samples_per_s", "setup_s"):
        (tmp_path / "bench/metrics" / f"{name}.py").write_text(
            open(os.path.join(ROOT, "bench", "metrics", name + ".py")).read())
    (tmp_path / "bench/metrics/sum.ms.py").write_text(
        "def read(record):\n"
        "    return 1e3 * sum(record['window']['sum_s'])\n")
    cell = load_cell("toy.mix", root=str(tmp_path))
    out = run_cell(cell, 3, 0.0, False, device="cpu",
                   t_start=time.perf_counter())
    assert out["correct"] and out["checks"] == {
        "sum_gap": {"value": 0.0, "limit": 0.5}}
    assert out["metrics"]["samples_per_s"]["value"] == 600.0
    assert set(out["metrics"]) == {"samples_per_s", "setup_s"}
    out = run_cell(cell, 3, 0.0, True, device="cpu", fault="any",
                   t_start=time.perf_counter())
    assert not out["correct"]
    assert out["metrics"] == {"sum.ms": {"value": 250.0, "unit": "ms"}}
