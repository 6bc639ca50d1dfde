"""``BENCHMARK.json`` against the benchmark's contract: keys, names,
units, bounds, and every file a name leads to."""
from __future__ import annotations

import json
import math
import os
import re

import pytest

from bench.run import ROOT, load_cell, system_module

with open(os.path.join(ROOT, "BENCHMARK.json")) as _fh:
    MANIFEST = json.load(_fh)

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}\Z")
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
CELL_NAMES = [w["name"] for w in MANIFEST["workloads"]]


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for p in MANIFEST["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    cmd = MANIFEST["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    for word in cmd[1:]:
        assert any(word == p or word.startswith(p + "/")
                   for p in MANIFEST["paths"])
    assert len(json.dumps(MANIFEST)) <= 64 * 1024


def test_run_seconds_fit_a_full_check():
    """2 + 14 x 24 runs of run_seconds + 60 s, 2 x 90 s of compile a cell
    and 1200 s spare fit 43200 s."""
    s = MANIFEST["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric(metric):
    keys = set(metric) - {"workloads"}
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    for cell in metric.get("workloads", []):
        assert cell in CELL_NAMES
    assert os.path.isfile(os.path.join(
        ROOT, "bench", "metrics", metric["name"] + ".py"))
    if metric in MANIFEST["end_to_end"]:
        assert keys == {"name", "unit", "better", "bound", "source"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert keys == {"name", "unit", "better", "source", "layer", "moves"}
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert _line(metric["layer"])
        assert metric["moves"] in {m["name"]
                                   for m in MANIFEST["end_to_end"]}
        if metric["name"].endswith("_roofline") or "mfu" in metric["name"]:
            assert metric["unit"] == "%"


def test_metric_names_unique_and_setup_declared():
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    assert "setup_s" in names
    assert 1 <= len(MANIFEST["end_to_end"]) <= 16
    assert 1 <= len(MANIFEST["per_layer"]) <= 128


@pytest.mark.parametrize("conf", MANIFEST["configs"],
                         ids=lambda c: c["name"])
def test_config(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(conf["name"]) and _line(conf["source"])
    assert _line(conf["why"]) and len(conf["reduced"]) <= 16
    assert any(conf["file"].startswith(p + "/") for p in MANIFEST["paths"])
    with open(os.path.join(ROOT, conf["file"])) as fh:
        body = json.load(fh)
    assert body["source"] == conf["source"]
    assert sorted(body["reduced"]) == sorted(conf["reduced"])
    for key in conf["reduced"]:
        assert NAME.match(key)
        assert not key.endswith(("_dim", "_rank", "_size")) or \
            key == "vocab_size"
        assert body["published"][key] != body[key]
    assert os.path.isfile(os.path.join(
        ROOT, "bench", "reference", body["reference"] + ".py"))
    assert conf["name"] in {w["config"] for w in MANIFEST["workloads"]}


@pytest.mark.parametrize("name", CELL_NAMES)
def test_cell(name):
    w = {c["name"]: c for c in MANIFEST["workloads"]}[name]
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert w["chips"] in (1, 4) and _line(w["why"])
    cell = load_cell(name)                  # every file the names lead to
    kind = system_module(cell)              # the traffic's kind of system
    assert cell["limits"]["limits"]
    assert set(cell["limits"]["limits"]) <= set(kind.NUMBERS)
    e2e = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell["per_layer"]
    for m in cell["per_layer"]:
        assert m["moves"] in e2e


def test_cells_unique_and_four_chip_share():
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(set(pairs)) == len(pairs) == len(set(CELL_NAMES))
    assert 1 <= len(pairs) <= 24
    four = sum(w["chips"] == 4 for w in MANIFEST["workloads"])
    assert four <= max(1, math.floor(0.25 * len(pairs)))
