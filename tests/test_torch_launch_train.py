"""The port's launcher (``repro_torch.launch.train``) against the
reference's ``repro.launch.train`` on the CPU, at tiny sizes.

For ``--scenario``, ``--scenario --async-ticks`` and ``--cross-device``,
each with ``--telemetry``, both launchers run with the same arguments: both
exit 0, the manifests carry the same config, the JSONL round rows the same
keys in the same order and the same ``t`` stamps, and the port's ledger
renders through ``benchmarks/render_experiments.render_telemetry_panel``.
The refusals (``--dts-signal`` without DTS, the unported modes, no card)
and ``--profile``'s trace are checked on the port.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

import pytest
import torch

from repro.launch import train as jtrain

from repro_torch.launch import train

ROOT = Path(__file__).resolve().parents[1]

MODES = {
    "scenario": ["--scenario", "churn_signflip", "--sim-epochs", "2",
                 "--sim-local-epochs", "1", "--sim-workers", "4"],
    "async": ["--scenario", "churn_signflip", "--async-ticks", "3",
              "--sim-epochs", "2", "--sim-local-epochs", "1",
              "--sim-workers", "4"],
    "cross_device": ["--cross-device", "--enrolled", "8", "--sample-k", "4",
                     "--sim-epochs", "2", "--sim-local-epochs", "1",
                     "--cd-shard-size", "40", "--dts-signal", "all",
                     "--cd-attacks", "label_flip:0.25,alie:0.2",
                     "--max-staleness", "2"],
}


def panel(path):
    spec = importlib.util.spec_from_file_location(
        "render_experiments", ROOT / "benchmarks" / "render_experiments.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.render_telemetry_panel(str(path))


def reference_run(argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["repro.launch.train", *argv])
    with pytest.raises(SystemExit) as e:
        jtrain.main()
    return e.value.code


def rows_of(path):
    return [json.loads(ln) for ln in Path(path).read_text().splitlines()]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_launcher_ledger_matches_the_references(mode, tmp_path, monkeypatch,
                                                capsys):
    ours, theirs = tmp_path / "port.jsonl", tmp_path / "ref.jsonl"
    assert train.main(["--device", "cpu", *MODES[mode], "--telemetry",
                       str(ours)]) == 0
    assert reference_run([*MODES[mode], "--telemetry", str(theirs)],
                         monkeypatch) == 0
    out = capsys.readouterr().out
    assert out.count("telemetry ledger:") == 2
    got, want = rows_of(ours), rows_of(theirs)
    assert got[0]["type"] == want[0]["type"] == "manifest"
    assert got[0]["config"] == want[0]["config"]
    assert got[0].keys() == want[0].keys()
    assert [list(r) for r in got[1:]] == [list(r) for r in want[1:]]
    assert [r.get("t") for r in got] == [r.get("t") for r in want]
    body = [r for r in got if r["type"] == "round"]
    assert len(body) == (3 if mode == "async" else 2)
    assert got[-1]["type"] == "summary"
    text = panel(ours)
    assert "(no round rows" not in text
    assert f"{len(body)} rounds recorded" in text
    assert text.count("\n| ") >= 1 + len(body)


def test_launcher_without_telemetry_writes_nothing(tmp_path, monkeypatch,
                                                   capsys):
    monkeypatch.chdir(tmp_path)
    assert train.main(["--device", "cpu", *MODES["scenario"]]) == 0
    out = capsys.readouterr().out
    assert "final vanilla acc" in out and "telemetry ledger" not in out
    assert list(tmp_path.iterdir()) == []


def test_profile_leaves_a_trace(tmp_path):
    prof = tmp_path / "prof"
    assert train.main(["--device", "cpu", *MODES["scenario"],
                       "--sim-epochs", "1", "--profile", str(prof)]) == 0
    trace = json.loads((prof / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"transport", "trust_update"} <= names


@pytest.mark.parametrize("argv,exc,match", [
    (["--scenario", "storm", "--shard-workers", "2"], NotImplementedError,
     "item 7"),
    (["--fl", "--pods", "4", "--scenario", "churn_signflip"],
     NotImplementedError, "item 11"),
    (["--steps", "4"], NotImplementedError, "item 11"),
    (["--scenario", "storm", "--dts-signal", "geom", "--aggregation",
      "median"], SystemExit, "needs DTS"),
])
def test_unported_modes_and_refusals_raise(argv, exc, match):
    with pytest.raises(exc, match=match):
        train.main(["--device", "cpu", *argv])


def test_launcher_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(MODES["scenario"])
    assert train.parser().parse_args([]).device == "cuda"


def test_parse_cd_attacks_is_the_references():
    for text in ("", "label_flip:0.15,alie:0.14", " noise : 0.5"):
        assert train.parse_cd_attacks(text) == jtrain.parse_cd_attacks(text)


@pytest.mark.parametrize("name", ["churn_signflip", "storm", "paper_noise@3"])
def test_scenario_summary_is_the_references(name):
    """The launcher prints ``CompiledScenario.summary()``: the port's equals
    the reference's, with and without the static topology."""
    from repro.core.topology import make_topology as jmake_topology
    from repro.scenarios import compile_scenario as jcompile
    from repro.scenarios import get_scenario as jget

    from repro_torch.scenarios import compile_scenario, get_scenario
    ours = compile_scenario(get_scenario(name, 8), 8, 12, device="cpu")
    theirs = jcompile(jget(name, 8), 8, 12)
    adj = jmake_topology("random_kout", ours.num_workers, 4, 0)
    assert ours.summary() == theirs.summary()
    assert ours.summary(adj) == theirs.summary(adj)
