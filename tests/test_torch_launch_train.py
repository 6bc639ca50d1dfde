"""The port's launcher (``repro_torch.launch.train``) against the
reference's ``repro.launch.train`` on the CPU, at tiny sizes.

For ``--scenario``, ``--scenario --async-ticks`` and ``--cross-device``,
each with ``--telemetry``, both launchers run with the same arguments: both
exit 0, the manifests carry the same config, the JSONL round rows the same
keys in the same order and the same ``t`` stamps, and the port's ledger
renders through ``benchmarks/render_experiments.render_telemetry_panel``.
The CI's two ``--shard-workers 8`` commands run on 8 CPU shards with the
reference launcher's unsharded ledger layout. The refusals
(``--dts-signal`` without DTS, the unported modes, no card) and
``--profile``'s trace are checked on the port.
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


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's torch work: its training
    runs make many small ops, and under the suite's parallel workers
    torch's default of a thread a core oversubscribes the CPU (an FL
    parity run took 143 s with the default and 30 s with one thread,
    beside five busy processes on 8 cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

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


# the CI's shard lane (.github/workflows/ci.yml, "Sharded scenario smoke"
# and "Sharded cross-device smoke") at a reduced size: fewer epochs and
# enrolled users, one local epoch
SHARDED = {
    "scenario": ["--scenario", "churn_signflip", "--sim-epochs", "4",
                 "--sim-workers", "16", "--sim-local-epochs", "1",
                 "--shard-workers", "8"],
    "cross_device": ["--cross-device", "--enrolled", "64", "--sample-k",
                     "16", "--sim-epochs", "2", "--sim-local-epochs", "1",
                     "--cd-shard-size", "40", "--shard-workers", "8"],
}


@pytest.mark.parametrize("mode", sorted(SHARDED))
def test_sharded_ci_commands_match_the_references_unsharded_ledger(
        mode, tmp_path, monkeypatch, capsys):
    """``--shard-workers 8`` runs (8 CPU shards) and its ledger has the
    reference launcher's unsharded config, row keys and stamps: ledger
    rows do not depend on the shard count."""
    ours, theirs = tmp_path / "port.jsonl", tmp_path / "ref.jsonl"
    argv = SHARDED[mode]
    assert train.main(["--device", "cpu", *argv, "--telemetry",
                       str(ours)]) == 0
    assert "sharded over 8 devices" in capsys.readouterr().out
    assert reference_run([*argv[:-2], "--telemetry", str(theirs)],
                         monkeypatch) == 0
    got, want = rows_of(ours), rows_of(theirs)
    assert got[0]["config"] == want[0]["config"]
    assert [list(r) for r in got[1:]] == [list(r) for r in want[1:]]
    assert [r.get("t") for r in got] == [r.get("t") for r in want]
    assert sum(r["type"] == "round" for r in got) == int(argv[argv.index(
        "--sim-epochs") + 1])


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
    (["--fl", "--smoke", "--debug-mesh"], NotImplementedError, "item 12"),
    (["--fl", "--smoke", "--pods", "4", "--dts-signal", "geom"],
     SystemExit, "needs --pod-dts"),
    (["--fl", "--smoke", "--pods", "2", "--scenario", "paper_noise@2"],
     SystemExit, "attackers occupy pod slots"),
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


# ---------------------------------------------------------------------------
# LM training and --fl against the reference launcher
# ---------------------------------------------------------------------------

FL = ["--fl", "--smoke", "--pods", "4", "--steps", "2", "--gossip-every",
      "1", "--seq", "16"]
FL_RUNS = {
    "in_jit_fp32": FL,
    "dts_all_time_machine": FL + ["--pod-dts", "--dts-signal", "all",
                                  "--pod-time-machine"],
    # the reference without a mesh runs ppermute in_jit: the port's ring
    # must agree with the in-process mix
    "ring_int8_scenario": FL + ["--gossip-wire", "int8", "--transport",
                                "ppermute", "--scenario", "churn_signflip"],
    "single_pod": ["--smoke", "--steps", "2", "--seq", "16"],
}


def printed_losses(out: str):
    """The reference launcher's per-step losses, as printed (4 decimals)."""
    import re
    rows = []
    for line in out.splitlines():
        m = re.match(r"step +\d+ (losses=(\[[^\]]*\])|loss=([\d.]+))", line)
        if m:
            rows.append(json.loads(m.group(2)) if m.group(2)
                        else float(m.group(3)))
    return rows


@pytest.mark.parametrize("run", sorted(FL_RUNS))
def test_lm_training_losses_match_the_reference_launcher(run, monkeypatch,
                                                         capsys):
    """The port's ``train_lm`` from the reference launcher's initial
    params (``init_params(PRNGKey(0))``, carried by ``convert``) on its
    pod-round draws (``JaxPodDraws`` from ``PRNGKey(101)``) and its
    ``TokenBatcher`` batches: every step's losses within 1.5e-4 of the
    reference's printed 4-decimal ones (5e-5 of it the print's rounding),
    with the same pipeline line."""
    import jax
    import numpy as np

    from repro.config import reduced as jreduced
    from repro.configs import get_config as jget_config
    from repro.models import model as jmodel
    from test_torch_pod_round import JaxPodDraws

    from repro_torch.convert import model_params_from_jax

    argv = FL_RUNS[run]
    monkeypatch.setattr(sys, "argv", ["repro.launch.train", *argv])
    jtrain.main()                        # LM training returns, no exit
    ref_out = capsys.readouterr().out
    want = printed_losses(ref_out)
    tree = jax.tree.map(np.asarray, jmodel.init_params(
        jax.random.PRNGKey(0), jreduced(jget_config("paper-small"))))
    args = train.parser().parse_args(["--device", "cpu", *argv])
    args.argv = []
    stochastic = False
    got = train.train_lm(args, params=model_params_from_jax(tree, "cpu"),
                         draws=JaxPodDraws(jax.random.PRNGKey(101),
                                           stochastic))
    out = capsys.readouterr().out
    assert len(got["losses"]) == len(want) == int(argv[argv.index(
        "--steps") + 1])
    np.testing.assert_allclose(np.asarray(got["losses"]), np.asarray(want),
                               rtol=0, atol=1.5e-4)
    if "--fl" in argv:
        line = [ln for ln in out.splitlines() if "pod pipeline" in ln][0]
        ref_line = [ln for ln in ref_out.splitlines()
                    if "pod pipeline" in ln][0]
        assert line.replace("ppermute", "in_jit").replace(
            "in_process", "in_jit") == ref_line
        assert out.count("[gossip]") == 2
        assert got["pstate"].round == 2


def test_fl_smoke_main_and_checkpoint_load_in_the_reference(tmp_path):
    """``python -m repro_torch.launch.train --fl --smoke --device cpu``
    runs, and its checkpoint (the reference's layout: the pods' trees
    stacked) loads in the reference's ``load_checkpoint``."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.checkpoint import load_checkpoint as jload

    ck = tmp_path / "ck"
    assert train.main(["--device", "cpu", *FL, "--checkpoint-dir",
                       str(ck)]) == 0
    from repro.config import reduced as jreduced
    from repro.configs import get_config as jget_config
    from repro.models import model as jmodel
    from repro.optim import make_optimizer as jmake

    like = jax.eval_shape(lambda: jmodel.init_params(
        jax.random.PRNGKey(0), jreduced(jget_config("paper-small"))))
    stack = lambda t: jax.tree.map(
        lambda s: jnp.zeros((4,) + s.shape, s.dtype), t)
    tree, step = jload(str(ck), {"params": stack(like),
                                 "opt": stack(jax.eval_shape(
                                     jmake("adam", 1e-3).init, like))})
    assert step == 2
    assert all(np.isfinite(np.asarray(x, np.float32)).all()
               for x in jax.tree.leaves(tree))
