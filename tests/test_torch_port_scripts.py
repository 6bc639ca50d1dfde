"""The port's scripts beside the reference's: ``port_bias_analysis`` prints
the reference's table character for character, ``port_table_trust``'s
headline checks and attacker-θ share are the reference's, a short CPU
sweep runs, and the examples run on the CPU when asked."""
from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    sys.path.insert(0, str(ROOT / "benchmarks"))
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(str(ROOT / "benchmarks"))
    return mod


def test_port_bias_analysis_prints_the_references_table(capsys):
    ours = load("benchmarks/port_bias_analysis.py", "port_bias_analysis")
    theirs = load("benchmarks/bias_analysis.py", "bias_analysis")
    want_rows = theirs.run()
    want = capsys.readouterr().out
    got_rows = ours.run(device="cpu")
    got = capsys.readouterr().out
    assert got == want and want.count("\n") == 5
    for a, b in zip(got_rows, want_rows):
        assert a.keys() == b.keys()
        np.testing.assert_allclose([a[k] for k in a], [b[k] for k in b],
                                   rtol=1e-9)


def trust_rows(accs):
    return [dict(attack=a, signal=s, partition=p, acc=v)
            for (a, s, p), v in accs.items()]


@pytest.mark.parametrize("accs", [
    {("label_flip", "loss", "non_iid"): 0.70,
     ("label_flip", "geom", "non_iid"): 0.78,
     ("alie", "both", "non_iid"): 0.58, ("alie", "corr", "non_iid"): 0.83},
    {("label_flip", "loss", "non_iid"): 0.80,
     ("label_flip", "all", "non_iid"): 0.79,
     ("alie", "loss", "non_iid"): 0.58, ("alie", "all", "non_iid"): 0.60,
     ("alie", "all", "iid"): 0.99},
    {("alie", "corr", "non_iid"): 0.8},
])
def test_trust_headline_checks_are_the_references(accs):
    ours = load("benchmarks/port_table_trust.py", "port_table_trust")
    theirs = load("benchmarks/table_trust.py", "table_trust")
    rows = trust_rows(accs)
    assert ours.headline_check(rows, verbose=False) == \
        theirs.headline_check(rows, verbose=False)
    assert ours.alie_headline_check(rows, verbose=False) == \
        theirs.alie_headline_check(rows, verbose=False)


def test_attacker_theta_share_is_the_references():
    ours = load("benchmarks/port_table_trust.py", "port_table_trust")
    theirs = load("benchmarks/table_trust.py", "table_trust")
    rng = np.random.default_rng(0)
    conf = rng.normal(size=(9, 9)).astype(np.float32)
    adj = rng.random((9, 9)) < 0.5
    mal = np.zeros(9, bool)
    mal[6:] = True
    np.testing.assert_allclose(
        ours.attacker_theta_share(torch.tensor(conf), adj, mal),
        theirs.attacker_theta_share(jnp.asarray(conf), adj, mal), rtol=1e-6)


def test_port_table_trust_sweeps_on_the_cpu():
    """A cut grid (4 vanilla workers + 2 attackers, 2 epochs) runs every
    signal, records the trajectory and leaves the headline checks to the
    full grid's numbers."""
    ours = load("benchmarks/port_table_trust.py", "port_table_trust")
    rows = ours.sweep(epochs=2, k=2, num_workers=4, attacks=("alie",),
                      signals=ours.SIGNALS, partitions=("non_iid",),
                      eval_every=1, local_epochs=1, n_per_worker=32,
                      device="cpu", verbose=False)
    assert [r["signal"] for r in rows] == list(ours.SIGNALS)
    for r in rows:
        assert [p["epoch"] for p in r["trajectory"]] == [1, 2]
        assert 0.0 <= r["attacker_theta"] <= 1.0 and np.isfinite(r["acc"])


def test_port_examples_run_on_the_cpu(capsys):
    quick = load("examples/port_quickstart.py", "port_quickstart")
    m, m2 = quick.main(["--device", "cpu", "--epochs", "2"])
    assert 0.0 <= m <= 1.0 and 0.0 <= m2 <= 1.0
    serve = load("examples/port_serve_decode.py", "port_serve_decode")
    for arch in ("mamba2-780m", "whisper-tiny"):
        out = serve.main(["--device", "cpu", "--arch", arch, "--batch", "2",
                          "--prompt-len", "3", "--max-new", "2"])
        assert tuple(out.shape) == (2, 2)
    text = capsys.readouterr().out
    assert "DeFTA   (+1 malicious)" in text and "tok/s on cpu" in text


def test_port_secagg_runs_on_the_cpu(capsys):
    """The privacy-wire bench on a cut run (2 epochs): its three contracts
    hold and every run of it is recorded."""
    bench = load("benchmarks/port_secagg.py", "port_secagg")
    out = bench.bench(epochs=2, eval_every=1, device="cpu")
    assert out["mask_bytes_ok"] and out["clean_ok"] and out["host_ok"]
    assert out["runs"]["clean"]["chunks"] == 2
    assert sorted(out["runs"]) == ["clean", "secagg", "secagg_dp"]
    assert sorted(out["attacked"]) == ["edge", "masked_geom", "plain"]
    assert sorted(out["dp_epsilon"]) == ["0.5", "1", "2"]
    assert "contract clean parity" in capsys.readouterr().out
