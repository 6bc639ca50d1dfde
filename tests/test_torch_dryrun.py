"""The port's dry run (``python -m repro_torch.launch.dryrun``) on the CPU.

* The entry point at the reference's own test pair (whisper-tiny,
  ``train_4k``): exit 0, the ``bottleneck=`` line, a JSON the reference's
  ``benchmarks/roofline_table.py`` renders unchanged, beside the skipped
  pair (``SKIPS``), recorded as ``skipped``.
* The production mesh and its counted shares: a multi-pod FL train step
  (both pods) gives a device the same flops, bytes and collectives as the
  single-pod step on one pod's share of the batch; the batch splits over
  the data axis.
* Traffic between pods (a pod is one node) is priced at the link between
  nodes: the gossip step's time is ``gossip_cost``'s, and the FedAvg
  baseline's gradient all-reduce crosses pods.
* ``measure`` on the CPU (a reduced config): the device's counted flops,
  bytes and kernel calls equal the meta count's at the same cut.

The tests that pin the counts of the earlier (8, 1) pod pass it
explicitly.

No model is compiled and nothing is trained with JAX.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import sharding
from repro_torch.config import SHAPES, reduced
from repro_torch.configs import get_config
from repro_torch.launch import costing, dryrun
from repro_torch.launch import roofline as rf
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def test_entry_point_and_the_references_table(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "whisper-tiny", "--shape", "train_4k", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "bottleneck=" in r.stdout
    res = json.loads((tmp_path / "whisper-tiny_train_4k_single.json")
                     .read_text())
    assert res["status"] == "ok" and res["chips"] == 8
    rf = res["roofline"]
    assert rf["bottleneck"] in ("compute", "memory", "collective")
    assert rf["hlo_gflops_total"] > 0 and rf["bytes_per_device"] > 0
    # 12 forward (4 encoder, 4 causal, 4 cross) and 8 more in the backward
    # (the decoder's four scanned layers recomputed under remat), on each
    # of the model axis's 4 shards
    assert res["counted"]["kernel_calls"] == {"flash_attention_tc": 80}
    assert res["mesh_shape"] == {"data": 2, "model": 4}
    assert res["counted"]["closed_form_collectives"] == ["all-reduce"]
    skipped = dryrun.run_dryrun("whisper-tiny", "long_500k", verbose=False)
    assert skipped["status"] == "skipped"
    assert skipped["reason"] == dryrun.SKIPS[("whisper-tiny", "long_500k")]
    (tmp_path / "whisper-tiny_long_500k_single.json").write_text(
        json.dumps(skipped))
    sys.path.insert(0, str(ROOT / "benchmarks"))
    try:
        import roofline_table
    finally:
        sys.path.remove(str(ROOT / "benchmarks"))
    table = roofline_table.markdown(roofline_table.load(str(tmp_path)))
    assert "| whisper-tiny | train_4k | single | ok | " \
        f"{res['memory']['peak_per_device_gb']:.2f} |" in table
    assert "| whisper-tiny | long_500k | single | skipped |" in table


def small(arch, layers=4):
    return dataclasses.replace(reduced(get_config(arch), max_experts=8),
                               num_layers=layers, scan_layers=True,
                               remat=True, dtype="bfloat16")


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-moe-16b"])
def test_a_devices_share_of_the_fl_step_is_one_pods(arch):
    """Two pods of the FL step (each pod's work its own) give a device what
    the single-pod step gives on half the batch; with the batch split over
    the data axis of 8. The MoE runs expert parallelism on each pod's
    mesh."""
    cfg = small(arch)
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=32,
                                seq_len=16)
    multi = dryrun.plan(arch, shape, multi_pod=True, config=cfg, pod=(8, 1))
    single = dryrun.plan(arch, dataclasses.replace(shape, global_batch=16),
                         config=cfg, pod=(8, 1))
    assert (multi.fl_pods, multi.chips, single.chips) == (2, 16, 8)
    assert multi.moe_strategy == single.moe_strategy == \
        ("eplocal" if cfg.moe else "grouped")
    cm = dryrun.count_step(multi, dryrun.build_state(multi))
    cs = dryrun.count_step(single, dryrun.build_state(single))
    assert cm.split == cs.split == 8
    assert cm.flops == 2 * cs.flops
    assert cm.per_device("flops") == cs.per_device("flops")
    # bytes: the FL loop's own few (stacking the pods' losses) aside
    assert cm.per_device("bytes") == pytest.approx(cs.per_device("bytes"),
                                                   rel=1e-6)
    assert cm.collectives() == pytest.approx(cs.collectives(), rel=1e-12)
    assert cm.peak_device_bytes == pytest.approx(cs.peak_device_bytes,
                                                 rel=0.05)
    assert cs.per_device("flops") < cs.flops / 2
    if cfg.moe:
        assert cs.collectives()["all-to-all"] > 0


@pytest.mark.parametrize("fl", [True, False])
def test_traffic_across_pods_is_priced_between_nodes(fl):
    """The FL step's gradient all-reduce stays inside a pod (NVLink); its
    gossip step's ring crosses pods, and its time equals ``gossip_cost``'s
    egress time at the parameters' wire (bf16). The FedAvg baseline's
    all-reduce spans both pods' 16 devices and crosses between nodes."""
    cfg = small("qwen3-0.6b")
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=32,
                                seq_len=16)
    p = dryrun.plan("qwen3-0.6b", shape, multi_pod=True, fl=fl, config=cfg,
                    pod=(8, 1))
    state = dryrun.build_state(p)
    c = dryrun.count_step(p, state)
    coll, dcn = c.collectives(), c.collectives(dcn=True)
    roof = rf.analyze("qwen3-0.6b", "train_4k", "multi", p.chips,
                      {"flops": 1.0}, "", 1.0, 0, coll_override=coll,
                      dcn_override=dcn)
    assert coll["all-reduce"] > 0
    if not fl:
        assert p.grad_ranks == 16 and dcn == coll
        assert roof.t_collective == coll["all-reduce"] / rf.DCN_BW
        return
    assert p.grad_ranks == 8 and sum(dcn.values()) == 0
    assert roof.t_collective == coll["all-reduce"] / rf.ICI_BW
    info = dryrun._gossip_info(cfg, p.fl_pods, state[0], scenario="",
                               cd_enrolled=40, cd_sample_k=8,
                               shard_workers=4, verbose=False)
    want = costing.gossip_cost(cfg, p.fl_pods, wire="bf16")
    assert info["collective_breakdown"]["collective-permute"] * 1e9 == \
        pytest.approx(want["payload_bytes"] * (p.fl_pods - 1), rel=1e-12)
    assert info["t_collective_s"] == pytest.approx(want["t_ici_s"],
                                                   rel=1e-12)


@pytest.mark.parametrize("arch,shape,batch", [
    ("qwen3-0.6b", "train_4k", 2), ("deepseek-moe-16b", "prefill_32k", 1),
    ("mamba2-780m", "prefill_32k", 1)])
def test_measure_counts_the_device_as_meta(arch, shape, batch):
    """chip_smoke [10]'s three pairs, reduced, on the CPU: the device's
    counts equal meta's at the cut (the CPU launches no kernel)."""
    r = dryrun.measure(arch, shape, batch=batch, seq=32, device="cpu",
                       config=small(arch), repeats=1, verbose=False)
    m, d = r["meta"], r["device"]
    assert (m["flops"], m["bytes"], m["calls"]) == \
        (d["flops"], d["bytes"], d["calls"])
    assert sum(m["calls"].values()) > 0 and r["launches"] == {}
    assert r["cuts"] == [f"global_batch {SHAPES[shape].global_batch} -> "
                         f"{batch}", f"seq_len {SHAPES[shape].seq_len} -> 32"]
    assert r["step_ms"] > 0 and 0 < r["roofline_share"]


def test_measure_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.measure("mamba2-780m", "prefill_32k", batch=1,
                       config=small("mamba2-780m"), verbose=False)


@pytest.mark.parametrize("arch,shape", [("mamba2-780m", "prefill_32k"),
                                        ("deepseek-moe-16b", "prefill_32k")])
def test_meta_peak_equals_the_cpus(arch, shape):
    """The counted peak on meta equals the same step's on the CPU (ROADMAP
    queue 3 item 5: meta made ``_unsafe_view``'s output with a storage of
    its own from the metadata cache, a logits-sized block more at the
    unembedding: 14,815,364 against 13,766,788 B for Mamba2 here)."""
    cfg = dataclasses.replace(small(arch), vocab_size=4096)
    r = dryrun.measure(arch, shape, batch=2, seq=256, device="cpu",
                       config=cfg, repeats=1, verbose=False)
    assert r["meta"]["peak_bytes"] == r["device"]["counted_peak_bytes"]


# ---------------------------------------------------------------------------
# pure_dp (ROADMAP queue 3 item 6) and --optimizer / --accum-dtype
# ---------------------------------------------------------------------------

def _cut(shape_name, batch=16, seq=32):
    return dataclasses.replace(SHAPES[shape_name], global_batch=batch,
                               seq_len=seq)


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("shape_name", ["train_4k", "decode_32k"])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-780m"])
def test_pure_dp_device_runs_the_unsharded_step_on_its_rows(arch, shape_name,
                                                            multi):
    """Under ``pure_dp`` no parameter splits over the model axis and the
    batch splits over data x model (x pods): a device's counted flops
    equal the unsharded step's on its share of the batch (one device, the
    (1, 1) pod), and the gradient all-reduce spans data x model."""
    cfg = small(arch)
    shape = _cut(shape_name)
    p = dryrun.plan(arch, shape, multi_pod=multi, config=cfg,
                    variant="pure_dp")
    assert p.rules["batch"] == ("data", "model")
    c = dryrun.count_step(p, dryrun.build_state(p))
    share = 16 // (16 if multi else 8)
    one = dryrun.plan(arch, _cut(shape_name, batch=share), config=cfg,
                      pod=(1, 1))
    c1 = dryrun.count_step(one, dryrun.build_state(one))
    assert c.split == 8 and c1.split == 1
    assert c.per_device("flops") == pytest.approx(c1.per_device("flops"),
                                                  rel=1e-9)
    assert c.per_device("flops") > 0
    if shape.mode == "train":
        assert p.grad_ranks == 8
        assert c.collectives()["all-reduce"] > 0


@pytest.mark.parametrize("shape_name", ["prefill_32k", "decode_32k"])
def test_pure_dp_multi_pod_counts_the_baselines_share(shape_name):
    """Multi-pod ``pure_dp`` keeps the model axis in the batch: a device's
    flops at full width stay within 10 % of the baseline's (ROADMAP queue
    3 item 6: 4x before, 1,297.66 against 324.41 TFLOP at
    ``prefill_32k``)."""
    got = {v: dryrun.run_dryrun("qwen3-0.6b", shape_name, multi_pod=True,
                                variant=v, verbose=False)
           for v in ("baseline", "pure_dp")}
    flops = {v: r["roofline"]["hlo_gflops_total"] / r["chips"]
             for v, r in got.items()}
    assert got["pure_dp"]["status"] == "ok"
    assert flops["pure_dp"] == pytest.approx(flops["baseline"], rel=0.10)


def test_pure_dp_step_on_the_cpu_equals_the_unsharded_step():
    """A ``--measure``-style ``pure_dp`` train step's loss and gradients on
    (2, 4) of ``["cpu"] * 8`` (random weights and inputs placed as the dry
    run places them) against the same step unsharded."""
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import pod_mesh
    from repro_torch.models import model
    cfg = dataclasses.replace(small("qwen3-0.6b"), dtype="float32")
    p = dryrun.plan("qwen3-0.6b", _cut("train_4k", batch=8, seq=16),
                    config=cfg, variant="pure_dp", devices=["cpu"] * 8)
    params, _, _, batch = dryrun.build_state(p, "cpu")
    with sharding.logical_rules(pod_mesh(p.mesh), p.rules):
        loss, grads = steps.placed_grads(cfg, params, batch, "grouped")
    plain = sharding.unplace(params)
    leaves = {k: v.detach().requires_grad_()
              for k, v in _flat(plain).items()}
    want, _ = model.loss_fn(_rebuild(plain, leaves), cfg, batch)
    wgrads = torch.autograd.grad(want, list(leaves.values()))
    assert float(loss) == pytest.approx(float(want), abs=1e-5)
    got = _flat(sharding.unplace(grads))
    for (k, g), wg in zip(leaves.items(), wgrads):
        assert (got[k] - wg).abs().max() <= 1e-4 * wg.abs().max(), k


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _rebuild(tree, leaves, prefix=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, prefix + (k,))
                for k, v in tree.items()}
    return leaves[prefix]


def test_optimizer_and_accum_dtype_flags(tmp_path):
    """``--optimizer adafactor --accum-dtype bfloat16`` (ROADMAP item 12c)
    is accepted and recorded; the Adafactor state's bytes equal the closed
    form (a row and a column vector of f32 for every matrix, the vector
    itself otherwise), and bf16 accumulators cut the bytes the
    micro-batches accumulate in."""
    from repro_torch.models import model
    assert dryrun.main(["--arch", "whisper-tiny", "--shape", "train_4k",
                        "--optimizer", "adafactor", "--accum-dtype",
                        "bfloat16", "--out", str(tmp_path)]) == 0
    res = json.loads((tmp_path / "whisper-tiny_train_4k_single.json")
                     .read_text())
    assert res["status"] == "ok", res
    assert (res["optimizer"], res["accum_dtype"]) == ("adafactor",
                                                     "bfloat16")
    p = dryrun.plan("whisper-tiny", SHAPES["train_4k"],
                    optimizer="adafactor", accum_dtype="bfloat16")
    _, opt_state, _, _ = dryrun.build_state(p)
    state = sum(math.prod(pl.shape) * 4 for _, pl in
                sharding.placed_leaves(opt_state))
    closed = 0
    for t in _flat(model.abstract_params(p.cfg)).values():
        s = tuple(t.shape)
        closed += 4 * (math.prod(s[:-1]) + math.prod(s[:-2]) * s[-1]
                       if len(s) >= 2 else math.prod(s))
    assert state == closed
    cfg = small("qwen3-0.6b")
    counted = {}
    for adt in ("float32", "bfloat16"):
        q = dryrun.plan("qwen3-0.6b", _cut("train_4k"), config=cfg,
                        accum_dtype=adt)
        q = dataclasses.replace(q, microbatches=2)
        counted[adt] = dryrun.count_step(q, dryrun.build_state(q)).bytes
    assert counted["bfloat16"] < counted["float32"]
