"""The yardstick on the CPU against closed forms at small shapes: model
FLOPs, the kernels' operations, bytes and bounds, the trace reductions,
and the per-layer readers."""
from __future__ import annotations

import pytest

from bench import roofline, trace
from bench.flops import forward_flops, train_flops
from bench.run import load_cell, read_metric
from bench.tests.small import CELLS

MOE = {"family": "moe", "num_layers": 2, "first_dense": 1, "d_model": 4,
       "num_heads": 2, "num_kv_heads": 1, "head_dim": 2, "d_ff": 6,
       "vocab_size": 10, "moe": {"num_experts": 4, "top_k": 2,
                                 "num_shared_experts": 1, "d_expert": 3}}
SSM = {"family": "ssm", "num_layers": 1, "d_model": 4, "vocab_size": 10,
       "ssm": {"d_state": 2, "d_conv": 4, "expand": 2, "head_dim": 4,
               "chunk_size": 2}}


def test_moe_flops_closed_form():
    # a token's matrix parameters: unembedding 4 x 10; each layer's q, k,
    # v, o 2*4*2*2 + 2*4*1*2; the dense FFN 3*4*6; the router 4*4 and
    # (top 2 + 1 shared) SwiGLU experts of 3*4*3
    per_token = 40 + 48 + 72 + 48 + (16 + 108)
    # causal attention: 4 * heads * head dim * S(S+1)/2 a layer and row
    attn = 2 * 2 * (4 * 2 * 2 * 6)
    assert forward_flops(MOE, 2, 3) == 2 * per_token * 6 + attn
    assert train_flops(MOE, 2, 3) == 3 * (2 * per_token * 6 + attn)


def test_ssm_flops_closed_form():
    # in_proj 4 x (2*8 + 2*2 + 2 heads), out_proj 8 x 4, unembedding 4 x 10
    per_token = 4 * 22 + 8 * 4 + 40
    # two chunks of 2: 3 causal pairs of (2N + 2HP) flops, chunk states
    # and their output 2 * 2HPNq
    ssd = 2 * (3 * (2 * 2 + 2 * 2 * 4) + 2 * (2 * 2 * 4 * 2 * 2))
    assert forward_flops(SSM, 1, 4) == 2 * per_token * 4 + ssd


@pytest.mark.parametrize("name", CELLS)
def test_cell_flops_are_positive_and_scale(name):
    cfg = load_cell(name)["config"]
    one = train_flops(cfg, 1, 1024)
    assert one > 0 and train_flops(cfg, 2, 1024) == 2 * one


@pytest.mark.parametrize("cost,ops,nbytes", [
    (roofline.flash_cost(1, 2, 4, 8, 2), {"bf16": 4 * 2 * 10 * 8},
     4 * 2 * 4 * 8 * 2),
    (roofline.flash_cost(1, 1, 4, 8, 4), {"fp32": 4 * 10 * 8},
     4 * 4 * 8 * 4),
    (roofline.route_slots_cost(8, 4, 2, 8, 4), {"fp32": 8 * 4 * (3 + 2)},
     8 * 4 * 4 + 8 * 2 * 8 + 8 * 2 * 4 + 4 * 8 * 4),
    (roofline.ssd_cost(1, 2, 4, 2, 3),
     {"tf32": 3 * 10 * (4 + 2 * 3 * 2), "fp32": 10 * 2 * 4},
     4 * (2 * 4 * 2 + 2 * 2 * 4 + 2 * 2 * 4 * 3)),
])
def test_kernel_costs(cost, ops, nbytes):
    assert cost == (ops, nbytes)


def test_bound_is_the_slowest_pipe():
    assert roofline.bound_s({"bf16": 989e12}, 0) == pytest.approx(1.0)
    assert roofline.bound_s({"fp32": 67e12}, 3.35e12) == pytest.approx(1.0)
    assert roofline.bound_s({"tf32": 1.0}, 6.7e12) == pytest.approx(2.0)


def test_busy_counts_overlap_once():
    dev = [(0, 10, "a"), (5, 20, "b"), (30, 40, "a")]
    assert trace.merged(dev) == [[0, 20], [30, 40]]
    assert trace.busy_ns(dev) == 30
    assert trace.by_name(dev) == [("a", 20e-9, 2), ("b", 15e-9, 1)]


def test_idle_gaps_labelled_by_the_host():
    dev = [(0, 100_000, "k"), (200_000, 250_000, "k"),
           (255_000, 300_000, "k")]
    spans = [(0, 400_000, "bench.train_step")]
    host = [(100_000, 180_000, "cudaLaunchKernel")]
    gaps = trace.idle_gaps(dev, host, spans, 0, 400_000)
    assert gaps == [("bench.train_step | cudaLaunchKernel", 1e-4),
                    ("bench.train_step | python", 1e-4),
                    ("short gaps (< 20 us)", 5e-6)]


NOTHING = {"config": load_cell(CELLS[1])["config"],
           "traffic": load_cell(CELLS[1])["traffic"],
           "window": {"samples": 0, "model_flops": 0, "wall_s": 1.0,
                      "step_s": [], "round_s": []}}


@pytest.mark.parametrize("metric", [
    "samples_per_s", "train_step.ms", "train_step.mfu", "pod_round.ms", "device.idle_share",
    "flash_attention_tc_roofline", "moe_route_slots_roofline"])
def test_reader_finds_nothing(metric):
    assert read_metric(metric, NOTHING) is None


def test_readers_on_a_record():
    cell = load_cell(CELLS[1])
    t = cell["traffic"]
    cost = roofline.flash_cost(t["batch_per_pod"], 16, t["seq_len"], 128, 2)
    bound = roofline.bound_s(*cost)
    rec = {"config": cell["config"], "traffic": t,
           "window": {"samples": 6000, "wall_s": 4.0,
                      "model_flops": 2 * roofline.BF16_FLOPS,
                      "step_s": [0.5, 1.5], "round_s": [0.25]},
           "setup_s": 12.5, "window_peak_bytes": 7e9,
           "window_s": 2.0, "busy_s": 1.5,
           "kernels": {"flash_tc_kernel<64>": (1, 2 * bound),
                       "flash_tc_kernel<128>": (3, 6 * bound),
                       "other": (9, 1.0)},
           "launches": {"flash_attention_tc": 4}}
    assert read_metric("samples_per_s", rec) == pytest.approx(1500.0)
    assert read_metric("peak_mem_gb", rec) == pytest.approx(7.0)
    assert read_metric("setup_s", rec) == pytest.approx(12.5)
    assert read_metric("train_step.ms", rec) == pytest.approx(1000.0)
    assert read_metric("train_step.mfu", rec) == pytest.approx(50.0)
    assert read_metric("pod_round.ms", rec) == pytest.approx(250.0)
    assert read_metric("device.idle_share", rec) == pytest.approx(25.0)
    assert read_metric("flash_attention_tc_roofline",
                       rec) == pytest.approx(50.0)
    rec["launches"]["flash_attention_tc"] = 5   # shapes unknown: nothing
    assert read_metric("flash_attention_tc_roofline", rec) is None
