"""Launch costing in the port (``repro_torch.launch.costing``,
``roofline``, ``counting``) against the reference's contracts on the CPU.

* The six closed-form columns key for key against ``repro.launch.
  costing``'s, on reduced and full qwen3-0.6b and deepseek-moe-16b, at 2,
  4 and 8 pods and the three wires (the reference's link rate patched into
  the port's ``ICI_BW`` for the worker-shard column; the pods' link, 50
  GB/s, is the same number in both).
* ``model_flops_estimate`` for the 11 archs x 4 shapes, and ``analyze``
  field for field with the reference's v5e constants patched in.
* The kernel costs: PERF.md's bound column at its shapes, and the flash
  formula's flops against ``FlopCounterMode``'s count of the plain version
  (non-causal).
* Every kernel wrapper on meta: outputs of the CPU output's shape, dtype
  and strides, no launch or regime counted, one call recorded with its
  cost, as on the CPU.
* A counted step on meta equals the same step on the CPU in flops, bytes
  and kernel calls: reduced dense, moe, ssm, hybrid, whisper and vlm, in
  train, prefill and decode, scanned and under remat.
* ``train_cost`` against the whole step's count (the reference's [0.9,
  2.0] composition gate), the gradient all-reduce's closed form, and
  expert parallelism's exchange bytes on a 4 x 2 meta mesh against their
  closed form.

None of these compiles a model with XLA or trains with JAX: the reference
side is closed forms and ``jax.eval_shape``.
"""
from __future__ import annotations

import dataclasses
import functools
import json

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.config import SHAPES as JSHAPES
from repro.config import reduced as jreduced
from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import get_config as jget_config
from repro.launch import costing as jcosting
from repro.launch import roofline as jroofline
from repro.models import model as jmodel
from repro.scenarios import compile_scenario as jcompile_scenario
from repro.scenarios import get_scenario as jget_scenario

from repro_torch import counting, sharding
from repro_torch.config import SHAPES, ShapeConfig, reduced
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels.cost import kernel_cost
from repro_torch.launch import costing
from repro_torch.launch import roofline as rf
from repro_torch.launch import steps
from repro_torch.models import model, moe, moe_eplocal
from repro_torch.scenarios import compile_scenario, get_scenario
from torch_threads import one_torch_thread  # noqa: F401

V5E = {"PEAK_FLOPS": 197e12, "HBM_BW": 819e9, "ICI_BW": 50e9}


@pytest.fixture
def cached_reference_params(monkeypatch):
    """The reference's columns call ``abstract_params`` on every call; the
    same config's tree is the same, so keep it (the reference's code is
    unchanged; only its module attribute is wrapped for this test)."""
    monkeypatch.setattr(jmodel, "abstract_params",
                        functools.lru_cache(maxsize=8)(jmodel.abstract_params))


def plain(x):
    """A column as plain JSON values (numpy scalars and tuples made
    plain), for key-for-key equality."""
    return json.loads(json.dumps(x, default=lambda v: v.item()
                                 if hasattr(v, "item") else list(v)))


CFGS = {"qwen3-0.6b": ("reduced", "full"),
        "deepseek-moe-16b": ("reduced", "full")}


def cfg_pair(arch, size):
    j, t = jget_config(arch), get_config(arch)
    return (jreduced(j), reduced(t)) if size == "reduced" else (j, t)


@pytest.mark.parametrize("arch,size", [(a, s) for a in CFGS
                                       for s in CFGS[a]])
def test_six_columns_equal_the_references(arch, size, monkeypatch,
                                          cached_reference_params):
    """Each closed-form column, key for key, at 2, 4 and 8 pods and the
    three wires."""
    jcfg, cfg = cfg_pair(arch, size)
    monkeypatch.setattr(rf, "ICI_BW", V5E["ICI_BW"])
    assert rf.DCN_BW == jroofline.ICI_BW
    for wire in (None, "bf16", "int8"):
        for pods in (2, 4, 8):
            for fn, args, kw in (
                    ("gossip_cost", (pods,), {}),
                    ("gossip_cost", (pods,), {"out_degree": 1.0}),
                    ("participation_cost", (10_000, 64),
                     {"dropout": 0.05, "straggle": 0.1}),
                    ("participation_cost", (40 * pods, pods), {}),
                    ("privacy_cost", (pods, 50), {"dp_sigma": 1.0}),
                    ("privacy_cost", (pods, 50), {"secagg": False}),
                    ("worker_shard_cost", (40 * pods, pods), {})):
                want = getattr(jcosting, fn)(jcfg, *args, wire=wire, **kw)
                got = getattr(costing, fn)(cfg, *args, wire=wire, **kw)
                assert plain(got) == plain(want), (fn, wire, pods)
        spec = get_scenario("storm", 4)
        got = costing.scenario_gossip_cost(
            cfg, 4, compile_scenario(spec, 4, 50, device="cpu"), wire=wire)
        want = jcosting.scenario_gossip_cost(
            jcfg, 4, jcompile_scenario(jget_scenario("storm", 4), 4, 50),
            wire=wire)
        assert plain(got) == plain(want)
    for kind in ("defta", "fedavg", "cross_device"):
        for kw in ({}, {"tick": True}, {"use_ef": True},
                   {"scenario": False}):
            if kind == "fedavg" and "use_ef" in kw:
                continue
            assert costing.telemetry_cost(8, 50, kind=kind, **kw) == \
                jcosting.telemetry_cost(8, 50, kind=kind, **kw)


def test_model_flops_estimate_equals_the_references():
    assert ARCH_IDS == JARCH_IDS and list(SHAPES) == list(JSHAPES)
    for arch in ARCH_IDS:
        for name in SHAPES:
            assert rf.model_flops_estimate(get_config(arch), SHAPES[name]) \
                == jroofline.model_flops_estimate(jget_config(arch),
                                                  JSHAPES[name])


def test_analyze_equals_the_references_with_its_constants(monkeypatch):
    for k, v in V5E.items():
        monkeypatch.setattr(rf, k, v)
    coll = {"all-gather": 0.0, "all-reduce": 3.5e9, "reduce-scatter": 0.0,
            "all-to-all": 1.25e9, "collective-permute": 2e8}
    for cost in ({"flops": 4.2e15, "bytes accessed": 3.1e12},
                 {"flops": 1e12, "bytes accessed": 9e12}, {}):
        args = ("qwen3-0.6b", "train_4k", "single", 8, cost, "", 2.5e16,
                7.5e10)
        got = rf.analyze(*args, coll_override=coll).to_dict()
        want = jroofline.analyze(*args, coll_override=coll).to_dict()
        assert got == want
    with pytest.raises(ValueError, match="HLO"):
        rf.analyze(*args[:5], "%x = f32[2] all-reduce(...)", *args[6:],
                   coll_override=coll)
    with pytest.raises(ValueError, match="coll_override"):
        rf.analyze(*args)


def test_kernel_bounds_at_perf_md_shapes():
    """PERF.md's kernel table bound column (µs), from the one source the
    card's script imports."""
    us = lambda r: round(r[0] * 1e3, 3)                    # noqa: E731
    assert us(rf.bound("gossip_mix", 22, 0, 5, 2048, 4)) == 0.108
    assert us(rf.bound("gossip_mix_sparse", 22, 110, 5, 2048, 4)) == 0.108
    assert us(rf.bound("gossip_mix_quant", 22, 110, 5, 2048, 1)) == 0.068
    assert round(rf.flash_bound(64, 1, 512, 128, 2)[0] * 1e3, 2) == 10.02
    assert us(rf.route_slots_bound(2048, 64, 6, 240, 4)) == 0.219
    assert us(rf.router_bound(2048, 64, 6, 4)) == 0.186
    ms, by, cuda_core = rf.ssd_bound(32, 48, 256, 128, 64)
    assert (round(ms * 1e3, 2), by, round(cuda_core * 1e3, 2)) == \
        (63.54, "bytes", 103.57)
    # the whisper encoder's flash is bound by its operations (PERF.md)
    assert rf.flash_bound(4, 6, 1500, 64, 2, causal=False)[1] == \
        "operations"


@pytest.mark.parametrize("s,sk", [(40, 40), (24, 56)])
def test_flash_flops_equal_flop_counter_of_the_plain_version(s, sk):
    q = torch.randn(2, 3, s, 32)
    k, v = torch.randn(2, 3, sk, 32), torch.randn(2, 3, sk, 32)
    with FlopCounterMode(display=False) as fc:
        ref.flash_attention_ref(q, k, v, causal=False)
    flops, nbytes = kernel_cost("flash_attention", b=2, h=3, s=s, d=32,
                                itemsize=4, causal=False, sk=sk)
    assert flops == fc.get_total_flops()
    assert nbytes == 4 * (q.numel() * 2 + k.numel() + v.numel())
    # causal and windowed: the visible pairs
    f_c, _ = kernel_cost("flash_attention", b=1, h=1, s=s, d=1,
                         itemsize=4, causal=True)
    f_w, _ = kernel_cost("flash_attention", b=1, h=1, s=s, d=1,
                         itemsize=4, causal=True, window=5)
    assert f_c == 4 * s * (s + 1) // 2
    assert f_w == 4 * sum(min(i + 1, 5) for i in range(s))


def wrapper_calls():
    """{kernel name[-case]: build(make) -> (wrapper, args)} for the seven
    wrappers, on the shapes and dtypes that reach all eight kernels (the
    SSD kernel at P = 64 and 16); the tensors come from ``make(shape,
    dtype)``."""
    def gossip(make, wdt, name):
        idx = make((3, 2), torch.int32)
        val, w = make((3, 2), torch.float32), make((3, 40), wdt)
        if name == "gossip_mix":
            return ops.gossip_mix, (make((3, 3), torch.float32), w)
        if name == "gossip_mix_sparse":
            return ops.gossip_mix_sparse, (idx, val, w)
        return ops.gossip_mix_quant, (idx, val, make((3,), torch.float32),
                                      w)

    def flash(make, dtype, d):
        q = make((2, 12, 3, d), dtype).transpose(1, 2)
        k = make((2, 12, 3, d), dtype).transpose(1, 2)
        return (lambda q, k: ops.flash_attention(q, k, k, causal=True),
                (q, k))

    def ssd(make, p):
        x = make((2, 20, 3, p), torch.float32).transpose(1, 2)
        return ops.ssd_chunk, (make((2, 20, 16), torch.float32),
                               make((2, 20, 16), torch.float32),
                               make((2, 3, 20), torch.float32),
                               make((2, 3, 20), torch.float32), x)
    return {
        "gossip_mix": lambda m: gossip(m, torch.bfloat16, "gossip_mix"),
        "gossip_mix_sparse": lambda m: gossip(m, torch.float32,
                                              "gossip_mix_sparse"),
        "gossip_mix_quant": lambda m: gossip(m, torch.int8,
                                             "gossip_mix_quant"),
        "flash_attention_tc": lambda m: flash(m, torch.bfloat16, 64),
        "flash_attention": lambda m: flash(m, torch.float32, 42),
        "moe_router": lambda m: (lambda x: ops.moe_router_topk(x, 3),
                                 (m((10, 16), torch.float32),)),
        "moe_route_slots": lambda m: (
            lambda x: ops.moe_route_slots(x, 3, 4),
            (m((10, 16), torch.bfloat16),)),
        "ssd_chunk_tc": lambda m: ssd(m, 64),
        "ssd_chunk_tc-p16": lambda m: ssd(m, 16),
    }


@pytest.mark.parametrize("kernel", sorted(wrapper_calls()))
def test_wrapper_meta_outputs_match_the_cpu_and_launch_nothing(kernel):
    build = wrapper_calls()[kernel]
    g = torch.Generator().manual_seed(0)

    def cpu(shape, dtype):
        if dtype in (torch.int8, torch.int32):
            return torch.randint(0, 3, shape, generator=g, dtype=dtype)
        return torch.randn(shape, generator=g).to(dtype)

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")
    out = {}
    before = (dict(ops.LAUNCHES), dict(ops.REGIMES))
    for name, make in (("cpu", cpu), ("meta", meta)):
        fn, args = build(make)
        with counting.Counter() as c:
            res = fn(*args)
        res = res if isinstance(res, tuple) else (res,)
        out[name] = ([(tuple(t.shape), t.dtype, t.stride()) for t in res],
                     dict(c.calls), c.flops, c.bytes)
    assert all(t.is_meta for t in res)
    assert out["meta"] == out["cpu"]
    assert out["meta"][1] == {kernel.split("-")[0]: 1} \
        and out["meta"][2] > 0
    assert (dict(ops.LAUNCHES), dict(ops.REGIMES)) == before


def materialize(tree, gen, vocab):
    if isinstance(tree, dict):
        return {k: materialize(v, gen, vocab) for k, v in tree.items()}
    if not isinstance(tree, torch.Tensor):
        return tree
    if tree.dtype.is_floating_point:
        return (torch.randn(tree.shape, generator=gen) * 0.1).to(tree.dtype)
    return torch.randint(0, vocab, tree.shape, generator=gen,
                         dtype=tree.dtype)


def count(cfg, shape, device, moe_strategy="grouped"):
    """The step of ``shape.mode`` counted on ``device`` ("meta" or
    "cpu", random weights and inputs)."""
    gen = torch.Generator().manual_seed(0)
    inputs = steps.input_specs(cfg, shape)
    if shape.mode == "train":
        params, state, opt = steps.abstract_state(cfg, "adam")
    else:
        params = model.abstract_params(cfg)
    if device == "cpu":
        params = materialize(params, gen, cfg.vocab_size)
        inputs = materialize(inputs, gen, cfg.vocab_size)
        if shape.mode == "train":
            state = opt.init(params)
    with counting.Counter() as c:
        if shape.mode == "train":
            steps.build_train_step(cfg, opt, moe_strategy=moe_strategy)(
                params, state, torch.zeros((), dtype=torch.int64,
                                           device=device), inputs)
        elif shape.mode == "prefill":
            steps.build_prefill_step(cfg, moe_strategy=moe_strategy)(
                params, inputs)
        else:
            kw = {"enc_out": inputs["enc_out"]} if "enc_out" in inputs \
                else {}
            steps.build_decode_step(cfg)(params, inputs["tokens"],
                                         inputs["cache"], inputs["pos"],
                                         **kw)
    return c


FAMILIES = ["qwen3-0.6b", "deepseek-moe-16b", "mamba2-780m",
            "jamba-v0.1-52b", "whisper-tiny", "internvl2-2b"]


def scanned(arch):
    """The reduced config, bf16, scanned and under remat with a pattern
    that repeats."""
    cfg = reduced(get_config(arch))
    return dataclasses.replace(cfg, num_layers=4, scan_layers=True,
                               remat=True, dtype="bfloat16")


@pytest.mark.parametrize("arch", FAMILIES)
def test_meta_step_counts_equal_the_cpus(arch):
    cfg = scanned(arch)
    for mode in ("train", "prefill", "decode"):
        shape = ShapeConfig(mode, 24, 2, mode)
        m, c = count(cfg, shape, "meta"), count(cfg, shape, "cpu")
        assert (m.flops, m.bytes, dict(m.calls)) == \
            (c.flops, c.bytes, dict(c.calls)), (mode, dict(m.ops),
                                                dict(c.ops))
        assert m.flops > 0 and m.peak_bytes > 0
        if mode != "decode" or cfg.moe is not None:
            assert sum(m.calls.values()) > 0


def test_train_cost_composes_to_the_whole_steps_count():
    """The reference's gate: scan-corrected train_cost within [0.9, 2.0]
    of an unrolled lowering's flops, on reduced granite-3-2b (6 layers,
    d_model 256, bf16, scanned, remat). The port's whole step runs every
    layer, so its train_cost composes to the whole step's count."""
    cfg = dataclasses.replace(
        reduced(get_config("granite-3-2b"), num_layers=6, d_model=256),
        dtype="bfloat16", scan_layers=True, remat=True)
    shape = ShapeConfig("t", 128, 8, "train")
    mesh = sharding.make_mesh((2, 2), ("data", "model"), ["meta"] * 4)
    rules = {"batch": ("data",)}
    f_corr, b_corr, coll = costing.train_cost(cfg, shape, mesh, rules,
                                              optimizer="sgd")
    params, state, opt = steps.abstract_state(cfg, "sgd")
    inputs = steps.input_specs(cfg, shape)
    with counting.Counter(split=2, grad_ranks=2) as c:
        c.track(params)
        steps.build_train_step(cfg, opt)(
            params, state, torch.zeros((), dtype=torch.int64,
                                       device="meta"), inputs)
    ratio = f_corr / c.per_device("flops")
    print("train_cost / whole step flops", ratio,
          "bytes", b_corr / c.per_device("bytes"))
    assert 0.9 < ratio < 2.0
    assert coll == c.collectives()
    grad_bytes = sum(t.numel() * t.element_size() for t in
                     counting._tensors(params))
    assert coll["all-reduce"] == 2 * (2 - 1) / 2 * grad_bytes
    assert c.closed_form == {"all-reduce"}


@pytest.mark.parametrize("shape", [(4, 2), (8, 1)])
def test_eplocal_exchange_bytes_on_a_meta_mesh(shape):
    """On a meta mesh the counted all-to-all bytes equal ``EXCHANGE`` and
    PR 28's closed form (the dispatch into every device, the combine into
    each data shard), and each device's work is its own."""
    ep, tp = shape
    cfg = dataclasses.replace(reduced(get_config("deepseek-moe-16b"),
                                      max_experts=8), dtype="bfloat16")
    params = model.abstract_params(cfg)["layers"]["1"]["moe"]
    b, s, d = 8, 16, cfg.d_model
    x = torch.empty((b, s, d), dtype=torch.bfloat16, device="meta")
    mesh = sharding.make_mesh(shape, ("data", "model"), ["meta"] * 8)
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    rows = e * moe.grouped_capacity(b // ep * s, e, k)
    moe_eplocal.reset_exchange()
    with sharding.logical_rules(mesh, {}), counting.Counter(split=ep) as c:
        moe_eplocal.moe_eplocal(params, cfg, x)
    want = {"dispatch": ep * tp * rows * d * 2 * (ep - 1) // ep,
            "combine": ep * rows * d * 2 * (ep - 1) // ep}
    assert dict(moe_eplocal.EXCHANGE) == want
    total = c.collectives(per_device=False)
    assert total["all-to-all"] == sum(want.values())
    # the busiest device: a data shard's first, which takes its dispatch
    # blocks and its shard's combine
    assert c.collectives()["all-to-all"] == \
        want["dispatch"] / (ep * tp) + want["combine"] / ep
    assert c.calls == {"moe_route_slots": ep}
    assert 0 < c.per_device("flops") < c.flops


@pytest.mark.parametrize("wire", [None, "int8"])
def test_pod_ring_counts_as_collective_permute(wire):
    """The cross-pod ring's blocks count as collective-permute bytes from
    their source pod: the whole program's equal ``gossip.RING`` and
    ``ppermute_ring_bytes``, a pod's its own payloads."""
    from repro_torch.core import gossip
    w = 4
    g = torch.Generator().manual_seed(0)
    rows = [{"a": torch.randn(6, 5, generator=g),
             "b": torch.randn(7, generator=g)} for _ in range(w)]
    P = torch.full((w, w), 1.0 / w)
    gossip.reset_ring()
    with counting.Counter() as c:
        gossip.mix_pytree_ppermute(P, rows, [torch.device("cpu")] * w,
                                   wire=wire)
    nnz, _ = rf.ppermute_ring_bytes(37, np.ones((w, w), bool), wire, rows=2)
    total = c.collectives(per_device=False)["collective-permute"]
    assert total == gossip.RING["bytes"] == nnz
    assert c.collectives()["collective-permute"] == nnz / w
