"""The port's LM training path against live JAX on the CPU.

* ``model.loss_fn`` and ``launch.steps.build_train_step`` on every reduced
  architecture (``test_arch_smoke.py``'s; whisper with its frames, the vlm
  with its vision embeddings): two SGD steps from the reference's initial
  params, losses and params within 1e-4.
* Micro-batched = full batch (``test_distributed.py``'s world), and both
  equal the reference's.
* The FL step and the gossip steps over pods (``test_distributed.py``'s
  pod worlds, in process): pods train apart, uniform gossip makes them
  equal; the int8 + EF21 gossip step's params and residuals within 1e-6
  (the two packages' int8 codes agree).
* The optimizers (SGD with momentum and weight decay, AdamW, Adafactor) on
  given gradients, and the schedules, within 1e-6.
* The checkpoint files: a tree the port saves loads in the reference and
  the other way round, bf16 words bit for bit, the files byte for byte.
* The flash kernel's autograd wrapper on the CPU, and the router and SSD
  kernels' autograd Functions on the card side (``ops._on_card`` forced,
  ``ops._launch`` filling the kernels' outputs from their plain versions):
  gradients equal the plain versions', the routers' at the kernel's own
  picks on a tie. The reduced DeepSeekMoE, Mamba2 and Jamba also take
  their loss and two train steps through that card side.
* The geometry channel's half-mass tie on its recorded inputs (ROADMAP.md
  queue 3, item 3): the reference's float32 ``weighted_median`` leaves the
  exact lower weighted median there, the port's ``anchored_median`` does
  not.
"""
from __future__ import annotations

import ctypes
import dataclasses
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jload
from repro.checkpoint import save_checkpoint as jsave
from repro.config import reduced as jreduced
from repro.configs import get_config as jget_config
from repro.core import dts as jdts
from repro.launch import steps as jsteps
from repro.models import model as jmodel
from repro.optim import make_optimizer as jmake_optimizer
from repro.optim import schedules as jschedules

from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.config import reduced
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_jax
from repro_torch.core import dts, pods
from repro_torch.kernels import ops, ref
from repro_torch.launch import steps
from repro_torch.models import model
from repro_torch.optim import make_optimizer, schedules
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)
# the int8 wire: port and reference quantize alike (round half to even on
# the same f32 scale), so the codes agree and the decoded params and EF21
# residuals differ only by f32 rounding
INT8_TOL = dict(rtol=0, atol=1e-6)


ARCHS = ["paper-small", "qwen3-0.6b", "qwen2.5-32b", "granite-3-2b",
         "granite-20b", "deepseek-moe-16b", "kimi-k2-1t-a32b",
         "mamba2-780m", "jamba-v0.1-52b", "whisper-tiny", "internvl2-2b"]


def np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def assert_tree_close(got, want, **tol):
    """A port tree (nested dicts of tensors) against a reference tree."""
    got = {k: v.detach().float().numpy()
           for k, v in pods.flatten(got).items()}
    leaves = jax.tree.leaves(np_tree(want))
    assert len(leaves) == len(got)
    want = dict(zip(sorted(got), leaves))
    for k in got:
        np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                   **(tol or TOL))


def pair(arch, seed=1):
    jcfg, cfg = jreduced(jget_config(arch)), reduced(get_config(arch))
    jp = jmodel.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, cfg, jp, model_params_from_jax(np_tree(jp), "cpu")


def batches(cfg, b=2, s=16, seed=0):
    """Tokens and labels, plus the frames of an encoder-decoder and the
    vision embeddings of a vlm, from numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s))
    labs = rng.integers(0, cfg.vocab_size, (b, s))
    labs[0, -3:] = -1                              # masked targets
    jb = {"tokens": jnp.asarray(toks, jnp.int32),
          "labels": jnp.asarray(labs, jnp.int32)}
    tb = {"tokens": torch.tensor(toks), "labels": torch.tensor(labs)}
    extra = {}
    if cfg.is_encoder_decoder:
        extra["frame_embeds"] = (cfg.encoder_seq_len, cfg.d_model)
    if cfg.family == "vlm":
        extra["vision_embeds"] = (cfg.num_vision_tokens, cfg.d_model)
    for name, shape in extra.items():
        x = rng.normal(size=(b,) + shape).astype(np.float32)
        jb[name], tb[name] = jnp.asarray(x), torch.tensor(x)
    return jb, tb


def at(ptr: int, shape, strides, dtype):
    """A CPU tensor over the memory at ``ptr`` (a kernel argument), of
    ``shape`` and element ``strides``."""
    span = 1 + sum((n - 1) * st for n, st in zip(shape, strides))
    size = torch.tensor([], dtype=dtype).element_size()
    buf = (ctypes.c_char * (span * size)).from_address(ptr)
    return torch.frombuffer(buf, dtype=dtype, count=span).as_strided(
        shape, strides)


def contiguous(shape):
    return torch.empty(shape).stride()


CODE_DTYPE = {0: torch.float32, 1: torch.bfloat16}


def emulated_launch(calls):
    """An ``ops._launch`` for CPU tensors: it reads the kernel's inputs and
    writes its outputs through the pointers the wrapper passes, computing
    them with the plain version, and records the kernel's name."""
    def launch(name, out, *a):
        calls.append(name)
        if name in ("moe_router", "moe_route_slots"):
            t, e, k = a[-4:-1] if name == "moe_router" else a[7:10]
            logits = at(a[0], (t, e), (e, 1), CODE_DTYPE[a[-1]])
            if name == "moe_router":
                got = ref.moe_router_topk_ref(logits, k)
                shapes = [(t, k)] * 2
            else:
                cap = a[10]
                got = ref.moe_route_slots_ref(logits, k, cap)
                shapes = [(t, k)] * 3 + [(e * cap,)]
            for ptr, shape, v in zip(a[1:], shapes, got):
                at(ptr, shape, contiguous(shape), v.dtype).copy_(v)
        elif name.startswith("ssd_chunk"):
            g, h, t, n, p = a[6:11]
            C, B = (at(ptr, (g, t, n), contiguous((g, t, n)), torch.float32)
                    for ptr in a[:2])
            acum, dt = (at(ptr, (g, h, t), contiguous((g, h, t)),
                           torch.float32) for ptr in a[2:4])
            x = at(a[4], (g, h, t, p), a[11:14] + (1,), torch.float32)
            out.copy_(ref.ssd_chunk_ref(C, B, acum, dt, x))
        else:                                    # the flash kernels
            tc = name == "flash_attention_tc"
            b, h = (a[4], a[5]) if tc else (a[4] // a[5], a[5])
            sq, sk, d = a[6:9]
            dtype = torch.bfloat16 if tc else CODE_DTYPE[a[-1]]
            q = at(a[0], (b, h, sq, d), a[9:12] + (1,), dtype)
            k, v = (at(ptr, (b, h, sk, d), a[12:15] + (1,), dtype)
                    for ptr in a[1:3])
            out.copy_(ref.flash_attention_ref(q, k, v, causal=bool(a[18]),
                                              window=a[19]))
        return out
    return launch


def card_side(monkeypatch):
    """Run the wrappers' card-side branches on CPU tensors; returns the
    list of kernels launched."""
    calls = []
    monkeypatch.setattr(ops, "_ROUTE_SCRATCH", {})
    monkeypatch.setattr(ops, "_ROUTE_RETIRED", [])
    monkeypatch.setattr(ops, "_on_card", lambda *ts: True)
    monkeypatch.setattr(ops, "_launch", emulated_launch(calls))
    return calls


# trained here also through the card-side branches, with the kernels
# each must launch
CARD_SIDE = {"deepseek-moe-16b": {"flash_attention", "moe_route_slots"},
             "mamba2-780m": {"ssd_chunk_tc"},
             "jamba-v0.1-52b": {"flash_attention", "moe_route_slots",
                                "ssd_chunk_tc"}}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_train_step_match_jax(arch, monkeypatch):
    """Loss and two SGD steps; the moe, ssm and hybrid families a second
    time through the card-side branches (the kernels' autograd
    Functions), against the same reference step."""
    jcfg, cfg, jp, tp0 = pair(arch)
    jb, tb = batches(cfg)
    jloss, jm = jmodel.loss_fn(jp, jcfg, jb)
    jopt = jmake_optimizer("sgd", 0.05)
    jstep = jax.jit(jsteps.build_train_step(jcfg, jopt))
    js, jlosses = jopt.init(jp), []
    for i in range(2):
        jp, js, _, jl = jstep(jp, js, jnp.int32(i), jb)
        jlosses.append(float(jl))
    for card in (False, True) if arch in CARD_SIDE else (False,):
        calls = card_side(monkeypatch) if card else []
        loss, m = model.loss_fn(tp0, cfg, tb)
        np.testing.assert_allclose(float(loss), float(jloss), **TOL)
        np.testing.assert_allclose(float(m["ce"]), float(jm["ce"]), **TOL)
        opt = make_optimizer("sgd", 0.05)
        tstep = steps.build_train_step(cfg, opt)
        tp, ts = tp0, opt.init(tp0)
        for i in range(2):
            tp, ts, _, tl = tstep(tp, ts, i, tb)
            np.testing.assert_allclose(float(tl), jlosses[i], **TOL)
        assert_tree_close(tp, jp)
        if card:
            assert set(calls) == CARD_SIDE[arch]


def test_microbatched_step_equals_full_batch_and_the_reference():
    jcfg, cfg, jp, tp = pair("qwen3-0.6b", seed=0)
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (8, 16), 0,
                                         cfg.vocab_size))
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    tb = {"tokens": torch.tensor(toks), "labels": torch.tensor(toks)}
    jopt, opt = jmake_optimizer("sgd", 0.01), make_optimizer("sgd", 0.01)
    out = {}
    for mb in (1, 4):
        jp2, _, _, jl = jax.jit(jsteps.build_train_step(
            jcfg, jopt, microbatches=mb))(jp, jopt.init(jp), jnp.int32(0),
                                          jb)
        tp2, _, _, tl = steps.build_train_step(cfg, opt, microbatches=mb)(
            tp, opt.init(tp), 0, tb)
        np.testing.assert_allclose(float(tl), float(jl), **TOL)
        assert_tree_close(tp2, jp2)
        out[mb] = tp2
    a, b = pods.flatten(out[1]), pods.flatten(out[4])
    for k in a:        # the reference's own bound for this check
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), atol=3e-5)


def test_placed_microbatched_step_equals_the_reference():
    """Four micro-batches on a state placed on a (2, 2) mesh: the blocks'
    gradients accumulated block by block, then SGD per block (linear in
    the gradient, as the full-batch test above), against the reference's
    micro-batched step."""
    from repro_torch import sharding
    from repro_torch.launch.sharding_rules import base_rules
    jcfg, cfg, jp, tp = pair("qwen3-0.6b", seed=0)
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (8, 16), 0,
                                         cfg.vocab_size))
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    tb = {"tokens": torch.tensor(toks), "labels": torch.tensor(toks)}
    jopt, opt = jmake_optimizer("sgd", 0.01), make_optimizer("sgd", 0.01)
    jp2, _, _, jl = jax.jit(jsteps.build_train_step(
        jcfg, jopt, microbatches=4))(jp, jopt.init(jp), jnp.int32(0), jb)
    mesh = sharding.make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    rules = base_rules(False)
    with sharding.logical_rules(mesh, rules):
        pp, ps = steps.place_state(cfg, tp, opt.init(tp), "sgd", mesh,
                                   rules)
        tp2, _, _, tl = steps.build_train_step(cfg, opt, microbatches=4)(
            pp, ps, torch.zeros((), dtype=torch.int64), tb)
    assert sharding.is_placed(tp2)
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    assert_tree_close(sharding.unplace(tp2), jp2)


@pytest.fixture(scope="module")
def granite_pods():
    """test_distributed.py's pod world: reduced granite-3-2b, 2 pods, SGD
    0.05, [2, 4, 16] tokens; one FL step and the fp32 and int8 + EF21
    gossip steps through the reference, in process."""
    pods_n = 2
    jcfg, cfg = jreduced(jget_config("granite-3-2b")), \
        reduced(get_config("granite-3-2b"))
    key = jax.random.PRNGKey(0)
    params = jmodel.init_params(key, jcfg)
    jopt = jmake_optimizer("sgd", 0.05)
    stacked = jax.tree.map(lambda x: jnp.stack([x] * pods_n), params)
    toks = jax.random.randint(key, (pods_n, 4, 16), 0, jcfg.vocab_size)
    batch = {"tokens": toks, "labels": toks}
    p2, _, _, losses = jax.jit(jsteps.build_fl_train_step(jcfg, jopt))(
        stacked, jopt.init(stacked), jnp.int32(0), batch)
    P = jnp.full((pods_n, pods_n), 0.5)
    p3 = jax.jit(jsteps.build_gossip_step(jcfg))(p2, P)
    two = jax.tree.map(lambda x: jnp.stack([x, x + 0.01 * jnp.sign(x)]),
                       params)
    err0 = jax.tree.map(lambda x: jnp.zeros(x.shape, jnp.float32), two)
    q8, e8 = jax.jit(jsteps.build_gossip_step(
        jcfg, wire="int8", error_feedback=True))(two, P, err0)
    return dict(cfg=cfg, params=np_tree(params), toks=np.asarray(toks),
                p2=p2, losses=np.asarray(losses), p3=p3, two=np_tree(two),
                q8=q8, e8=e8)


def per_pod(stacked_np, n):
    return [model_params_from_jax(jax.tree.map(lambda a: a[p], stacked_np),
                                  "cpu") for p in range(n)]


def test_fl_step_pods_train_apart_and_gossip_mixes(granite_pods):
    g = granite_pods
    cfg = g["cfg"]
    opt = make_optimizer("sgd", 0.05)
    tp = pods.replicate(model_params_from_jax(g["params"], "cpu"),
                        ["cpu", "cpu"])
    b = {"tokens": torch.tensor(g["toks"]), "labels": torch.tensor(g["toks"])}
    p2, _, step, losses = steps.build_fl_train_step(cfg, opt)(
        tp, [opt.init(p) for p in tp], 0, b)
    assert step == 1
    np.testing.assert_allclose(losses.numpy(), g["losses"], **TOL)
    want = np_tree(g["p2"])
    for p in range(2):
        assert_tree_close(p2[p], jax.tree.map(lambda a: a[p], want))
    w0 = [pods.flatten(t) for t in p2]
    assert any((w0[0][k] - w0[1][k]).abs().max() > 1e-7 for k in w0[0])
    P = torch.full((2, 2), 0.5)
    p3 = steps.build_gossip_step(cfg)(p2, P)
    want3 = np_tree(g["p3"])
    for p in range(2):
        assert_tree_close(p3[p], jax.tree.map(lambda a: a[p], want3))
    a, b_ = pods.flatten(p3[0]), pods.flatten(p3[1])
    for k in a:
        np.testing.assert_allclose(a[k].numpy(), b_[k].numpy(), atol=1e-5)


def test_int8_ef_gossip_step_matches_jax(granite_pods):
    g = granite_pods
    two = per_pod(g["two"], 2)
    err0 = [{k: torch.zeros(v.shape) for k, v in pods.flatten(t).items()}
            for t in two]
    err0 = [pods.rebuild(t, e) for t, e in zip(two, err0)]
    out, err1 = steps.build_gossip_step(g["cfg"], wire="int8",
                                        error_feedback=True)(
        two, torch.full((2, 2), 0.5), err0)
    want, werr = np_tree(g["q8"]), np_tree(g["e8"])
    for p in range(2):
        got = pods.flatten(out[p])
        ref_leaves = dict(zip(sorted(got), jax.tree.leaves(
            jax.tree.map(lambda a: a[p], want))))
        for k, v in got.items():
            np.testing.assert_allclose(v.numpy(), ref_leaves[k], err_msg=k,
                                       **INT8_TOL)
        gerr = pods.flatten(err1[p])
        werr_p = dict(zip(sorted(gerr), jax.tree.leaves(
            jax.tree.map(lambda a: a[p], werr))))
        for k, v in gerr.items():
            np.testing.assert_allclose(v.numpy(), werr_p[k], err_msg=k,
                                       **INT8_TOL)
    a, b = pods.flatten(out[0]), pods.flatten(out[1])
    for k in a:                                    # pods equalized
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), atol=1e-5)
    assert any(float(v.abs().max()) > 0
               for v in pods.flatten(err1[0]).values())


OPTIMIZERS = [("sgd", dict(momentum=0.9, weight_decay=0.01)),
              ("sgd", {}), ("adam", dict(weight_decay=0.01)), ("adam", {}),
              ("adafactor", {})]


@pytest.mark.parametrize("name,kw", OPTIMIZERS,
                         ids=[f"{n}-{'-'.join(kw)}" for n, kw in OPTIMIZERS])
def test_optimizers_match_jax(name, kw):
    rng = np.random.default_rng(3)
    tree = {"w": rng.normal(size=(3, 5, 4)).astype(np.float32),
            "b": {"v": rng.normal(size=(7,)).astype(np.float32)}}
    jopt, opt = jmake_optimizer(name, 0.01, **kw), \
        make_optimizer(name, 0.01, **kw)
    jp, tp = jax.tree.map(jnp.asarray, tree), \
        jax.tree.map(torch.tensor, tree)
    js, ts = jopt.init(jp), opt.init(tp)
    for step in range(3):
        g = jax.tree.map(lambda a: rng.normal(size=a.shape)
                         .astype(np.float32), tree)
        jp, js = jopt.update(jp, jax.tree.map(jnp.asarray, g), js,
                             jnp.int32(step))
        tp, ts = opt.update(tp, jax.tree.map(torch.tensor, g), ts,
                            torch.tensor(step))
        for a, b in zip(jax.tree.leaves(jp), [tp["b"]["v"], tp["w"]]):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                       atol=1e-6)
    for a, b in zip(jax.tree.leaves(js), jax.tree.leaves(
            jax.tree.map(lambda t: t.numpy(), ts))):
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-6, atol=1e-7)


def test_schedules_match_jax():
    for name, args in (("warmup_linear", (0.1, 5, 50)),
                       ("cosine_schedule", (0.1, 5, 50))):
        f, jf = getattr(schedules, name)(*args), \
            getattr(jschedules, name)(*args)
        for step in (0, 1, 4, 5, 6, 27, 49, 50, 80):
            np.testing.assert_allclose(float(f(step)), float(jf(step)),
                                       rtol=1e-6)


def ck_tree(rng):
    w = rng.normal(size=(2, 3)).astype(np.float32)
    return ({"params": {"emb": jnp.asarray(w, jnp.bfloat16),
                        "layers": [{"a": jnp.asarray(w)},
                                   {"a": jnp.asarray(w * 2)}]},
             "step": jnp.int32(7), "opt": {}},
            {"params": {"emb": torch.tensor(w).to(torch.bfloat16),
                        "layers": [{"a": torch.tensor(w)},
                                   {"a": torch.tensor(w * 2)}]},
             "step": torch.tensor(7, dtype=torch.int32), "opt": {}})


def test_checkpoints_load_across_packages_bit_for_bit(tmp_path):
    jt, tt = ck_tree(np.random.default_rng(0))
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jsave(jdir, jt, 12)
    save_checkpoint(tdir, tt, 12)
    for name in ("arrays.npz", "manifest.json"):
        a = (tmp_path / "jax" / "step_00000012" / name)
        b = (tmp_path / "port" / "step_00000012" / name)
        if name.endswith(".json"):
            assert a.read_text() == b.read_text()
        else:
            za, zb = zipfile.ZipFile(a), zipfile.ZipFile(b)
            assert za.namelist() == zb.namelist()
            for n in za.namelist():
                assert za.read(n) == zb.read(n), n
    # the reference's file into the port, the port's into the reference
    got, step = load_checkpoint(jdir, tt)
    assert step == 12
    assert got["params"]["emb"].dtype == torch.bfloat16
    assert torch.equal(got["params"]["emb"].view(torch.int16),
                       tt["params"]["emb"].view(torch.int16))
    assert torch.equal(got["params"]["layers"][1]["a"],
                       tt["params"]["layers"][1]["a"])
    back, _ = jload(tdir, jt)
    assert np.array_equal(np.asarray(back["params"]["emb"]).view(np.int16),
                          tt["params"]["emb"].view(torch.int16).numpy())
    assert int(back["step"]) == 7
    with pytest.raises(ValueError, match="structure mismatch"):
        load_checkpoint(jdir, {"params": tt["params"]})


def test_flash_attention_trains_through_its_autograd_function():
    """On the CPU the forward and backward are the plain version's; the
    call goes through ``_FlashAttention`` (its backward recomputes the plain
    version from the saved q, k, v)."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 3, 40, 32, generator=g, requires_grad=True)
               for _ in range(3))
    out = ops.flash_attention(q, k, v, causal=True, window=8)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    go = torch.randn(out.shape, generator=g)
    grads = torch.autograd.grad(out, (q, k, v), go)
    qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
    want = torch.autograd.grad(ref.flash_attention_ref(
        qq, kk, vv, causal=True, window=8), (qq, kk, vv), go)
    for a, b in zip(grads, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with torch.no_grad():                       # no autograd: the kernel
        assert ops.flash_attention(q, k, v).grad_fn is None


@pytest.mark.parametrize("kernel", ["moe_router_topk", "moe_route_slots",
                                    "ssd_chunk", "moe_router_topk-tie"])
def test_kernels_without_a_gradient_refuse_training_on_the_card(
        kernel, monkeypatch):
    """(The kernels refused autograd on the card until they had a gradient;
    this now checks the gradient that replaced the refusal.) On the card
    side, with the launch emulated by the plain version, a call under
    autograd goes through its Function (one launch) and its gradients
    equal the plain version's; the SSD term's for all five inputs. The
    tie case: two equal logits at the k-th place, and a kernel that picks
    the higher index of the two (the plain version picks the lower): the
    gradient is that of the gates at the kernel's picks."""
    calls = card_side(monkeypatch)
    g = torch.Generator().manual_seed(0)
    if kernel == "ssd_chunk":
        args = [torch.randn(1, 8, 16, generator=g),
                torch.randn(1, 8, 16, generator=g),
                -torch.rand(1, 2, 8, generator=g).cumsum(-1),
                torch.rand(1, 2, 8, generator=g),
                torch.randn(1, 8, 2, 32, generator=g).transpose(1, 2)]
        args = [a.requires_grad_() for a in args]
        out = ops.ssd_chunk(*args)
        go = torch.randn(out.shape, generator=g)
        want = torch.autograd.grad(ref.ssd_chunk_ref(*args), args, go)
        assert type(out.grad_fn).__name__ == "_SsdChunkBackward"
        assert calls == ["ssd_chunk_tc"]
        for a, b in zip(torch.autograd.grad(out, args, go), want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        return
    logits = torch.randn(8, 16, generator=g)
    if kernel.endswith("tie"):
        logits = logits.clamp(max=0.0)
        logits[:, 0] = 2.0
        logits[:, 5] = logits[:, 6] = 1.0           # the tie at k = 2
        plain = emulated_launch(calls)

        def higher_of_the_tie(name, out, *a):
            plain(name, out, *a)
            idx = at(a[2], (8, 2), (2, 1), torch.int32)
            idx[idx == 5] = 6
            return out
        monkeypatch.setattr(ops, "_launch", higher_of_the_tie)
    logits.requires_grad_()
    k = 2
    if kernel.startswith("moe_router_topk"):
        gates, idx = ops.moe_router_topk(logits, k)
        name, fn = "moe_router", "_MoeRouterTopkBackward"
    else:
        gates, idx, slot, src = ops.moe_route_slots(logits, k, 4)
        name, fn = "moe_route_slots", "_MoeRouteSlotsBackward"
        assert not slot.requires_grad and not src.requires_grad
    assert calls == [name] and type(gates.grad_fn).__name__ == fn
    assert not idx.requires_grad
    go = torch.randn(gates.shape, generator=g)
    got, = torch.autograd.grad(gates, logits, go)
    want, = torch.autograd.grad(ref.router_gates_at(logits, idx), logits, go)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    pgates, pidx = ref.moe_router_topk_ref(logits, k)
    plain, = torch.autograd.grad(pgates, logits, go)
    if kernel.endswith("tie"):
        assert (idx == 6).any() and not (pidx == 6).any()
        assert not torch.equal(got, plain)
    else:
        assert torch.equal(idx, pidx)
        torch.testing.assert_close(got, plain, rtol=0, atol=0)


REMAT_LAYERS = {"qwen3-0.6b": 4, "deepseek-moe-16b": 4, "mamba2-780m": 4,
                "jamba-v0.1-52b": 8}


@pytest.mark.parametrize("arch", sorted(REMAT_LAYERS))
def test_remat_checkpoints_each_scanned_repeat(arch):
    """``cfg.remat`` on a scanned stack: each repeat runs under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of its
    scan body). The loss equals the one without remat bit for bit, every
    gradient is within 1e-6 of its max, the scanned layers' kernels are
    called again in the backward (the recompute), the prefix's are not,
    and the counted peak on meta is lower."""
    from repro_torch import counting
    from repro_torch.models.blocks import factor_schedule

    cfg = dataclasses.replace(reduced(get_config(arch)),
                              num_layers=REMAT_LAYERS[arch],
                              scan_layers=True, remat=True)
    prefix, pattern, repeats = factor_schedule(cfg.block_schedule())
    assert repeats > 1
    g = torch.Generator().manual_seed(0)
    params = model.init_params(g, cfg)
    _, tb = batches(cfg, b=2, s=16)
    out = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        leaves = {k: v.detach().requires_grad_()
                  for k, v in pods.flatten(params).items()}
        with counting.Counter() as cnt:
            loss, _ = model.loss_fn(pods.rebuild(params, leaves), c, tb)
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
        meta = dataclasses.replace(c, dtype="bfloat16")
        mp = model.abstract_params(meta)
        mb = {"tokens": torch.empty((2, 64), dtype=torch.int64,
                                    device="meta"),
              "labels": torch.empty((2, 64), dtype=torch.int64,
                                    device="meta")}
        with counting.Counter() as mc:
            mc.track(mp)
            ml = {k: v.detach().requires_grad_()
                  for k, v in pods.flatten(mp).items()}
            loss_m, _ = model.loss_fn(pods.rebuild(mp, ml), meta, mb)
            torch.autograd.grad(loss_m, list(ml.values()),
                                allow_unused=True)
        out[remat] = (loss, grads, dict(cnt.calls), mc.peak_bytes)
    (l0, g0, c0, p0), (l1, g1, c1, p1) = out[False], out[True]
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        if a is not None:
            assert float((a - b).abs().max()) <= 1e-6 * float(
                a.abs().max())
    # the scanned repeats' calls twice, the prefix layers' once
    assert set(c1) == set(c0) and sum(c1.values()) > sum(c0.values())
    for k in c0:
        again = c1[k] - c0[k]
        assert again % repeats == 0 and 0 <= c0[k] - again, (k, c0, c1)
        if prefix == 0:
            assert c1[k] == 2 * c0[k]
    assert p1 < p0, (p0, p1)


def test_remat_recompute_keeps_the_mesh_on_the_backwards_thread():
    """For a card the autograd engine runs the backward, and so remat's
    recompute, on a thread of its own, where the thread-local sharding
    context is unset: expert parallelism's recompute must take the
    forward's mesh with it. Here the backward runs on another thread."""
    import threading

    from repro_torch import sharding
    cfg = dataclasses.replace(
        reduced(get_config("deepseek-moe-16b"), max_experts=8),
        num_layers=4, scan_layers=True, remat=True)
    params = model.init_params(torch.Generator().manual_seed(0), cfg)
    leaves = {k: v.detach().requires_grad_()
              for k, v in pods.flatten(params).items()}
    _, tb = batches(cfg, b=4, s=8)
    mesh = sharding.make_mesh((4, 2), ("data", "model"), ["cpu"] * 8)
    with sharding.logical_rules(mesh, {}):
        loss, _ = model.loss_fn(pods.rebuild(params, leaves), cfg, tb,
                                moe_strategy="eplocal")
    got = {}

    def backward():
        try:
            got["grads"] = torch.autograd.grad(loss, list(leaves.values()),
                                               allow_unused=True)
        except Exception as e:          # reported below, on this thread
            got["error"] = e
    t = threading.Thread(target=backward)
    t.start()
    t.join()
    assert "error" not in got, got.get("error")
    assert all(torch.isfinite(g).all() for g in got["grads"]
               if g is not None)


# the recorded half-mass ties (ROADMAP.md queue 3, item 3): per row the
# receiver's own norm, its float32 self weight as the reference computed
# it, and each positive-weight peer's (norm, weight)
TIES = {
    "table3_alie_r2_receiver14": (
        "0.08506035059690475", "1.0",
        [("9.308337211608887", "0.29420584440231323"),
         ("5.82982063293457", "0.29420584440231323"),
         ("2.107330322265625", "0.2028970718383789"),
         ("2.1073293685913086", "0.20869126915931702")]),
    "table3_alie_r3_receiver16": (
        "0.08625883609056473", "0.9999999403953552",
        [("1.5947177410125732", "0.3251829147338867"),
         ("4.352499961853027", "0.258363276720047"),
         ("4.292664527893066", "0.24184046685695648"),
         ("2.676464080810547", "0.17461331188678741")]),
    "table3_alie_r3_receiver23": (
        "1.5947177410125732", "0.9999999403953552",
        [("5.237274646759033", "0.17196202278137207"),
         ("5.7801194190979", "0.32590338587760925"),
         ("2.852673053741455", "0.15979960560798645"),
         ("6.752233982086182", "0.34233492612838745")]),
    "table3_alie_r3_receiver25": (
        "5.7801194190979", "0.9999998807907104",
        [("0.05757305026054382", "0.25983378291130066"),
         ("0.13245069980621338", "0.36073094606399536"),
         ("0.054012082517147064", "0.36073094606399536"),
         ("1.594717264175415", "0.018704239279031754")]),
}


@pytest.mark.parametrize("tie", sorted(TIES))
def test_half_mass_tie_on_its_recorded_inputs(tie):
    own, self_w, peers = TIES[tie]
    vals = np.array([own] + [p[0] for p in peers], np.float32)
    w = np.array([self_w] + [p[1] for p in peers], np.float32)
    exact = min(vals[0], vals[1:].max())
    jax_pick = float(jdts.weighted_median(jnp.asarray(vals[:, None]),
                                          jnp.asarray(w[None]))[0, 0])
    assert jax_pick != exact                 # the reference's float32 side
    n = len(vals)
    wts = torch.zeros(n, n)
    wts[0, 1:] = torch.tensor(w[1:])         # receiver 0's peers
    got = dts.anchored_median(torch.tensor(vals[:, None]), wts)
    assert float(got[0, 0]) == exact
    assert float(got[1, 0]) == 0.0           # a row with no peer


def test_port_train_federated_example_runs_on_the_cpu(capsys):
    """``examples/port_train_federated.py`` at the published widths, cut to
    one layer (its ``CFG_100M`` replaced in process) and two workers:
    finite losses and the example's closing line."""
    import dataclasses
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "examples" / \
        "port_train_federated.py"
    spec = importlib.util.spec_from_file_location("port_train_federated",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.CFG_100M = dataclasses.replace(mod.CFG_100M, num_layers=1)
    out = mod.main(["--device", "cpu", "--steps", "2",
                    "--workers", "2", "--seq", "16", "--batch", "2",
                    "--gossip-every", "1"])
    assert torch.isfinite(out["losses"]).all()
    assert len(out["step_s"]) == 2
    assert "final loss spread across workers" in capsys.readouterr().out
