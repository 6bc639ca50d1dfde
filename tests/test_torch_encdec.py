"""The port's whisper encoder-decoder and vlm prefix (``repro_torch.models``,
``repro_torch.launch``) on the CPU against the JAX package's, and flash
attention with a key length of its own.

* ``ref.flash_attention_ref`` and ``ops.flash_attention`` with Sk != Sq
  against the reference's ``_sdpa`` with no mask (1e-6, summation order);
  their refusal of a causal or windowed call between two lengths; the
  card-side branch with the launch stubbed (Sq, Sk, q's and k's strides,
  the SIMT kernel's ragged head dims).
* The sinusoid table (float64, cast once) and the float32 scalar form.
* Reduced whisper-tiny (D = 42, 6 heads) and InternVL2-2B (f32, 2 layers,
  d_model 256): forward logits within 1e-4 (summation order; the vlm's with
  and without ``vision_embeds``, text positions only), whisper scanned at
  3 layers too; the encoder; teacher-forced decode against the reference's
  ``decode_step`` given ``enc_out`` and against the port's prefill within
  2e-3 (tests/test_arch_smoke.py's bound); greedy tokens from
  ``serve.generate`` equal to a loop of the reference's ``decode_step``
  over 8 steps; the flash calls of a prefill and of the serve loop; the
  convert round trip of the encoder, cross-attention and projector
  leaves.

Parameters come from the reference's init, every leaf moved by numpy noise
(so zero biases and unit norms are exercised), carried across with
``convert.model_params_from_jax``; tokens, frames and vision embeddings
from numpy with a seed. One JAX run per model is shared by the module.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import reduced as jreduced
from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model as jmodel

from repro_torch.config import reduced
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_jax, model_params_to_numpy
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve
from repro_torch.launch.steps import build_decode_step, build_prefill_step
from repro_torch.models import layers, model
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)
B, S, PLEN, NEW = 2, 10, 5, 8


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def close(got, want, **tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), **(tol or TOL))


def perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.normal(size=a.shape))
        .astype(np.float32), tree)


class World:
    """One reduced model on both sides, its inputs and the reference's
    outputs (computed once)."""

    def __init__(self, arch, seed, **replace):
        self.jcfg = dataclasses.replace(jreduced(jget_config(arch)),
                                        **replace)
        self.cfg = dataclasses.replace(reduced(get_config(arch)), **replace)
        tree = perturbed(jmodel.init_params(jax.random.PRNGKey(seed),
                                            self.jcfg), seed)
        self.tree = tree
        self.jp = jax.tree.map(jnp.asarray, tree)
        self.tp = model_params_from_jax(tree, "cpu")
        rng = np.random.default_rng(seed + 1)
        cfg = self.cfg
        self.np_batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S))}
        if cfg.is_encoder_decoder:
            self.np_batch["frame_embeds"] = rng.normal(
                size=(B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
        if cfg.family == "vlm":
            self.np_batch["vision_embeds"] = rng.normal(
                size=(B, cfg.num_vision_tokens, cfg.d_model)).astype(
                    np.float32)

    def batches(self, keys=None):
        keys = keys or list(self.np_batch)
        jb = {k: jnp.asarray(self.np_batch[k], jnp.int32 if k == "tokens"
                             else jnp.float32) for k in keys}
        tb = {k: torch.tensor(self.np_batch[k]) for k in keys}
        return jb, tb


@pytest.fixture(scope="module")
def whisper():
    return World("whisper-tiny", 21)


@pytest.fixture(scope="module")
def vlm():
    return World("internvl2-2b", 22)


# ---------------------------------------------------------------------------
# Flash attention with a key length of its own
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sq", [1, 5])
@pytest.mark.parametrize("sk", [7, 64])
@pytest.mark.parametrize("d", [32, 42])
def test_flash_cross_lengths_match_the_reference_sdpa(sq, sk, d):
    """q [B, H, Sq, D] over k, v [B, H, Sk, D], unmasked: the plain version
    and the wrapper's CPU branch equal the reference's ``_sdpa`` with no
    mask (its cross-attention) within 1e-6."""
    rng = np.random.default_rng(sq * 100 + sk + d)
    q = rng.normal(size=(2, sq, 3, d)).astype(np.float32)
    k, v = (rng.normal(size=(2, sk, 3, d)).astype(np.float32)
            for _ in range(2))
    want = np.asarray(jattn._sdpa(q, k, v, None, 3)).transpose(0, 2, 1, 3)
    tq, tk, tv = (torch.tensor(x).transpose(1, 2) for x in (q, k, v))
    for got in (ref.flash_attention_ref(tq, tk, tv, causal=False),
                ops.flash_attention(tq, tk, tv, causal=False)):
        assert got.shape == (2, 3, sq, d)
        close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("on_card", [False, True])
def test_flash_cross_lengths_refuse_masks(monkeypatch, on_card):
    """A causal or windowed call with Sk != Sq raises, before any launch
    on the card side; at Sk = Sq both masks stay."""
    calls = []
    if on_card:
        monkeypatch.setattr(ops, "_on_card", lambda *ts: True)
        monkeypatch.setattr(ops, "_launch", lambda name, out, *a:
                            calls.append(name) or out)
    q = torch.zeros(1, 2, 5, 64)
    kv = torch.zeros(1, 2, 7, 64)
    for causal, window in ((True, 0), (False, 4), (True, 4)):
        with pytest.raises(ValueError, match="Sk = 7"):
            ops.flash_attention(q, kv, kv, causal=causal, window=window)
        if not on_card:
            with pytest.raises(ValueError, match="Sk = 7"):
                ref.flash_attention_ref(q, kv, kv, causal=causal,
                                        window=window)
    assert calls == []
    ops.flash_attention(q, q, q, causal=True, window=4)
    assert calls == (["flash_attention"] if on_card else [])
    with pytest.raises(ValueError, match="v: shape"):
        ops.flash_attention(q, kv, kv[:, :, :6], causal=False)
    with pytest.raises(ValueError, match="k: shape"):
        ops.flash_attention(q, kv[:, :1], kv[:, :1], causal=False)
    with pytest.raises(ValueError, match="k and v must share"):
        ops.flash_attention(q, kv, kv.transpose(2, 3).contiguous()
                            .transpose(2, 3), causal=False)


@pytest.mark.parametrize("dtype,d,name", [
    (torch.float32, 42, "flash_attention"),
    (torch.bfloat16, 42, "flash_attention"),
    (torch.float32, 64, "flash_attention"),
    (torch.bfloat16, 64, "flash_attention_tc"),
    (torch.bfloat16, 128, "flash_attention_tc")])
def test_flash_card_side_cross_arguments(monkeypatch, dtype, d, name):
    """The card-side branch with the launch stubbed, q a [B, Sq, H, D]
    view and k, v [B, Sk, H, D] views of their own length: the C entry
    gets Sq and Sk, q's (b, h, s) strides, k's, and out's (q's layout);
    the kernel follows from dtype and D alone."""
    calls = []
    monkeypatch.setattr(ops, "_on_card", lambda *ts: True)
    monkeypatch.setattr(ops, "_launch", lambda n, out, *a:
                        calls.append((n, a)) or out)
    b, h, sq, sk = 2, 3, 5, 70
    q = torch.zeros(b, sq, h, d, dtype=dtype).transpose(1, 2)
    k, v = (torch.zeros(b, sk, h, d, dtype=dtype).transpose(1, 2)
            for _ in range(2))
    out = ops.flash_attention(q, k, v, causal=False)
    assert out.shape == q.shape and out.stride() == q.stride()
    (got, args), = calls
    assert got == name == ops.flash_kernel(dtype, d)
    assert args[:4] == (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr())
    qs, ks = (sq * h * d, d, h * d), (sk * h * d, d, h * d)
    tail = (sq, sk, d) + qs + ks + qs + (0, 0)
    if name == "flash_attention_tc":
        assert args[4:] == (b, h) + tail
    else:
        assert args[4:] == (b * h, h) + tail + (ops._DTYPE_CODE[dtype],)


@pytest.mark.parametrize("dtype,d", [(torch.float32, 129),
                                     (torch.bfloat16, 33),
                                     (torch.bfloat16, 130)])
def test_flash_head_dims_the_simt_kernel_refuses(monkeypatch, dtype, d):
    """The head dim is checked on the card only, by what the kernel takes
    (rows of whole 4-byte words, D up to 128): the CPU runs the plain
    version at any D; the card side raises before any launch."""
    q = torch.ones(1, 2, 5, d, dtype=dtype)
    assert ops.flash_attention(q, q, q).shape == q.shape
    calls = []
    monkeypatch.setattr(ops, "_on_card", lambda *ts: True)
    monkeypatch.setattr(ops, "_launch", lambda n, out, *a:
                        calls.append(n) or out)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q, q, q)
    assert calls == []


# ---------------------------------------------------------------------------
# Sinusoids
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,d", [(64, 256), (1500, 384), (448, 2048)])
def test_sinusoids_match_jax(s, d):
    """The table (float64 numpy, cast once to float32) equals the
    reference's. The float32 scalar form is within 1e-6 up to position 15;
    further out the two differ by the positions' multiple of the
    frequencies' last bit: XLA's float32 exp is not correctly rounded
    (measured: 22 of the 192 frequencies at D = 384 differ from the
    correctly rounded value by one ulp, torch's 2), so the products pos *
    freq differ by up to pos * 2**-24 before their own rounding to float32
    (at most an ulp of the angle, <= pos * 2**-23): pos * 2**-22 in all."""
    got = layers.sinusoidal_positions(s, d)
    assert got.dtype == torch.float32 and got.shape == (s, d)
    close(got, jlayers.sinusoidal_positions(s, d), rtol=0, atol=0)
    for pos in list(range(16)) + [100, 447, s - 1]:
        want = jlayers.sinusoidal_at(jnp.asarray(pos), d)
        at = layers.sinusoidal_at(pos, d)
        assert at.dtype == torch.float32
        close(at, want, rtol=0, atol=1e-6 + (pos >= 16) * pos * 2.0 ** -22)


def test_sinusoid_table_is_a_fresh_tensor():
    """Each call hands out a tensor of its own: a caller's write does not
    reach the next caller; ``dtype`` casts the float32 table."""
    want = layers.sinusoidal_positions(8, 16).clone()
    layers.sinusoidal_positions(8, 16).zero_()
    assert torch.equal(layers.sinusoidal_positions(8, 16), want)
    half = layers.sinusoidal_positions(8, 16, "cpu", torch.bfloat16)
    assert half.dtype == torch.bfloat16
    assert torch.equal(half, want.to(torch.bfloat16))


# ---------------------------------------------------------------------------
# Whole models
# ---------------------------------------------------------------------------

def test_reduced_whisper_has_head_dim_42(whisper):
    assert whisper.cfg.head_dim == whisper.jcfg.head_dim == 42
    assert whisper.cfg.num_heads == 6


@pytest.mark.parametrize("scanned", [False, True])
def test_whisper_forward_and_encoder_match_jax(whisper, scanned):
    """Logits within 1e-4, the encoder states too; scanned: 3 decoder
    layers as three stacked repeats (the full config scans 4)."""
    w = whisper if not scanned else World("whisper-tiny", 23, num_layers=3,
                                          scan_layers=True)
    if scanned:
        assert "scan" in w.tp
    jb, tb = w.batches()
    want, _ = jmodel.forward(w.jp, w.jcfg, jb)
    got, aux = model.forward(w.tp, w.cfg, tb)
    assert got.shape == (B, S, w.cfg.vocab_size)
    close(got, want)
    torch.testing.assert_close(build_prefill_step(w.cfg)(w.tp, tb), got,
                               rtol=0, atol=0)
    close(model.encode(w.tp, w.cfg, tb["frame_embeds"]),
          jmodel._encoder_forward(w.jp, w.jcfg, jb["frame_embeds"]))


@pytest.mark.parametrize("with_vision", [True, False])
def test_vlm_forward_matches_jax(vlm, with_vision):
    keys = ["tokens"] + (["vision_embeds"] if with_vision else [])
    jb, tb = vlm.batches(keys)
    want, _ = jmodel.forward(vlm.jp, vlm.jcfg, jb)
    got, _ = model.forward(vlm.tp, vlm.cfg, tb)
    assert got.shape == (B, S, vlm.cfg.vocab_size)       # text only
    close(got, want)
    if with_vision:        # the prefix moves the text logits
        plain, _ = model.forward(vlm.tp, vlm.cfg, {"tokens": tb["tokens"]})
        assert float((plain - got).abs().max()) > 1e-3


def test_whisper_decode_matches_jax_and_prefill(whisper):
    """Teacher-forced decode given the encoder states: every step within
    2e-3 of the reference's ``decode_step`` (given its ``enc_out``) and of
    the port's own prefill; the cache as the reference's."""
    w = whisper
    jb, tb = w.batches()
    jenc = jmodel._encoder_forward(w.jp, w.jcfg, jb["frame_embeds"])
    enc = model.encode(w.tp, w.cfg, tb["frame_embeds"])
    full, _ = model.forward(w.tp, w.cfg, tb)
    jdecode = jax.jit(lambda p, t, c, pos, e: jmodel.decode_step(
        p, w.jcfg, t, c, pos, enc_out=e))
    jcache = jmodel.init_cache(w.jcfg, B, S)
    cache = model.init_cache(w.cfg, B, S, device="cpu")
    decode = build_decode_step(w.cfg)
    for t in range(S):
        jl, jcache = jdecode(w.jp, jb["tokens"][:, t:t + 1], jcache,
                             jnp.int32(t), jenc)
        lg, cache = decode(w.tp, tb["tokens"][:, t:t + 1], cache, t, enc)
        close(lg, jl, rtol=0, atol=2e-3)
        close(lg[:, 0], full[:, t].detach(), rtol=0, atol=2e-3)
    # the batch form (frames encoded at the step) equals the enc_out form
    lg2, _ = model.decode_step(w.tp, w.cfg, tb["tokens"][:, :1],
                               model.init_cache(w.cfg, B, S, device="cpu"),
                               0, batch=tb)
    first, _ = model.decode_step(w.tp, w.cfg, tb["tokens"][:, :1],
                                 model.init_cache(w.cfg, B, S, device="cpu"),
                                 0, enc_out=enc)
    torch.testing.assert_close(lg2, first, rtol=0, atol=0)
    ours = flat(cache)
    theirs = flat(jax.tree.map(np.asarray, jcache))
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        close(ours[k], theirs[k])


@pytest.mark.parametrize("arch", ["whisper-tiny", "internvl2-2b"])
def test_greedy_serving_matches_jax(whisper, vlm, arch):
    """``serve.generate`` takes the same 8 greedy tokens as a loop of the
    reference's ``decode_step`` (prefill by stepping the cache; whisper
    with the encoder states computed once)."""
    w = whisper if arch == "whisper-tiny" else vlm
    prompts = np.asarray(w.np_batch["tokens"][:, :PLEN])
    jenc, frames = None, None
    if w.cfg.is_encoder_decoder:
        frames = w.np_batch["frame_embeds"]
        jenc = jmodel._encoder_forward(w.jp, w.jcfg, jnp.asarray(frames))
    jdecode = jax.jit(lambda p, t, c, pos, e: jmodel.decode_step(
        p, w.jcfg, t, c, pos, enc_out=e))
    cache = jmodel.init_cache(w.jcfg, B, PLEN + NEW)
    jprompts = jnp.asarray(prompts, jnp.int32)
    for t in range(PLEN):
        logits, cache = jdecode(w.jp, jprompts[:, t:t + 1], cache,
                                jnp.int32(t), jenc)
    want = []
    for t in range(PLEN, PLEN + NEW):
        nxt = jnp.argmax(logits[:, -1], axis=-1)
        want.append(np.asarray(nxt))
        logits, cache = jdecode(w.jp, nxt[:, None], cache, jnp.int32(t),
                                jenc)
    got, _ = serve.generate(
        w.tp, w.cfg, torch.tensor(prompts), NEW,
        frame_embeds=None if frames is None else torch.tensor(frames))
    np.testing.assert_array_equal(got.numpy(), np.stack(want, axis=1))


def test_flash_calls_of_prefill_and_serving(whisper, monkeypatch):
    """Per prefill call the reduced whisper runs flash attention once per
    encoder layer (non-causal, Sk = Sq = 64), once per decoder layer
    (causal) and once per cross-attention (non-causal, Sq = 10, Sk = 64);
    the serve loop once per encoder layer for its single encode and never
    in a decode step."""
    w = whisper
    seen = []
    real = ops.flash_attention

    def spy(q, k, v, *, causal=True, window=0):
        seen.append((q.shape[2], k.shape[2], causal))
        return real(q, k, v, causal=causal, window=window)
    monkeypatch.setattr(ops, "flash_attention", spy)
    _, tb = w.batches()
    build_prefill_step(w.cfg)(w.tp, tb)
    f = w.cfg.encoder_seq_len
    assert sorted(seen) == sorted([(f, f, False)] * 2 + [(S, S, True)] * 2
                                  + [(S, f, False)] * 2)
    seen.clear()
    serve.generate(w.tp, w.cfg, tb["tokens"][:, :3], 2,
                   frame_embeds=tb["frame_embeds"])
    assert seen == [(f, f, False)] * 2


def test_convert_carries_encoder_xattn_and_projector_leaves(whisper, vlm):
    """The new leaves arrive with their names, shapes and values and come
    back bit for bit; the port's own trees have the same leaves, and a
    scanned bf16 whisper keeps its stacked cross-attention."""
    for w in (whisper, vlm):
        got = flat(w.tp)
        want = flat(w.tree)
        assert sorted(got) == sorted(want)
        assert sorted(flat(model.abstract_params(w.cfg))) == sorted(got)
        back = flat(model_params_to_numpy(w.tp))
        for k, a in want.items():
            np.testing.assert_array_equal(back[k], a)
    assert {"encoder/0/attn/wq", "encoder/ln_post", "layers/0/ln_x",
            "layers/1/xattn/wo"} <= set(flat(whisper.tp))
    assert {"projector/w1", "projector/w2",
            "projector/ln"} <= set(flat(vlm.tp))
    jcfg = dataclasses.replace(jreduced(jget_config("whisper-tiny")),
                               num_layers=3, scan_layers=True,
                               dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jmodel.init_params(
        jax.random.PRNGKey(3), jcfg))
    got = flat(model_params_from_jax(tree, "cpu"))
    t, a = got["scan/0/xattn/wk"], flat(tree)["scan/0/xattn/wk"]
    assert t.dtype == torch.bfloat16 and tuple(t.shape) == a.shape
    assert t.shape[0] == 3
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))


@pytest.mark.parametrize("arch,vision,dtype", [
    ("whisper-tiny", 0, None), ("internvl2-2b", 16, torch.bfloat16),
    ("qwen3-0.6b", 0, None)])
def test_serve_inputs_draw_what_the_model_takes(arch, vision, dtype):
    """``serve.serve_inputs`` draws tokens [b, s] and, beside them, an
    encoder-decoder's frames [b, F, D] and the asked vision embeddings [b,
    vision, D] in the asked dtype (float32 by default), from the generator
    alone: the same seed gives the same batch."""
    cfg = reduced(get_config(arch))

    def draw():
        gen = torch.Generator()
        gen.manual_seed(5)
        return serve.serve_inputs(cfg, 3, 7, gen, vision=vision, dtype=dtype)
    batch = draw()
    keys = {"tokens"} | ({"frame_embeds"} if cfg.is_encoder_decoder
                         else set()) | ({"vision_embeds"} if vision else set())
    assert set(batch) == keys
    assert tuple(batch["tokens"].shape) == (3, 7)
    assert 0 <= int(batch["tokens"].min())
    assert int(batch["tokens"].max()) < cfg.vocab_size
    if "frame_embeds" in batch:
        assert tuple(batch["frame_embeds"].shape) == (
            3, cfg.encoder_seq_len, cfg.d_model)
    if vision:
        assert tuple(batch["vision_embeds"].shape) == (3, vision,
                                                       cfg.d_model)
    for k, x in batch.items():
        if k != "tokens":
            assert x.dtype == (dtype or torch.float32)
        assert torch.equal(x, draw()[k])
