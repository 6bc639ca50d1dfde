"""The SIMT flash kernel's numerics on the tensor cores
(``csrc/flash_attention.cu``), emulated on the CPU and held to its unchanged
limits against the JAX package's flash attention; the faults those limits
must catch; and the card-side branch's split launch (scratch, split count)
driven with the launch stubbed.

The emulation (``simt_emulation``) computes what the kernel computes, in
its order: query tiles of 64 rows; each tile's visible key tiles of 32
keys cut into
``ops.flash_simt_splits`` equal parts, each part an online softmax over
its key tiles in the exp2 domain (scores times log2(e) / sqrt(D) in fp32,
the running max m, alpha = 2^(m_old - m_new), l summed from the fp32 p),
the parts merged as the merge kernel does. f32: S = Q.K^T and O += P.V in
3xTF32 (hi rounded as cvt.rna, lo truncated to TF32 by the tensor cores,
lo.hi' + hi.lo' + hi.hi'). bf16: S exact products summed in fp32; P.V
with p = hi + lo, hi = bf16(p), lo = bf16(p - hi). The limits are
``chip_smoke.flash_err``'s: f32 5e-5 absolute (the JAX package's bound),
bf16 one ulp of each element (|want| * 2^-7) + 1e-5.

The JAX side runs once per case per module (``jax_outputs``): the Pallas
kernel in interpret mode where its wrapper computes the same function
(causal, or S a block multiple), else its plain reference (at a ragged S
without a mask the JAX wrapper's zero-padded keys enter the softmax), and
``models.attention._sdpa`` at Sk != Sq. bf16 cases feed JAX the
bf16-rounded values in f32 and round its f32 answer once to bf16, as the
JAX kernel does for bf16 inputs (its plain reference would round the
probabilities to bf16 first).
"""
from __future__ import annotations

import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn

from repro_torch.kernels import build, ops, ref

from torch_threads import one_torch_thread  # noqa: F401

BK = 32                      # keys a tile, f32 and bf16
LOG2E = 1.4426950408889634


def tf32_round(v):
    """fp32 -> the nearest TF32 value, ties away from zero (cvt.rna)."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_truncate(v):
    """The TF32 value the tensor cores read from fp32 bits: the top 19."""
    return (v.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def tf32_product(a, b, passes=3):
    """a @ b as mma.sync TF32 forms it: 3xTF32 (lo.hi + hi.lo + hi.hi, the
    small terms first) or, as a fault, one TF32 product (hi.hi)."""
    ah, bh = tf32_round(a), tf32_round(b)
    if passes == 1:
        return ah @ bh
    al, bl = tf32_truncate(a - ah), tf32_truncate(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def simt_emulation(q, k, v, causal, window, *, splits=None, passes=3,
                   p_once=False, rescale=True, causal_shift=0,
                   window_shift=0, mask_ragged=True):
    """The kernel's output for q [B, H, Sq, D] over k, v [B, H, Sk, D] (f32
    or bf16), in q's dtype. ``splits`` defaults to the wrapper's plan. The
    keywords make faulty variants: one TF32 product (``passes=1``), p
    rounded to bf16 once (``p_once``), no alpha rescale of earlier tiles,
    a causal mask ``causal_shift`` keys late, a window edge
    ``window_shift`` keys early, keys past Sk (zero-filled) left
    unmasked."""
    dtype = q.dtype
    b, h, sq, d = q.shape
    sk = k.shape[2]
    bk, bq = BK, ops.FLASH_SIMT_TILE
    if splits is None:
        splits = ops.flash_simt_splits(b, h, sq, sk)
    c = torch.tensor(LOG2E, dtype=torch.float32) / torch.sqrt(
        torch.tensor(float(d), dtype=torch.float32))
    n_kt = -(-sk // bk)
    pad = (0, 0, 0, n_kt * bk - sk)
    qf = q.float()
    kf = torch.nn.functional.pad(k.float(), pad)     # zero-filled, as
    vf = torch.nn.functional.pad(v.float(), pad)     # the copies fill
    out = torch.empty(b, h, sq, d)
    for q0 in range(0, sq, bq):
        qt = qf[:, :, q0:q0 + bq]
        rows = qt.shape[2]
        qpos = torch.arange(q0, q0 + rows)[:, None]
        k_begin, k_end = 0, sk
        if causal:
            k_end = min(sk, q0 + bq)
        if window > 0:
            k_begin = max(0, q0 - window + 1)
        t_first = k_begin // bk
        n_t = max(0, -(-k_end // bk) - t_first)
        parts = []
        for z in range(splits):
            t0 = t_first + n_t * z // splits
            t1 = t_first + n_t * (z + 1) // splits
            m = torch.full((b, h, rows), -math.inf)
            l = torch.zeros(b, h, rows)
            acc = torch.zeros(b, h, rows, d)
            for t in range(t0, t1):
                kt = kf[:, :, t * bk:(t + 1) * bk]
                vt = vf[:, :, t * bk:(t + 1) * bk]
                kpos = torch.arange(t * bk, (t + 1) * bk)[None, :]
                if dtype == torch.float32:
                    s = tf32_product(qt, kt.transpose(-1, -2), passes)
                else:
                    s = qt @ kt.transpose(-1, -2)
                ok = torch.ones(rows, bk, dtype=torch.bool)
                if mask_ragged:
                    ok &= kpos < sk
                if causal:
                    ok &= kpos <= qpos + causal_shift
                if window > 0:
                    ok &= kpos > qpos - window - window_shift
                s = (s * c).masked_fill(~ok, -math.inf)
                m_new = torch.maximum(m, s.amax(-1))
                mu = torch.where(m_new == -math.inf, 0.0, m_new)
                alpha = torch.exp2(m - mu) if rescale else torch.ones_like(m)
                p = torch.exp2(s - mu[..., None])
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None]
                if dtype == torch.float32:
                    acc = acc + tf32_product(p, vt, passes)
                else:
                    ph = p.bfloat16().float()
                    pl = (p - ph).bfloat16().float()
                    acc = acc + (ph @ vt if p_once else pl @ vt + ph @ vt)
                m = m_new
            parts.append((m, l, acc))
        if splits == 1:
            m, l, acc = parts[0]
            o = acc / l.clamp_min(1e-20)[..., None]
        else:                                  # the merge kernel
            big = torch.stack([pm for pm, _, _ in parts]).amax(0)
            L = torch.zeros(b, h, rows)
            o = torch.zeros(b, h, rows, d)
            for pm, pl_, pa in parts:
                w = torch.where(pm == -math.inf, 0.0, torch.exp2(pm - big))
                L = L + pl_ * w
                o = o + pa * w[..., None]
            o = o / L.clamp_min(1e-20)[..., None]
        out[:, :, q0:q0 + rows] = o
    return out.to(dtype)


def worst_ratio(got, want):
    """max |got - want| / flash_err's limit (NaN compares as a failure)."""
    err = (got.float() - want.float()).abs()
    if got.dtype == torch.float32:
        lim = torch.full_like(err, 5e-5)
    else:
        lim = want.float().abs() * 2.0 ** -7 + 1e-5
    r = float((err / lim).max())
    return math.inf if math.isnan(r) else r


# (Sq, Sk, D, causal, window, scale): ragged lengths, D in {42, 64, 112,
# 128}, causal, window and Sk != Sq; scale sharpens the softmax
CASES = [(200, 200, 64, True, 0, 1.0), (200, 200, 64, True, 48, 1.0),
         (200, 200, 64, False, 0, 1.0), (300, 300, 42, True, 0, 1.0),
         (300, 300, 112, True, 0, 1.0), (128, 128, 128, False, 0, 1.0),
         (17, 300, 64, False, 0, 1.0), (1, 300, 112, False, 0, 1.0),
         (300, 300, 64, True, 0, 2.5), (100, 100, 128, True, 16, 2.5)]


def case_inputs(case, dtype):
    """q, k, v [1, 2, S, D] from numpy (normal, q and k times ``scale``),
    as float32 arrays holding ``dtype``'s values."""
    sq, sk, d, causal, window, scale = case
    rng = np.random.default_rng(sq * 7 + sk * 3 + d + window)
    q = rng.normal(size=(1, 2, sq, d)) * scale
    k = rng.normal(size=(1, 2, sk, d)) * scale
    v = rng.normal(size=(1, 2, sk, d))
    return tuple(torch.tensor(x, dtype=torch.float32).to(dtype).float()
                 .numpy() for x in (q, k, v))


def jax_attention(q, k, v, causal, window):
    """The JAX package's attention in f32 on numpy [B, H, S, D] inputs."""
    sq, sk = q.shape[2], k.shape[2]
    if sk != sq:
        t = lambda x: jnp.asarray(x.transpose(0, 2, 1, 3))
        return np.asarray(jattn._sdpa(t(q), t(k), t(v), None,
                                      q.shape[1])).transpose(0, 2, 1, 3)
    if causal or sq % 128 == 0:
        return np.asarray(jops.flash_attention(q, k, v, causal=causal,
                                               window=window))
    return np.asarray(jref.flash_attention_ref(q, k, v, causal=causal,
                                               window=window))


@pytest.fixture(scope="module")
def jax_outputs():
    """{(case, dtype): (q, k, v, JAX's output in dtype)}, one JAX run each."""
    out = {}
    for case in CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = case_inputs(case, dtype)
            want = torch.tensor(jax_attention(q, k, v, *case[3:5])).to(dtype)
            out[case, dtype] = tuple(torch.tensor(x).to(dtype)
                                     for x in (q, k, v)) + (want,)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_emulation_inside_the_limits(jax_outputs, case, dtype):
    """The kernel's numerics, with the wrapper's split plan, stay inside the
    unchanged limits against the JAX package's attention and against the
    port's plain version."""
    q, k, v, want = jax_outputs[case, dtype]
    causal, window = case[3:5]
    got = simt_emulation(q, k, v, causal, window)
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    assert worst_ratio(got, want) <= 1.0
    plain = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert worst_ratio(got, plain) <= 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("splits", [1, 2, 3, 5])
def test_split_parts_merge_inside_the_limits(jax_outputs, dtype, splits):
    """Any split of the key range, parts merged by the merge kernel's
    arithmetic (empty parts included: 5 parts of a 64-row tile's 1-2 bf16
    key tiles), stays inside the limits."""
    for case in ((300, 300, 112, True, 0, 1.0), (17, 300, 64, False, 0,
                                                 1.0)):
        q, k, v, want = jax_outputs[case, dtype]
        got = simt_emulation(q, k, v, *case[3:5], splits=splits)
        assert worst_ratio(got, want) <= 1.0


@pytest.mark.parametrize("dtype,fault", [
    (torch.float32, dict(passes=1)),
    (torch.bfloat16, dict(p_once=True)),
    (torch.float32, dict(rescale=False)),
    (torch.bfloat16, dict(rescale=False))])
def test_the_limits_reject_faulty_arithmetic(jax_outputs, dtype, fault):
    """One TF32 product in place of three (f32), p rounded to bf16 once
    (bf16) and a dropped alpha rescale each break the limit on some case
    (the sharp softmax's cancelling terms show the single rounding)."""
    worst = 0.0
    for case in CASES:
        q, k, v, want = jax_outputs[case, dtype]
        got = simt_emulation(q, k, v, *case[3:5], **fault)
        worst = max(worst, worst_ratio(got, want))
    assert worst > 1.0


FAULTS = {"diagonal": dict(causal_shift=1), "window_edge": dict(
    window_shift=1), "ragged_negative": dict(mask_ragged=False),
    "growing": dict(rescale=False)}


@pytest.mark.parametrize("dtype,d", [(torch.float32, 64),
                                     (torch.float32, 42),
                                     (torch.bfloat16, 96)])
@pytest.mark.parametrize("kind", list(ref.FLASH_ADVERSARIAL))
def test_adversarial_faults_are_rejected(kind, dtype, d):
    """``ref.flash_adversarial``'s four faults (a causal mask one key late,
    a window edge one key early, keys past S unmasked, no rescale) break
    the limit against the JAX package's plain reference, with the key range
    whole (a split part of one key tile needs no rescale: the merge does
    it); the kernel's numerics hold it on the same inputs, whole and
    split as the wrapper plans."""
    q, k, v, causal, window = ref.flash_adversarial(kind, d, seed=d)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    want = torch.tensor(np.asarray(jref.flash_attention_ref(
        *(x.float().numpy() for x in (q, k, v)), causal=causal,
        window=window))).to(dtype)
    for splits in (None, 1):
        got = simt_emulation(q, k, v, causal, window, splits=splits)
        assert worst_ratio(got, want) <= 1.0
    bad = simt_emulation(q, k, v, causal, window, splits=1, **FAULTS[kind])
    assert worst_ratio(bad, want) > 1.0


# ---------------------------------------------------------------------------
# The card-side branch: the split plan, its scratch and the C entry picked
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,h,sq,sk,want", [
    (1, 4, 512, 512, 8),        # the harness's f32 row: 32 CTAs
    (2, 4, 128, 128, 2),        # the f32 qwen3 shard: 16 CTAs
    (4, 12, 128, 128, 1),       # the example's training forward: 96
    (4, 6, 448, 1500, 1),       # whisper's cross-attention: 168
    (1, 64, 4096, 4096, 1),     # Kimi-K2: 4,096 CTAs
    (4, 16, 512, 512, 1),       # the C entry's [64, 512, 128]: 512
    (1, 4, 1024, 1024, 5),      # 64 CTAs
    (1, 4, 1088, 1088, 1),      # 68 CTAs: half the SMs
    (2, 6, 1, 1500, 16),        # one query over whisper's frames, capped
    (2, 3, 40, 40, 1), (2, 3, 5, 70, 1)])
def test_split_plan(b, h, sq, sk, want):
    """Splits only where B*H*ceil(Sq/64) CTAs fill fewer than half the 132
    SMs, as many as bring them to two an SM, each >= 64 keys, at most
    16."""
    assert ops.flash_simt_splits(b, h, sq, sk) == want
    n = ops.flash_simt_scratch(b, h, sq, 64, want)
    assert n == (0 if want == 1 else want * b * h * sq * 66)


def stub_card(monkeypatch):
    """The card-side branch on CPU tensors: launches are recorded, not run;
    every ``torch.empty`` the wrapper makes is kept."""
    calls, made = [], []
    real_empty = torch.empty
    monkeypatch.setattr(ops, "_on_card", lambda *ts: True)
    monkeypatch.setattr(ops, "_launch", lambda name, out, *a:
                        calls.append((name, a)) or out)
    monkeypatch.setattr(torch, "empty", lambda *a, **kw: made.append(
        real_empty(*a, **kw)) or made[-1])
    return calls, made


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_launch_arguments(monkeypatch, dtype):
    """At a split shape the C entry gets the unsplit entry's arguments,
    then the scratch (splits x B*H*Sq x (D + 2) fp32 words, on q's device)
    and the split count: one launch, counted once under flash_attention.
    An unsplit shape passes neither."""
    calls, made = stub_card(monkeypatch)
    b, h, s, d = 1, 4, 512, 96
    q, k, v = (torch.zeros(b, s, h, d, dtype=dtype).transpose(1, 2)
               for _ in range(3))
    out = ops.flash_attention(q, k, v, causal=True)
    assert out.shape == q.shape and out.stride() == q.stride()
    (name, args), = calls
    strides = (s * h * d, d, h * d)
    assert name == "flash_attention"
    assert args[:4] == (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr())
    assert args[4:-2] == (b * h, h, s, s, d) + strides * 3 + (
        1, 0, ops._DTYPE_CODE[dtype])
    part, = [t for t in made if t.numel() and t.data_ptr() == args[-2]]
    assert args[-1] == 8 and part.dtype == torch.float32
    assert part.numel() == 8 * b * h * s * (d + 2)
    assert len(args) + 1 == len(build.VARIANTS["flash_attention"][1])
    calls.clear()
    ops.flash_attention(q[:, :, :60], k[:, :, :60], v[:, :, :60])
    (_, args), = calls
    assert len(args) + 1 == len(build.SIGNATURES["flash_attention"][1])


def test_meta_branch_allocates_the_scratch(monkeypatch):
    """On the meta device (the dry run) the wrapper allocates the same
    scratch as on the card, so the counted peak matches, and launches
    nothing."""
    made = []
    real_empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **kw: made.append(
        real_empty(*a, **kw)) or made[-1])
    before = dict(ops.LAUNCHES)
    q = torch.empty(1, 4, 512, 64, device="meta")
    out = ops.flash_attention(q, q, q, causal=True)
    assert out.is_meta and out.shape == q.shape
    part, = [t for t in made if t.dim() == 1]
    assert part.is_meta and part.numel() == 8 * 4 * 512 * 66
    assert ops.LAUNCHES == before


def test_load_picks_the_entry_by_argument_count(monkeypatch):
    """``build.load`` gives the split entry for its argument count and the
    unsplit entry otherwise (the library itself stubbed)."""
    class Lib:
        def __getattr__(self, symbol):
            return type("Fn", (), {"symbol": symbol})()
    monkeypatch.setattr(build, "library_path", lambda name: Path(__file__))
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: Lib())
    monkeypatch.setattr(build, "_loaded", {})
    n_split = len(build.VARIANTS["flash_attention"][1])
    n_plain = len(build.SIGNATURES["flash_attention"][1])
    assert n_split == n_plain + 2
    assert build.load("flash_attention", n_split).symbol == \
        "flash_attention_split_launch"
    for nargs in (n_plain, None):
        assert build.load("flash_attention", nargs).symbol == \
            "flash_attention_launch"
    assert build.load("gossip_mix", 11).symbol == "gossip_mix_launch"
