"""The redesigned dense and int8 gossip mixes on the CPU: emulations of the
CUDA kernels' numerics and layouts (``src/repro_torch/kernels/csrc/
gossip_mix.cu``, ``gossip_mix_quant.cu``) held to chip_smoke's limit,
1e-5 (1 + max|want|), with mutants the limit must reject, and the
wrappers' card-side branches (regime or branch, launch arguments,
refusals) with the launch stubbed.

- Dense tile regime: 3xTF32 as the kernel forms it (hi rounded as cvt.rna
  rounds, lo = v - hi read truncated to TF32, per mma k-step of 8
  lo.hi' + hi.lo' + hi.hi' into an fp32 accumulator, two products for a
  bf16 or int8 payload), against an fp64 product, at W in {65, 200, 500}
  and ragged F. Mutants: one TF32 product; P's lo part dropped.
- Int8 mix: the slice branch's column slices, row groups and slot order
  (the scale folded into the slot weight, slots in k order) against the
  port's plain version and the JAX package's Pallas kernel in interpret
  mode, with pad slots and W not a multiple of the row group. Mutants: a
  slice off by one column; scale[i] in place of scale[idx[i, k]].

Inputs come from numpy with a seed.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops

from repro_torch.core import gossip
from repro_torch.kernels import ops, ref


def limit_ratio(got, want):
    """max |got - want| / (1e-5 (1 + max|want|)): chip_smoke's limit."""
    err = float((got.double() - want.double()).abs().max())
    return err / (1e-5 * (1.0 + float(want.abs().max())))


def mixing_world(w: int, f: int, seed: int, density: float = 0.35):
    """A row-stochastic P [W, W] on a random topology of the given density
    (about half the peers unsampled, as in a round; the dense mix runs
    above density 0.25) and an fp32 payload [W, F] of scale 2."""
    rng = np.random.default_rng(seed)
    adj = rng.random((w, w)) < density
    keep = (adj & (rng.random((w, w)) < 0.5)) | np.eye(w, dtype=bool)
    P = keep * rng.uniform(0.5, 1.5, (w, w))
    P = (P / P.sum(1, keepdims=True)).astype(np.float32)
    x = (rng.normal(size=(w, f)) * 2.0).astype(np.float32)
    return torch.tensor(P), torch.tensor(x)


# ---------------------------------------------------------------------------
# Dense mix, tile regime: 3xTF32 numerics
# ---------------------------------------------------------------------------

def tf32_round(v):
    """fp32 -> the nearest TF32 value, ties away from zero (cvt.rna)."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_truncate(v):
    """The TF32 value the tensor cores read from fp32 bits: the top 19."""
    return (v.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def tile_emulation(P, w, *, products=None, drop_p_lo=False):
    """P @ w as the tile regime forms it: the payload widened to fp32, the
    contraction walked one mma k-step (8) at a time in order, each step
    adding P_lo.w_hi, P_hi.w_lo and P_hi.w_hi (small terms first) to an
    fp32 accumulator. ``products``: 3 (f32 payloads), 2 (bf16 and int8:
    P_lo.w + P_hi.w, the payload exact in TF32) or 1 (a mutant: one TF32
    product, P_hi.w_hi); default by the payload's dtype.
    ``drop_p_lo``: a mutant without the P_lo.w_hi product."""
    if products is None:
        products = 3 if w.dtype == torch.float32 else 2
    Pf, wf = P.float(), w.float()
    acc = torch.zeros(wf.shape, dtype=torch.float32)
    for k0 in range(0, Pf.shape[0], 8):
        a, b = Pf[:, k0:k0 + 8], wf[k0:k0 + 8]
        ah, bh = tf32_round(a), tf32_round(b)
        al, bl = tf32_truncate(a - ah), tf32_truncate(b - bh)
        if products >= 2 and not drop_p_lo:
            acc = acc + al @ bh
        if products == 3:
            acc = acc + ah @ bl
        acc = acc + ah @ bh
    return acc


TILE_CASES = [(65, 1001), (200, 333), (500, 1001)]


@pytest.mark.parametrize("w,f", TILE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_tile_numerics_stay_inside_the_limit(w, f, dtype):
    """3xTF32 (two products for bf16 and int8, where P carries the folded
    int8 row scales as the pallas backend feeds it) stays inside
    chip_smoke's limit against an fp64 product, with room."""
    P, x = mixing_world(w, f, seed=w + f)
    if dtype == "int8":
        q, scale = gossip.quantize_rows_int8(x)
        P, x = P * scale[None, :], q
    else:
        x = x.to(getattr(torch, dtype))
    want = P.double() @ x.double()
    ratio = limit_ratio(tile_emulation(P, x), want)
    assert ratio <= 0.25, ratio


@pytest.mark.parametrize("w,f", TILE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("fault", [{"products": 1}, {"drop_p_lo": True}])
def test_tile_limit_rejects_single_tf32_products(w, f, dtype, fault):
    """One TF32 product, or P's lo part dropped, moves the output past the
    limit: a kernel that lost its 3xTF32 split cannot pass chip_smoke."""
    P, x = mixing_world(w, f, seed=w + f)
    if dtype == "int8":
        q, scale = gossip.quantize_rows_int8(x)
        P, x = P * scale[None, :], q
    want = P.double() @ x.double()
    ratio = limit_ratio(tile_emulation(P, x, **fault), want)
    assert not ratio <= 5.0, ratio


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_two_products_equal_three_for_narrow_payloads(dtype):
    """A bf16 or int8 payload is exact in TF32, so its lo part is 0 and the
    two-product path equals the three-product path bit for bit."""
    P, x = mixing_world(200, 333, seed=3)
    x = gossip.quantize_rows_int8(x)[0] if dtype == "int8" \
        else x.to(torch.bfloat16)
    assert torch.equal(tf32_round(x.float()), x.float())
    assert torch.equal(tile_emulation(P, x, products=2),
                       tile_emulation(P, x, products=3))


# ---------------------------------------------------------------------------
# Int8 mix, slice branch: layout emulation
# ---------------------------------------------------------------------------

def csr_world(w: int, f: int, seed: int):
    """Padded-CSR weights of a topology whose rows have degrees 1..4 (pad
    slots: the row's own index at weight 0), with some peers unsampled,
    and the int8 wire of a payload of scale 2: (idx, val, scale, q)."""
    rng = np.random.default_rng(seed)
    adj = np.zeros((w, w), bool)
    for i in range(w):
        peers = rng.choice([j for j in range(w) if j != i], size=1 + i % 4,
                           replace=False)
        adj[i, peers] = True
    keep = (adj & (rng.random((w, w)) < 0.7)) | np.eye(w, dtype=bool)
    P = (keep * rng.uniform(0.5, 1.5, (w, w))).astype(np.float32)
    P /= P.sum(1, keepdims=True)
    idx, val = gossip.sparse_weights(torch.tensor(P), adj)
    x = torch.tensor(rng.normal(size=(w, f)).astype(np.float32) * 2.0)
    x *= torch.tensor(rng.uniform(0.1, 3.0, (w, 1)), dtype=torch.float32)
    q, scale = gossip.quantize_rows_int8(x)
    return idx, val, scale, q


def slices_emulation(idx, val, scale, q, cols, rows, *, shift=0,
                     own_scale=False):
    """The slice branch as the kernel runs it: for each CTA's slice of
    ``cols`` columns, q[:, slice] (int8, zero past F) and, for each group
    of ``rows`` rows, the folded slot weights val[i, k] * scale[idx[i, k]];
    each output row sums its slots in k order in fp32, and only columns
    below F are stored. Mutants: the slice read ``shift`` columns off its
    origin; scale[i] folded in place of scale[idx[i, k]]."""
    n, f = q.shape
    k = idx.shape[1]
    out = torch.full((n, f), float("nan"))
    qz = torch.nn.functional.pad(q, (0, cols + abs(shift)))
    for s0 in range(0, f, cols):
        sq = qz[:, s0 + shift:s0 + shift + cols].float()  # [W, cols]
        for g0 in range(0, n, rows):
            g = slice(g0, min(n, g0 + rows))
            src = torch.arange(n)[g, None].expand(-1, k) if own_scale \
                else idx[g].long()
            sval = val[g] * scale[src]
            acc = torch.zeros(sval.shape[0], cols)
            for kk in range(k):
                acc = acc + sval[:, kk, None] * sq[idx[g, kk].long()]
            out[g, s0:min(f, s0 + cols)] = acc[:, :min(f, s0 + cols) - s0]
    return out


QUANT_CASES = [(37, 10), (37, 72), (37, 1001), (37, 4099), (22, 2048)]


@pytest.mark.parametrize("w,f", QUANT_CASES)
def test_slices_layout_matches_plain_and_jax(w, f):
    """The slice branch's layout at the plan's slice width (all rows in
    one group) and at a row group of 8 (37 rows: the last group ragged)
    equals the plain version and JAX's Pallas kernel within the limit."""
    idx, val, scale, q = csr_world(w, f, seed=w + f)
    assert bool((val == 0).any())                       # pad slots
    branch, cols, rows, _ = ops.gossip_mix_quant_plan(w, idx.shape[1], f)
    assert branch == 1 and rows == w
    want = ref.gossip_mix_quant_ref(idx, val, scale, q)
    jax_want = torch.tensor(np.asarray(jops.gossip_mix_quant(
        *(jnp.asarray(t.numpy()) for t in (idx, val, scale, q)))))
    for r in (rows, 8):
        got = slices_emulation(idx, val, scale, q, cols, r)
        assert limit_ratio(got, want) <= 0.1
        assert limit_ratio(got, jax_want) <= 0.1


@pytest.mark.parametrize("w,f", QUANT_CASES)
@pytest.mark.parametrize("fault", [{"shift": 1}, {"own_scale": True}])
def test_slices_limit_rejects_layout_faults(w, f, fault):
    """A slice read one column off its origin, or each row's own scale
    folded in place of its source row's, breaks the limit many times."""
    idx, val, scale, q = csr_world(w, f, seed=w + f)
    _, cols, _, _ = ops.gossip_mix_quant_plan(w, idx.shape[1], f)
    want = ref.gossip_mix_quant_ref(idx, val, scale, q)
    got = slices_emulation(idx, val, scale, q, cols, 8, **fault)
    assert not limit_ratio(got, want) <= 20.0


# ---------------------------------------------------------------------------
# Card-side branches of the wrappers, launch stubbed
# ---------------------------------------------------------------------------

def stub_launches(monkeypatch):
    """Drive the card-side branch on the CPU: every launch is recorded as
    (name, args) and returns its output unfilled."""
    calls = []
    monkeypatch.setattr(ops, "_on_card", lambda *ts: True)
    monkeypatch.setattr(ops, "_launch",
                        lambda name, out, *args: calls.append(
                            (name, args)) or out)
    return calls


def offset(t):
    """t's values in a view one element into a larger buffer, so its base
    is 4 (f32), 2 (bf16) or 1 (int8) bytes off a 16-byte boundary."""
    buf = torch.zeros(t.numel() + 1, dtype=t.dtype)[1:]
    return buf.view(t.shape)


TILE_SMEM = {torch.float32: 3 * (128 * 36 * 4 + 32 * 72 * 4),
             torch.bfloat16: 3 * (128 * 36 * 4 + 32 * 72 * 2),
             torch.int8: 3 * (128 * 36 * 4 + 32 * 80)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
@pytest.mark.parametrize("w,f,regime,cols", [
    (22, 2048, "stream", 16), (22, 64, "stream", 16),
    (22, 4096, "stream", 32), (48, 2048, "stream", 16),
    (49, 2048, "tile", 0), (128, 4096, "tile", 0), (500, 4099, "tile", 0)])
def test_dense_regime_and_launch_arguments(monkeypatch, dtype, w, f, regime,
                                           cols):
    """The dense mix's regime follows from W (stream up to
    GOSSIP_STREAM_MAX_W, tile above), with the stream slice cut so the grid
    covers 132 SMs; the C entry gets W, F, the dtype code, the regime,
    the slice width, the alignment flags and the shared-memory bytes (the
    stream regime: P transposed with rows padded to 4, the slice in the
    payload's type; the tile regime: its 3-stage ring). One launch, counted
    under its regime."""
    assert ops.GOSSIP_STREAM_MAX_W == 48
    calls = stub_launches(monkeypatch)
    size = torch.empty((), dtype=dtype).element_size()
    P, x = torch.zeros(w, w), torch.zeros(w, f, dtype=dtype)
    before = ops.REGIMES.get(f"gossip_mix/{regime}", 0)
    out = ops.gossip_mix(P, x)
    assert out.shape == (w, f) and out.dtype == torch.float32
    (name, args), = calls
    ps = -(-w // 4) * 4
    ps += 4 * (ps % 8 == 0)                  # 8 rows in 8 bank groups
    smem = w * ps * 4 + w * cols * size \
        if regime == "stream" else TILE_SMEM[dtype]
    flags = (ops.W_ROWS16 * (f * size % 16 == 0) | ops.OUT_ROWS16
             * (f % 4 == 0) | ops.P_ROWS16 * (w % 4 == 0))
    assert name == "gossip_mix"
    assert args[3:] == (w, f, ops._DTYPE_CODE[dtype],
                        int(regime == "tile"), cols, flags, smem)
    assert ops.REGIMES[f"gossip_mix/{regime}"] == before + 1
    # bases off a 16-byte boundary clear the flags, not the regime
    calls.clear()
    ops.gossip_mix(offset(P), offset(x))
    (_, args), = calls
    assert args[6:8] == (int(regime == "tile"), cols)
    assert args[8] == flags & ops.OUT_ROWS16


def test_dense_regime_boundary_and_refusals(monkeypatch):
    """Each side of the regime boundary, the stream regime's fallback to
    the tile regime where P and a 16-column slice do not fit in shared
    memory, and a refusal where the grid would exceed 2**31 - 1 CTAs,
    before any launch."""
    b = ops.GOSSIP_STREAM_MAX_W
    assert ops.gossip_mix_plan(b, 2048, torch.float32)[0] == "stream"
    assert ops.gossip_mix_plan(b + 1, 2048, torch.float32)[0] == "tile"
    monkeypatch.setattr(ops, "GOSSIP_STREAM_MAX_W", 1000)
    # P's stride is 236 at W = 229..232: 230 rows take 231,840 bytes with
    # a 16-column slice, 231 rows 232,848 (> 232,448)
    assert ops.gossip_mix_plan(230, 4096, torch.float32) == \
        ("stream", 16, 230 * 236 * 4 + 230 * 16 * 4)
    assert ops.gossip_mix_plan(231, 4096, torch.float32)[0] == "tile"
    monkeypatch.undo()
    calls = stub_launches(monkeypatch)
    f = 128 * (2 ** 31)                       # 2**31 slices of 128
    with pytest.raises(ValueError, match="grid"):
        ops.gossip_mix(torch.empty(8, 8, device="meta"),
                       torch.empty(8, f, dtype=torch.int8, device="meta"))
    with pytest.raises(TypeError):
        ops.gossip_mix(torch.zeros(8, 8), torch.zeros(8, 4,
                                                      dtype=torch.float64))
    assert calls == []


def quant_inputs(w, k, f, q_offset=False):
    q = torch.zeros(w, f, dtype=torch.int8)
    return (torch.zeros(w, k, dtype=torch.int32), torch.zeros(w, k),
            torch.ones(w), offset(q) if q_offset else q)


def slice_fits(w, k, cols=16):
    """Whether the slice branch fits: q's slice, scale and one row of
    slots in 232,448 bytes (each of the first two rounded up to 16)."""
    r16 = lambda x: -(-x // 16) * 16                   # noqa: E731
    return r16(w * cols) + 4 * r16(w) + 8 * k <= 232448


@pytest.mark.parametrize("w,k,f,cols,rows,align", [
    (22, 5, 2048, 16, 22, 16), (22, 5, 10, 16, 22, 1),
    (22, 5, 72, 16, 22, 4), (22, 5, 64, 16, 22, 16),
    (500, 25, 4096, 32, 500, 16), (500, 25, 4099, 32, 500, 1),
    (5000, 25, 2048, 16, 662, 16)])
def test_quant_slice_branch_launch_arguments(monkeypatch, w, k, f, cols,
                                             rows, align):
    """The slice branch's C entry gets W, K, F, branch 1, the slice width
    (grid over 132 SMs), the rows per slot group (all W where they fit,
    else as many as fit), the copy width of q's rows (16 bytes, 4, or
    plain loads) and its shared-memory bytes."""
    calls = stub_launches(monkeypatch)
    before = ops.REGIMES.get("gossip_mix_quant/slices", 0)
    ops.gossip_mix_quant(*quant_inputs(w, k, f))
    (name, args), = calls
    r16 = lambda x: -(-x // 16) * 16                   # noqa: E731
    smem = r16(w * cols) + 4 * r16(w) + 8 * rows * k
    assert name == "gossip_mix_quant" and smem <= 232448
    assert args[5:] == (w, k, f, 1, cols, rows, align, smem)
    assert ops.REGIMES["gossip_mix_quant/slices"] == before + 1
    calls.clear()
    ops.gossip_mix_quant(*quant_inputs(w, k, f, q_offset=True))
    (_, args), = calls
    assert args[11] == 1                       # an odd base: plain loads


def test_quant_branch_boundary_and_refusals(monkeypatch):
    """The gather branch starts at the first W where one 16-column slice,
    scale and one row of slots no longer fit (W = 11,618 at K = 5); it gets
    no shared memory and 16-byte loads only where q's rows allow them.
    W * K slots past 2**31 - 1 are refused before any launch."""
    w_max = max(w for w in range(11000, 12000) if slice_fits(w, 5))
    assert w_max == 11617
    assert ops.gossip_mix_quant_plan(w_max, 5, 4096)[0] == 1
    assert ops.gossip_mix_quant_plan(w_max + 1, 5, 4096) == (2, 0, 0, 0)
    calls = stub_launches(monkeypatch)
    for f, align in ((64, 16), (72, 1), (10, 1)):
        ops.gossip_mix_quant(*quant_inputs(w_max + 1, 5, f))
        (name, args), = calls
        assert args[5:] == (w_max + 1, 5, f, 2, 0, 0, align, 0)
        calls.clear()
    assert ops.REGIMES["gossip_mix_quant/gather"] >= 3
    n, k = 2 ** 16, 2 ** 15 + 1
    with pytest.raises(ValueError, match="2\\*\\*31"):
        ops.gossip_mix_quant(
            torch.empty(n, k, dtype=torch.int32, device="meta"),
            torch.empty(n, k, device="meta"), torch.empty(n, device="meta"),
            torch.empty(n, 16, dtype=torch.int8, device="meta"))
    assert calls == []
