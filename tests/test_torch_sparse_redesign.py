"""The redesigned padded-CSR gossip mix on the CPU: an emulation of the CUDA
kernel's slice branch (``src/repro_torch/kernels/csrc/gossip_mix_sparse.cu``)
held to chip_smoke's limit, 1e-5 (1 + max|want|), against the port's plain
version and the JAX package's Pallas kernel in interpret mode, with mutants
the limit must reject; the propagation of inf through a zero-weight slot;
and the wrapper's card-side branch (branch, slice width, threads, copy
width, shared-memory bytes, refusals) with the launch stubbed.

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

SMEM_MAX = 232448


def limit_ratio(got, want):
    """max |got - want| / (1e-5 (1 + max|want|)): chip_smoke's limit."""
    err = float((got.double() - want.double()).abs().max())
    return err / (1e-5 * (1.0 + float(want.abs().max())))


def sparse_world(w: int, f: int, seed: int, dtype=torch.float32):
    """Padded-CSR weights of a topology whose rows have degrees 1..4 (pad
    slots: the row's own index at weight 0), about 30 % of the peers
    unsampled (weight 0, as in a round), and a payload of scale 2 in
    ``dtype``: (idx, val, w)."""
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
    return idx, val, x.to(dtype)


def jax_mix(idx, val, w):
    """The JAX package's sparse mix (Pallas, interpret mode), fp32 out."""
    jw = jnp.asarray(w.float().numpy())
    if w.dtype == torch.bfloat16:
        jw = jw.astype(jnp.bfloat16)
    return torch.tensor(np.asarray(jops.gossip_mix_sparse(
        jnp.asarray(idx.numpy()), jnp.asarray(val.numpy()), jw,
        out_dtype=jnp.float32)))


def fma(v, x, acc):
    """fmaf in fp32: the product exact in fp64, then one rounding."""
    return (v.double() * x.double() + acc.double()).float()


def slices_emulation(idx, val, w, plan, *, rows=None, shift=0,
                     row_shift=0, drop_last=False, skip_zero=False):
    """The slice branch as the kernel runs it: CTA (s, y) takes the slice
    of ``plan.cols`` columns, w[:, slice] flattened in w's own type (zeros
    past F), and the rows of part y of ``plan.split``, in slot groups of
    ``rows`` (default ``plan.rows``) rows; for each row the staged slots
    (the source row j, the weight); thread cg reads the 4 values at
    j * cols + 4 cg + c, widens them to fp32 and folds each slot with one
    fp32 FMA in k order; only columns below F are stored. Mutants: the
    slice read ``shift`` columns off its origin; the source row read as
    j + ``row_shift``; the last slot dropped; zero-weight slots
    skipped."""
    n, f = w.shape
    k = idx.shape[1]
    cols, rows = plan.cols, rows or plan.rows
    part = -(-n // plan.split)
    out = torch.full((n, f), float("nan"))
    wz = torch.nn.functional.pad(w, (0, cols + shift))
    lanes = (4 * torch.arange(cols // 4)[:, None]
             + torch.arange(4)[None, :]).reshape(-1)      # thread cg, c
    for s0 in range(0, f, cols):
        sw = wz[:, s0 + shift:s0 + shift + cols].reshape(-1)  # [W * cols]
        for r_lo in range(0, n, part):
            r_hi = min(n, r_lo + part)
            for g0 in range(r_lo, r_hi, rows):
                g = slice(g0, min(r_hi, g0 + rows))
                src = (idx[g].long() + row_shift) % n
                acc = torch.zeros(src.shape[0], cols)
                for kk in range(k - drop_last):
                    v = val[g, kk, None]
                    x = sw[src[:, kk, None] * cols + lanes[None, :]].float()
                    new = fma(v, x, acc)
                    acc = torch.where(v == 0, acc, new) if skip_zero else new
                stop = min(f, s0 + cols)
                out[g, s0:stop] = acc[:, :stop - s0]
    return out


SLICE_CASES = [(37, 10), (37, 72), (37, 1001), (37, 2048), (37, 4099)]


@pytest.mark.parametrize("w,f", SLICE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slices_layout_matches_plain_and_jax(w, f, dtype):
    """The slice branch's layout at the plan's slice width and row split
    (37 rows in 1, 2 or 4 parts, each one slot group) and in slot groups
    of 3 rows (the last group of each part ragged) equals the plain
    version and JAX's Pallas kernel within the limit, pad slots and
    zero-weight peers included."""
    idx, val, x = sparse_world(w, f, seed=w + f, dtype=dtype)
    assert bool((val == 0).any())
    plan = ops.gossip_mix_sparse_plan(w, idx.shape[1], f, dtype)
    assert plan.branch == 1 and plan.split in (1, 2, 4)
    assert plan.rows == -(-w // plan.split)
    want = ref.gossip_mix_sparse_ref(idx, val, x)
    jax_want = jax_mix(idx, val, x)
    for rows in (plan.rows, 3):
        got = slices_emulation(idx, val, x, plan, rows=rows)
        assert limit_ratio(got, want) <= 0.1
        assert limit_ratio(got, jax_want) <= 0.1


@pytest.mark.parametrize("w,f", SLICE_CASES)
@pytest.mark.parametrize("fault", [{"shift": 1}, {"row_shift": 1},
                                   {"drop_last": True}])
def test_slices_limit_rejects_layout_faults(w, f, fault):
    """A slice read one column off its origin, a slot read from the wrong
    source row, or the last slot dropped breaks the limit many times."""
    idx, val, x = sparse_world(w, f, seed=w + f)
    plan = ops.gossip_mix_sparse_plan(w, idx.shape[1], f, torch.float32)
    want = ref.gossip_mix_sparse_ref(idx, val, x)
    got = slices_emulation(idx, val, x, plan, rows=3, **fault)
    assert not limit_ratio(got, want) <= 20.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_zero_weight_slot_on_an_inf_row_gives_nan(dtype):
    """A zero-weight slot (an unsampled peer) that names a row holding inf
    adds 0 * inf = NaN: the port's plain version, JAX's Pallas kernel and
    the kernel's emulation give NaN at the same places. Skipping the
    zero-weight slots would give another result."""
    idx, val, x = sparse_world(22, 72, seed=5, dtype=dtype)
    zero = (val == 0) & (idx != torch.arange(22)[:, None])
    i, kk = (int(t) for t in zero.nonzero()[0])
    j = int(idx[i, kk])
    x[j, 3:9] = float("inf")
    want = ref.gossip_mix_sparse_ref(idx, val, x)
    jax_want = jax_mix(idx, val, x)
    plan = ops.gossip_mix_sparse_plan(22, idx.shape[1], 72, dtype)
    got = slices_emulation(idx, val, x, plan)
    assert bool(want[i, 3:9].isnan().all())
    for other in (jax_want, got):
        assert torch.equal(other.isnan(), want.isnan())
        assert torch.equal(other.isinf(), want.isinf())
        fin = want.isfinite()
        assert limit_ratio(other[fin], want[fin]) <= 0.1
    skipped = slices_emulation(idx, val, x, plan, skip_zero=True)
    assert not torch.equal(skipped.isnan(), want.isnan())


# ---------------------------------------------------------------------------
# Card-side branch of the wrapper, launch stubbed
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
    is 4 (f32) or 2 (bf16) bytes off a 16-byte boundary."""
    buf = torch.zeros(t.numel() + 1, dtype=t.dtype)[1:]
    return buf.view(t.shape)


def sparse_inputs(w, k, f, dtype, w_offset=False):
    x = torch.zeros(w, f, dtype=dtype)
    return (torch.zeros(w, k, dtype=torch.int32), torch.zeros(w, k),
            offset(x) if w_offset else x)


def slice_fits(w, k, size):
    """Whether the slice branch fits: a 16-column slice of w (rounded up
    to 16 bytes) and two slot groups of at least 2,048 slots of 8 bytes
    (whole rows), in 232,448 bytes."""
    return -(-w * 16 * size // 16) * 16 + 2 * -(-2048 // k) * k * 8 \
        <= SMEM_MAX


F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("dtype,w,k,f,cols,split,rows,threads,align", [
    (F32, 22, 5, 2048, 32, 2, 11, 256, 16),
    (F32, 22, 5, 64, 32, 2, 11, 256, 16),
    (F32, 22, 5, 10, 32, 2, 11, 256, 4),
    (F32, 22, 5, 1001, 32, 2, 11, 256, 4),
    (F32, 22, 5, 4096, 32, 1, 22, 256, 16),
    (F32, 22, 5, 65536, 256, 1, 22, 1024, 16),
    (F32, 500, 25, 4096, 32, 1, 500, 1024, 16),
    (F32, 500, 25, 4099, 32, 1, 500, 1024, 4),
    (F32, 2000, 25, 2048, 16, 1, 261, 1024, 16),
    (BF16, 22, 5, 2048, 64, 2, 11, 256, 16),
    (BF16, 22, 5, 640, 64, 2, 11, 256, 16),
    (BF16, 22, 5, 10, 64, 2, 11, 256, 4),
    (BF16, 22, 5, 1001, 64, 2, 11, 256, 2),
    (BF16, 48, 16, 2048, 64, 4, 12, 256, 16),
    (BF16, 500, 25, 4096, 64, 2, 250, 1024, 16),
    (BF16, 500, 25, 4099, 64, 2, 250, 1024, 2),
    (BF16, 2000, 25, 2048, 32, 2, 261, 1024, 16)])
def test_slice_branch_launch_arguments(monkeypatch, dtype, w, k, f, cols,
                                       split, rows, threads, align):
    """The slice branch's C entry gets W, K, F, the dtype code, branch 1,
    the slice width (rows of 128 bytes or more, as narrow as keeps the
    grid within 132 SMs, narrower where W x cols does not fit), the row
    split (parts of at least 8 rows filling the SMs that few slices
    leave), the rows per slot group (all of a CTA's rows where their
    slots fit beside the slice, else as many as fit twice), the threads
    per CTA (1024 where rows x cols / 4 exceed 256), the copy width of w's
    rows (16 bytes where F allows, else 4 bytes, else the element size)
    and its shared-memory bytes: the slice, then one slot buffer (one
    group) or two. One launch, counted under gossip_mix_sparse/slices."""
    size = torch.empty((), dtype=dtype).element_size()
    bufs = 1 if rows == -(-w // split) else 2
    smem = -(-w * cols * size // 16) * 16 + bufs * rows * k * 8
    calls = stub_launches(monkeypatch)
    before = ops.REGIMES.get("gossip_mix_sparse/slices", 0)
    out = ops.gossip_mix_sparse(*sparse_inputs(w, k, f, dtype))
    assert out.shape == (w, f) and out.dtype == torch.float32
    (name, args), = calls
    assert name == "gossip_mix_sparse" and smem <= SMEM_MAX
    assert args[4:] == (w, k, f, ops._DTYPE_CODE[dtype], 1, cols, split,
                        rows, threads, align, smem)
    assert ops.REGIMES["gossip_mix_sparse/slices"] == before + 1
    # a base off a 16-byte boundary: 4-byte copies (f32) or element loads
    # (bf16, 2 bytes off), the plan otherwise unchanged
    calls.clear()
    ops.gossip_mix_sparse(*sparse_inputs(w, k, f, dtype, w_offset=True))
    (_, args), = calls
    assert args[13] == (4 if dtype == torch.float32 else 2)
    assert args[8:13] == (1, cols, split, rows, threads)
    assert args[14] == smem


@pytest.mark.parametrize("dtype,w_max", [(torch.float32, 3119),
                                         (torch.bfloat16, 6239)])
def test_branch_boundary_and_gather_launch(monkeypatch, dtype, w_max):
    """The gather branch starts at the first W where a 16-column slice and
    two slot groups of 2,048 slots no longer fit (W = 3,120 for f32 and
    6,240 for bf16 at K = 5; groups of 410 rows); it gets 256 threads, no
    shared memory and 16-byte loads only where w's rows and base allow
    them, else element loads. Counted under gossip_mix_sparse/gather."""
    size = torch.empty((), dtype=dtype).element_size()
    assert w_max == max(w for w in range(2000, 8000)
                        if slice_fits(w, 5, size))
    assert ops.gossip_mix_sparse_plan(w_max, 5, 4096, dtype)[:4] == \
        (1, 16, 1, 410)
    assert ops.gossip_mix_sparse_plan(w_max + 1, 5, 4096, dtype) == \
        (2, 0, 1, 0, 256, 16, 0)
    calls = stub_launches(monkeypatch)
    before = ops.REGIMES.get("gossip_mix_sparse/gather", 0)
    for f, w_offset, align in ((64, False, 16), (64, True, size),
                               (10, False, size)):
        ops.gossip_mix_sparse(*sparse_inputs(w_max + 1, 5, f, dtype,
                                             w_offset))
        (name, args), = calls
        assert name == "gossip_mix_sparse"
        assert args[4:] == (w_max + 1, 5, f, ops._DTYPE_CODE[dtype], 2, 0,
                            1, 0, 256, align, 0)
        calls.clear()
    assert ops.REGIMES["gossip_mix_sparse/gather"] == before + 3


def test_refusals_before_any_launch(monkeypatch):
    """A grid of 2**31 CTAs or more, W * K slots of 2**31 or more, and
    payload or index types the kernel does not take are refused before any
    launch."""
    calls = stub_launches(monkeypatch)
    f = 256 * 2 ** 31                          # 2**31 slices of 256
    with pytest.raises(ValueError, match="2\\*\\*31"):
        ops.gossip_mix_sparse(
            torch.empty(8, 5, dtype=torch.int32, device="meta"),
            torch.empty(8, 5, device="meta"),
            torch.empty(8, f, dtype=torch.bfloat16, device="meta"))
    n, k = 2 ** 16, 2 ** 15 + 1
    with pytest.raises(ValueError, match="2\\*\\*31"):
        ops.gossip_mix_sparse(
            torch.empty(n, k, dtype=torch.int32, device="meta"),
            torch.empty(n, k, device="meta"),
            torch.empty(n, 16, device="meta"))
    with pytest.raises(TypeError):
        ops.gossip_mix_sparse(*sparse_inputs(4, 2, 8, torch.float64))
    idx, val, x = sparse_inputs(4, 2, 8, torch.float32)
    with pytest.raises(TypeError):
        ops.gossip_mix_sparse(idx.long(), val, x)
    assert calls == []
