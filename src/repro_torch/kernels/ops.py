"""Wrappers of the port's kernels: the three gossip mixes, flash attention
(a TMA + wgmma kernel for bf16 at D in {64, 128}, an mma.sync kernel,
``flash_attention``, for the rest), the MoE router (alone, and fused with
the grouped dispatch's slot assignment) and the Mamba2 SSD intra-chunk
term (a tensor-core kernel in 3xTF32).

Each wrapper checks device, dtype, shape and layout, then runs the plain
PyTorch version (``ref``) when the tensors lie on the CPU and the CUDA
kernel (``csrc/``, built by ``build``) when they lie on the card. On the
card it launches the kernel or raises; it never falls back. Every output
is a fresh tensor, in the layout the kernel writes (the CPU copies the
plain version's result into it). ``LAUNCHES[name]`` counts kernel
launches (never plain-version calls), so a run can show that it went
through the kernels.

On torch's ``meta`` device (the dry run, ``launch.dryrun``) a wrapper runs
its checks, the card's included (regime, grid and alignment), and returns
empty meta outputs of the kernel's shapes, dtypes and layout: it computes
nothing, launches nothing and counts no launch or regime. On every device
a call records the kernel it stands for, with its
``cost.kernel_cost``, in the active counting pass
(``repro_torch.counting``), once per call that launches (or would launch) a
kernel; the ops inside the wrapper are not counted. Under autograd the
router, route-and-slot and SSD wrappers go through their Functions on
every device, as flash attention does, so the CPU, the card and the dry
run count one program.

The padded-CSR ``idx`` must lie in [0, W) (``core.gossip.sparse_weights``
builds it so). It is not checked on the card, where a check would cost a
device synchronize per call.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from repro_torch import counting
from repro_torch.kernels import build, ref
from repro_torch.kernels.cost import kernel_cost

LAUNCHES = {name: 0 for name in build.KERNELS}
# launches of the gossip mixes by regime or branch ("gossip_mix/stream",
# "gossip_mix/tile", "gossip_mix_sparse/slices", "gossip_mix_sparse/gather",
# "gossip_mix_quant/slices", "gossip_mix_quant/gather"): each also counts
# once under its kernel in LAUNCHES
REGIMES: dict = {}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    REGIMES.clear()


def _count_regime(name: str, out):
    REGIMES[name] = REGIMES.get(name, 0) + 1
    return out


def _check(name, t, dtypes, shape):
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in "
                        f"{[str(d) for d in dtypes]}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _on_meta(*ts) -> bool:
    """True for meta tensors (the dry run), False for any others; raises
    on meta tensors mixed with others."""
    kinds = {t.device.type for t in ts}
    if "meta" not in kinds:
        return False
    if kinds != {"meta"}:
        raise ValueError(f"tensors on several devices: {sorted(kinds)}")
    return True


def _cost(name: str, numel: int, **shape):
    """The active counting pass's record of one call of kernel ``name`` at
    ``shape`` (``cost.kernel_cost``); nothing where no pass is active
    or the call launches nothing (an empty output)."""
    if counting.active() is None or numel == 0:
        return contextlib.nullcontext()
    return counting.kernel(name, *kernel_cost(name, **shape))


def _into(like, value):
    """``value`` copied into a fresh tensor of ``like``'s layout (the
    layout the card's kernel writes)."""
    return torch.empty_like(like).copy_(value)


def _on_card(*ts) -> bool:
    """True for CUDA tensors, False for CPU ones; raises on a mix or on any
    other device."""
    kinds = {t.device for t in ts}
    if len(kinds) != 1:
        raise ValueError(f"tensors on several devices: "
                         f"{sorted(map(str, kinds))}")
    dev = kinds.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cuda"


def _launch(name, out, *args):
    """Call the kernel's C entry on the tensors' device and its current
    stream; raise on a refused launch, count it otherwise."""
    fn = build.load(name, len(args) + 1)
    with torch.cuda.device(out.device):
        rc = fn(*args, torch.cuda.current_stream(out.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {rc})")
    LAUNCHES[name] += 1
    return out


GOSSIP_SMS = 132            # the H100 SXM's SMs: slices are cut to cover them
GOSSIP_SMEM_MAX = 232448    # dynamic shared memory a CTA may opt in to
GOSSIP_GRID_MAX = 2 ** 31 - 1
# The dense mix's regimes (csrc/gossip_mix.cu): "stream" (P resident in
# shared memory, a column slice of all W rows per CTA, fp32 FMAs) up to
# this W, "tile" (3xTF32 mma.sync tiles) above it. Set from device us per
# call, stream / tile, f32 payload at F = 2048 and 4096
# (benchmarks/gossip_probe.py; NVIDIA H100 80GB HBM3, 700 W):
#   W = 22: 2.48 / 3.68, 2.48 / 3.80;   W = 32: 2.70 / 3.36, 2.98 / 3.53;
#   W = 48: 3.47 / 4.55, 4.28 / 4.71;   W = 64: 4.52 / 4.56, 5.34 / 4.69;
#   W = 96: 6.63 / 5.88, 7.03 / 5.97;   W = 128: 8.00 / 7.69, 8.55 / 7.87;
#   W = 200: 13.23 / 11.69, 19.63 / 11.76
# (int8 payloads: the regimes tie at W = 48, the tile regime wins from 64).
GOSSIP_STREAM_MAX_W = 48
GOSSIP_TILE = (128, 64)     # the tile regime's CTA tile of out (rows, cols)
# the tile regime's 3-stage ring: P tiles 128 x 36 floats and w tiles of
# 32 rows of 72 (f32, bf16) or 80 (int8) elements
_TILE_SMEM = {torch.float32: 3 * (128 * 36 * 4 + 32 * 72 * 4),
              torch.bfloat16: 3 * (128 * 36 * 4 + 32 * 72 * 2),
              torch.int8: 3 * (128 * 36 * 4 + 32 * 80)}
# alignment flags of the dense mix's launch
W_ROWS16, OUT_ROWS16, P_ROWS16 = 1, 2, 4


def _slice_cols(f: int, widest: int) -> int:
    """Columns per CTA of a column-slice kernel: the narrowest power of two
    from 16 to ``widest`` at which ceil(f / cols) CTAs stay within
    ``GOSSIP_SMS``, so the grid covers the SMs where F allows it."""
    cols = 16
    while cols < widest and -(-f // cols) > GOSSIP_SMS:
        cols *= 2
    return cols


def stream_p_stride(n: int) -> int:
    """P's row stride (floats) in the stream regime's shared memory: W
    rounded up to 4, plus 4 where that is a multiple of 8, so that eight
    consecutive rows start in eight different bank groups."""
    ps = -(-n // 4) * 4
    return ps + 4 if ps % 8 == 0 else ps


def gossip_mix_plan(n: int, f: int, dtype):
    """(regime, cols, smem) of the dense mix at W = n, F = f for a payload
    of ``dtype``: "stream" with its slice width and shared-memory bytes
    (P with rows padded as ``stream_p_stride`` pads them, the slice in its
    own type) for n <= ``GOSSIP_STREAM_MAX_W`` where that fits, else
    "tile" (cols 0)."""
    if n <= GOSSIP_STREAM_MAX_W:
        size = torch.empty((), dtype=dtype).element_size()
        cols = _slice_cols(f, 128)
        ptw = n * stream_p_stride(n) * 4
        while cols > 16 and ptw + n * cols * size > GOSSIP_SMEM_MAX:
            cols //= 2
        if ptw + n * cols * size <= GOSSIP_SMEM_MAX:
            return "stream", cols, ptw + n * cols * size
    return "tile", 0, _TILE_SMEM[dtype]


def gossip_mix(P, w):
    """Dense mix ``P @ w``: P [W, W] f32; w [W, F] f32, bf16 or int8.

    On the card the regime follows from W alone (``gossip_mix_plan``):
    the stream regime at W <= ``GOSSIP_STREAM_MAX_W`` (fp32 FMAs), the
    tile regime above it (tensor cores in 3xTF32, two products for a bf16
    or int8 payload, fp32-accurate either way); one launch and one count
    under ``gossip_mix`` each."""
    n, f = w.shape
    _check("P", P, (torch.float32,), (n, n))
    _check("w", w, tuple(_DTYPE_CODE), (n, f))
    with _cost("gossip_mix", n * f, w=n, f=f, in_bytes=w.element_size()):
        if not _on_meta(P, w) and not _on_card(P, w):
            return ref.gossip_mix_ref(P, w)
        return _gossip_mix_launch(P, w)


def _gossip_mix_launch(P, w):
    n, f = w.shape
    regime, cols, smem = gossip_mix_plan(n, f, w.dtype)
    grid = -(-f // cols) if regime == "stream" else \
        -(-n // GOSSIP_TILE[0]) * -(-f // GOSSIP_TILE[1])
    if grid > GOSSIP_GRID_MAX:
        raise ValueError(f"gossip_mix: W = {n}, F = {f} needs {grid} CTAs, "
                         f"more than a grid holds")
    out = torch.empty((n, f), dtype=torch.float32, device=w.device)
    if out.numel() == 0 or out.is_meta:
        return out
    flags = (W_ROWS16 * (f * w.element_size() % 16 == 0
                         and w.data_ptr() % 16 == 0)
             | OUT_ROWS16 * (f % 4 == 0 and out.data_ptr() % 16 == 0)
             | P_ROWS16 * (n % 4 == 0 and P.data_ptr() % 16 == 0))
    _launch("gossip_mix", out, P.data_ptr(), w.data_ptr(), out.data_ptr(),
            n, f, _DTYPE_CODE[w.dtype], int(regime == "tile"), cols, flags,
            smem)
    return _count_regime(f"gossip_mix/{regime}", out)


SPARSE_GATHER_THREADS = 256    # the sparse mix's per-row gather branch
SPARSE_SPLIT_MIN_ROWS = 8      # rows per part, at least, of a row split
# slots per slot group, at least, in the slice branch: a shorter group
# cannot hide its copies (W = 3,592, K = 5: groups of 32 rows took 195 us
# against the per-row gather's 80; groups of 505 rows at W = 3,000 took
# 54 against 65; benchmarks/gossip_probe.py on an NVIDIA H100 80GB HBM3)
SPARSE_MIN_GROUP_SLOTS = 2048


class SparsePlan(NamedTuple):
    """Launch arguments of the sparse mix (``gossip_mix_sparse_plan``)."""
    branch: int       # 1: column slices; 2: per-row gather
    cols: int         # branch 1: columns per CTA (else 0)
    split: int        # branch 1: parts the rows are split into (grid.y)
    rows: int         # branch 1: rows per slot group (else 0)
    threads: int      # per CTA
    align: int        # bytes per copy of w's rows: 16, 4 or the element size
    smem: int         # dynamic shared-memory bytes (0 for branch 2)


def _sparse_slice_bytes(n: int, k: int, cols: int, split: int, rows: int,
                        size: int) -> int:
    """Shared-memory bytes of the sparse mix's slice branch: w's slice of
    all ``n`` rows in its own type (rounded up to 16 bytes), then one
    buffer of ``rows`` rows of slots (a source row and a weight each)
    where that holds all of a CTA's rows, else two."""
    part = -(-n // split)
    return -(-n * cols * size // 16) * 16 + \
        8 * rows * k * (2 if rows < part else 1)


def _sparse_rows(n: int, k: int, cols: int, split: int, size: int) -> int:
    """Rows per slot group of the slice branch: all of a CTA's rows where
    their slots fit beside the slice (one group, no barrier between its
    rows), else as many as fit twice (double-buffered groups)."""
    part = -(-n // split)
    room = GOSSIP_SMEM_MAX - _sparse_slice_bytes(n, k, cols, 1, 0, size)
    if k == 0 or 8 * part * k <= room:
        return part
    return room // (16 * k)


def sparse_slices_plan(n: int, k: int, f: int, size: int, ptr: int = 0):
    """The slice branch's launch at W = n, K = k, F = f for payload
    elements of ``size`` bytes at base address ``ptr``, or None where one
    16-column slice of all W rows and two slot groups of
    ``SPARSE_MIN_GROUP_SLOTS`` slots (one group of all W rows, if fewer)
    do not fit in ``GOSSIP_SMEM_MAX``:
    - slices of at least 128 bytes a row (32 f32 or 64 bf16 columns, so
      the gather's loads are free of bank conflicts), as narrow as keeps
      ceil(F / cols) within ``GOSSIP_SMS``;
    - where those slices are fewer than the SMs, the rows split into
      parts of at least ``SPARSE_SPLIT_MIN_ROWS`` to fill them;
    - a thread per 4 columns of a row: 256 threads a CTA, or 1024 where
      its rows need more;
    - the slots staged all at once where they fit, else in
      double-buffered groups (``_sparse_rows``);
    - 16-byte copies of w's rows where F and ``ptr`` allow them, else
      4-byte copies, else element loads."""
    group = min(n, max(1, -(-SPARSE_MIN_GROUP_SLOTS // max(k, 1))))

    def fits(c):
        return _sparse_slice_bytes(n, k, c, 1, group, size) <= \
            GOSSIP_SMEM_MAX

    cols = max(128 // size, _slice_cols(f, 256))
    while cols > 16 and not fits(cols):
        cols //= 2
    if not fits(cols):
        return None
    split = max(1, min(GOSSIP_SMS // -(-f // cols),
                       n // SPARSE_SPLIT_MIN_ROWS))
    threads = 256 if -(-n // split) * (cols // 4) <= 256 else 1024
    rows = _sparse_rows(n, k, cols, split, size)
    align = 16 if f * size % 16 == 0 and ptr % 16 == 0 else \
        4 if f * size % 4 == 0 and ptr % 4 == 0 else size
    return SparsePlan(1, cols, split, rows, threads, align,
                      _sparse_slice_bytes(n, k, cols, split, rows, size))


def gossip_mix_sparse_plan(n: int, k: int, f: int, dtype,
                           ptr: int = 0) -> SparsePlan:
    """The sparse mix's launch at W = n, K = k, F = f on a payload of
    ``dtype`` whose base address is ``ptr``: branch 1, column slices
    (``sparse_slices_plan``), where they fit; else branch 2, the per-row
    gather, with 16-byte loads where F and ``ptr`` allow them, else
    element loads."""
    size = torch.empty((), dtype=dtype).element_size()
    slices = sparse_slices_plan(n, k, f, size, ptr)
    if slices is not None:
        return slices
    return SparsePlan(2, 0, 1, 0, SPARSE_GATHER_THREADS,
                      16 if f * size % 16 == 0 and ptr % 16 == 0 else size,
                      0)


def gossip_mix_sparse(idx, val, w):
    """Padded-CSR mix: idx [W, K] int32; val [W, K] f32 (0 on pad slots);
    w [W, F] f32 or bf16. out[i] = sum_k val[i, k] * w[idx[i, k]], every
    slot folded in k order, weight 0 included.

    On the card the branch follows from the shapes alone
    (``gossip_mix_sparse_plan``): column slices of w in shared memory, or
    the per-row gather at W too large for one slice; one launch and one
    count under ``gossip_mix_sparse`` each."""
    n, f = w.shape
    k = idx.shape[1]
    _check("idx", idx, (torch.int32,), (n, k))
    _check("val", val, (torch.float32,), (n, k))
    _check("w", w, (torch.float32, torch.bfloat16), (n, f))
    with _cost("gossip_mix_sparse", n * f, w=n, k=k, f=f,
               in_bytes=w.element_size()):
        if not _on_meta(idx, val, w) and not _on_card(idx, val, w):
            return ref.gossip_mix_sparse_ref(idx, val, w)
        return _gossip_mix_sparse_launch(idx, val, w)


def _gossip_mix_sparse_launch(idx, val, w):
    n, f = w.shape
    k = idx.shape[1]
    plan = gossip_mix_sparse_plan(n, k, f, w.dtype, w.data_ptr())
    grid = -(-f // plan.cols) if plan.branch == 1 else \
        n * -(-f // (SPARSE_GATHER_THREADS * 16 // w.element_size()))
    if grid > GOSSIP_GRID_MAX or n * k > GOSSIP_GRID_MAX:
        raise ValueError(f"gossip_mix_sparse: W = {n}, K = {k}, F = {f} "
                         f"needs {grid} CTAs and {n * k} slots; both must "
                         f"stay below 2**31")
    out = torch.empty((n, f), dtype=torch.float32, device=w.device)
    if out.numel() == 0 or out.is_meta:
        return out
    _launch("gossip_mix_sparse", out, idx.data_ptr(), val.data_ptr(),
            w.data_ptr(), out.data_ptr(), n, k, f, _DTYPE_CODE[w.dtype],
            *plan)
    return _count_regime("gossip_mix_sparse/" +
                         ("slices" if plan.branch == 1 else "gather"), out)


def _quant_slice_bytes(n: int, k: int, cols: int, rows: int) -> int:
    """Shared-memory bytes of the int8 mix's slice branch: q's slice (int8),
    scale (both rounded up to 16 bytes) and ``rows`` rows of slots (a
    folded weight and a row offset each)."""
    r16 = lambda x: -(-x // 16) * 16               # noqa: E731
    return r16(n * cols) + 4 * r16(n) + 8 * rows * k


def gossip_mix_quant_plan(n: int, k: int, f: int):
    """(branch, cols, rows, smem) of the int8 mix at W = n, K = k, F = f:
    branch 1, column slices (``cols`` int8 columns of all W rows per CTA,
    slots staged ``rows`` rows at a time, all W where they fit), while one
    16-column slice and one row of slots fit in ``GOSSIP_SMEM_MAX``; else
    branch 2, the per-row gather (0, 0, 0)."""
    cols = _slice_cols(f, 256)
    while cols > 16 and _quant_slice_bytes(n, k, cols, 1) > GOSSIP_SMEM_MAX:
        cols //= 2
    if _quant_slice_bytes(n, k, cols, 1) > GOSSIP_SMEM_MAX:
        return 2, 0, 0, 0
    room = GOSSIP_SMEM_MAX - _quant_slice_bytes(n, k, cols, 0)
    rows = min(n, room // (8 * k)) if k else n
    return 1, cols, rows, _quant_slice_bytes(n, k, cols, rows)


def gossip_mix_quant(idx, val, scale, q):
    """Fused int8 dequantize -> padded-CSR mix: idx [W, K] int32; val
    [W, K] f32; scale [W] f32; q [W, F] int8.
    out[i] = sum_k val[i, k] * scale[idx[i, k]] * q[idx[i, k]].

    On the card the branch follows from the shapes alone
    (``gossip_mix_quant_plan``): column slices of q in shared memory, or
    the per-row gather at W too large for one slice; one launch and one
    count under ``gossip_mix_quant`` each."""
    n, f = q.shape
    k = idx.shape[1]
    _check("idx", idx, (torch.int32,), (n, k))
    _check("val", val, (torch.float32,), (n, k))
    _check("scale", scale, (torch.float32,), (n,))
    _check("q", q, (torch.int8,), (n, f))
    with _cost("gossip_mix_quant", n * f, w=n, k=k, f=f, in_bytes=1):
        if not _on_meta(idx, val, scale, q) and \
                not _on_card(idx, val, scale, q):
            return ref.gossip_mix_quant_ref(idx, val, scale, q)
        return _gossip_mix_quant_launch(idx, val, scale, q)


def _gossip_mix_quant_launch(idx, val, scale, q):
    n, f = q.shape
    k = idx.shape[1]
    branch, cols, rows, smem = gossip_mix_quant_plan(n, k, f)
    grid = -(-f // cols) if branch == 1 else n * -(-f // 4096)
    if grid > GOSSIP_GRID_MAX or n * k > GOSSIP_GRID_MAX:
        raise ValueError(f"gossip_mix_quant: W = {n}, K = {k}, F = {f} "
                         f"needs {grid} CTAs and {n * k} slots; both must "
                         f"stay below 2**31")
    out = torch.empty((n, f), dtype=torch.float32, device=q.device)
    if out.numel() == 0 or out.is_meta:
        return out
    ptr = q.data_ptr()
    align = 16 if f % 16 == 0 and ptr % 16 == 0 else \
        4 if branch == 1 and f % 4 == 0 and ptr % 4 == 0 else 1
    _launch("gossip_mix_quant", out, idx.data_ptr(), val.data_ptr(),
            scale.data_ptr(), ptr, out.data_ptr(), n, k, f, branch, cols,
            rows, align, smem)
    return _count_regime("gossip_mix_quant/" +
                         ("slices" if branch == 1 else "gather"), out)


# the SIMT kernel takes any head dim up to this whose rows are whole
# 4-byte words (it instantiates 32, 64, 96, 112 and 128 and masks the
# columns past D); the tensor-core kernel takes D in FLASH_TC_HEAD_DIMS
FLASH_MAX_HEAD_DIM = 128
FLASH_TC_HEAD_DIMS = (64, 128)
FLASH_TC_TILE = 128           # query rows per CTA of the tensor-core kernel
FLASH_SIMT_TILE = 64          # query rows per CTA of the SIMT kernel
# where its CTAs fill fewer than half the GOSSIP_SMS SMs it splits each
# query tile's key range over CTAs, as many as bring them to two an SM,
# each split at least FLASH_SPLIT_KEYS keys of Sk, at most
# FLASH_MAX_SPLITS. Set from device us per call, split / unsplit
# (benchmarks/flash_simt_probe.py; NVIDIA H100 80GB HBM3, 700 W), f32
# causal: [1, 4, 512, 64] (32 CTAs, 8 splits) 15.56 / 43.49; [2, 4, 128,
# 128] (16 CTAs, 2 splits) 16.59 / 20.79; [4, 12, 128, 64] (96 CTAs, 2
# splits) 16.76 / 13.22, where the merge pass costs more than it saves.
FLASH_SPLIT_KEYS = 64
FLASH_MAX_SPLITS = 16
ROUTER_MAX_EXPERTS, ROUTER_MAX_K = 512, 32


def _used_strides(t):
    """(dim, stride) of every dim above size 1 (a size-1 dim's stride is
    never used)."""
    return [(i, t.stride(i)) for i in range(t.dim()) if t.shape[i] > 1]


def flash_kernel(dtype, d: int) -> str:
    """The kernel ``flash_attention`` launches on the card for this dtype
    and head dim: ``flash_attention_tc`` for bf16 at D in
    ``FLASH_TC_HEAD_DIMS``, else the SIMT ``flash_attention``."""
    return "flash_attention_tc" if dtype == torch.bfloat16 \
        and d in FLASH_TC_HEAD_DIMS else "flash_attention"


def flash_simt_splits(b: int, h: int, sq: int, sk: int) -> int:
    """Key-range splits of the SIMT kernel's grid at q [B, H, Sq, D] over k,
    v [B, H, Sk, D]: 1 where its B*H*ceil(Sq/64) CTAs fill half the card's
    ``GOSSIP_SMS`` SMs or more, else as many as bring them to two an SM,
    at most ``FLASH_MAX_SPLITS`` and each at least ``FLASH_SPLIT_KEYS``
    keys of Sk (a causal query tile sees fewer; its parts shrink with it,
    and a part with no key tile only writes m = -inf)."""
    ctas = b * h * -(-sq // FLASH_SIMT_TILE)
    if ctas == 0 or 2 * ctas >= GOSSIP_SMS:
        return 1
    return max(1, min(-(-2 * GOSSIP_SMS // ctas), sk // FLASH_SPLIT_KEYS,
                      FLASH_MAX_SPLITS))


def flash_simt_scratch(b: int, h: int, sq: int, d: int, splits: int) -> int:
    """fp32 words of the split scratch: each split's unnormalised output
    rows [B*H*Sq, D] and their (m, l); 0 without a split."""
    return 0 if splits == 1 else splits * b * h * sq * (d + 2)


def _plain_grads(fn, inputs, grad_out):
    """The gradient of the plain version ``fn`` at ``inputs`` (recomputed
    from detached copies) against ``grad_out``, one per input."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in inputs]
        out = fn(*leaves)
    return torch.autograd.grad(out, leaves, grad_out)


class _FlashAttention(torch.autograd.Function):
    """The flash kernel under autograd: the forward launches the kernel
    (``_flash_forward``); the backward recomputes the plain version
    (``ref.flash_attention_ref``, k and v of their own length) from the
    saved q, k, v and takes its gradient. No backward kernel exists (the
    JAX package has none)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return _flash_forward(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, grad_out):
        fn = lambda q, k, v: ref.flash_attention_ref(
            q, k, v, causal=ctx.causal, window=ctx.window)
        return (*_plain_grads(fn, ctx.saved_tensors, grad_out), None, None)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Attention with scale 1/sqrt(D): q [B, H, Sq, D] over k, v [B, H, Sk,
    D] of one dtype (f32 or bf16). ``causal`` hides keys after the query,
    ``window > 0`` keys at or before ``q - window``; both need Sk = Sq
    (the reference's masks are all self-attention), and a call that asks
    for either with Sk != Sq raises ``ValueError``. k and v must share
    their strides; q has its own; D is contiguous in all three (a [B, S,
    H, D] tensor's ``transpose(1, 2)`` is taken as it is). The output has
    q's dtype and q's layout (``empty_like``) on every device.

    On the card the kernel follows from dtype and head dim alone
    (``flash_kernel``), never from a failure: bf16 at D in
    ``FLASH_TC_HEAD_DIMS`` launches the tensor-core kernel
    ``flash_attention_tc`` (TMA loads, wgmma; p enters P.V rounded to
    bf16, held to ``ref.flash_tc_limit``), which needs 16-byte aligned
    bases and (b, h, s) strides of whole 16 bytes; every other call
    launches the kernel ``flash_attention`` ("SIMT" by its first design;
    now mma.sync on the tensor cores: 3xTF32 products for f32, bf16
    products with p in two bf16 parts for bf16, both within the one-ulp
    limit of ``chip_smoke.flash_err``), which takes D up to
    ``FLASH_MAX_HEAD_DIM`` whose rows are whole 4-byte words (any D in
    f32, an even D in bf16) and raises on the rest. Where its grid would
    not fill the card it splits each query tile's key range over
    ``flash_simt_splits`` CTAs into fp32 scratch and merges the parts in
    a second kernel of the same launch. Every f32 caller, the reduced f32
    models included, runs it. The head dim is checked on the card only:
    on the CPU the plain version takes any D.

    Under autograd (an input that needs a gradient) the call goes through
    ``_FlashAttention``: the same forward, the gradient of the plain
    version recomputed from q, k and v."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, window)
    return _flash_forward(q, k, v, causal, window)


def _flash_forward(q, k, v, causal: bool, window: int):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name}: expected [B, H, S, D], got "
                             f"{tuple(t.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention: dtype {q.dtype} not in "
                        f"[torch.float32, torch.bfloat16]")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, expected {q.dtype}")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if (k.shape[0], k.shape[1], k.shape[3]) != (b, h, d):
        raise ValueError(f"k: shape {tuple(k.shape)}, expected [{b}, {h}, "
                         f"Sk, {d}]")
    if v.shape != k.shape:
        raise ValueError(f"v: shape {tuple(v.shape)}, expected k's "
                         f"{tuple(k.shape)}")
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    if sk != sq and (causal or window > 0):
        raise ValueError(f"flash_attention: Sq = {sq} != Sk = {sk} takes "
                         f"no causal or window mask (causal={causal}, "
                         f"window={window})")
    if q.stride(-1) != 1 or k.stride(-1) != 1 \
            or _used_strides(v) != _used_strides(k):
        raise ValueError("flash_attention: k and v must share their "
                         "strides, with the head dim contiguous in q, k "
                         "and v")
    name = flash_kernel(q.dtype, d)
    with _cost(name, q.numel(), b=b, h=h, s=sq, d=d,
               itemsize=q.element_size(), causal=causal, sk=sk,
               window=window):
        if not _on_meta(q, k, v) and not _on_card(q, k, v):
            return _into(q, ref.flash_attention_ref(q, k, v, causal=causal,
                                                    window=window))
        if name == "flash_attention_tc":
            return _flash_attention_tc(q, k, v, causal, window)
        return _flash_attention_simt(q, k, v, causal, window)


def _flash_attention_simt(q, k, v, causal, window):
    """The SIMT kernel's card-side branch of ``flash_attention`` (inputs
    already checked but for what this kernel takes)."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    size = q.element_size()
    if not 0 < d <= FLASH_MAX_HEAD_DIM or d * size % 4:
        raise ValueError(f"flash_attention: head dim {d}: the SIMT kernel "
                         f"takes D up to {FLASH_MAX_HEAD_DIM} whose rows are "
                         f"whole 4-byte words")
    if b * h > 65535:
        raise ValueError(f"flash_attention: B*H = {b * h} > 65535")
    # the kernel copies rows of D elements in 4-byte words
    if any(t.data_ptr() % 16 for t in (q, k, v)) or any(
            st * size % 4 for t in (q, k) for i, st in _used_strides(t)
            if i < 3):
        raise ValueError("flash_attention: q, k, v must be 16-byte aligned "
                         "with rows on 4-byte boundaries")
    out = torch.empty_like(q)
    # the split scratch, on the meta device too (the dry run's peak)
    splits = flash_simt_splits(b, h, sq, sk)
    part = torch.empty(flash_simt_scratch(b, h, sq, d, splits),
                       dtype=torch.float32, device=q.device) \
        if splits > 1 else None
    if out.numel() == 0 or out.is_meta:
        return out
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h,
            h, sq, sk, d, *q.stride()[:3], *k.stride()[:3],
            *out.stride()[:3], int(causal), int(window),
            _DTYPE_CODE[q.dtype])
    if part is None:
        return _launch("flash_attention", out, *args)
    # the C entry's split variant (build.VARIANTS): scratch, split count
    return _launch("flash_attention", out, *args, part.data_ptr(), splits)


def _tma_strides(t):
    """(b, h, s) element strides of a [B, H, S, D] tensor for its tensor
    map. A size-1 dim's stride is never used, so it gets D, which any
    tensor map takes."""
    return tuple(t.stride(i) if t.shape[i] > 1 else t.shape[3]
                 for i in range(3))


def _flash_attention_tc(q, k, v, causal, window):
    """The tensor-core kernel's card-side branch of ``flash_attention``
    (bf16, D in ``FLASH_TC_HEAD_DIMS``, inputs already checked): q's tensor
    map from Sq and q's strides, k's and v's from Sk and theirs."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    q_strides, kv_strides = _tma_strides(q), _tma_strides(k)
    if any(t.data_ptr() % 16 for t in (q, k, v)) or any(
            st % 8 or st * 2 >= 2 ** 40 for st in q_strides + kv_strides):
        raise ValueError("flash_attention: bf16 q, k, v go through TMA, "
                         "which needs 16-byte aligned bases and (b, h, s) "
                         "strides of whole 16 bytes")
    if b * h * -(-sq // FLASH_TC_TILE) >= 2 ** 31:
        raise ValueError(f"flash_attention: B*H*ceil(Sq/{FLASH_TC_TILE}) "
                         f"must stay below 2**31")
    out = torch.empty_like(q)
    if out.numel() == 0 or out.is_meta:
        return out
    return _launch("flash_attention_tc", out, q.data_ptr(), k.data_ptr(),
                   v.data_ptr(), out.data_ptr(), b, h, sq, sk, d,
                   *q_strides, *kv_strides, *out.stride()[:3], int(causal),
                   int(window))


def _check_router(name, logits, k):
    """The router kernels' limits on logits [T, E] and k; returns (T, E)."""
    if logits.dim() != 2:
        raise ValueError(f"logits: expected [T, E], got "
                         f"{tuple(logits.shape)}")
    t, e = logits.shape
    _check("logits", logits, (torch.float32, torch.bfloat16), (t, e))
    if e > ROUTER_MAX_EXPERTS or not 1 <= k <= min(e, ROUTER_MAX_K):
        raise ValueError(f"{name}: E = {e}, k = {k}; need E <= "
                         f"{ROUTER_MAX_EXPERTS} and 1 <= k <= "
                         f"min(E, {ROUTER_MAX_K})")
    return t, e


def moe_router_topk(logits, k: int):
    """Fused softmax + top-k routing: logits [T, E] f32 or bf16 ->
    (gates [T, k] f32, idx [T, k] int32). The k largest softmax
    probabilities in descending order, the lower expert index first on a
    tie, renormalized by their sum + 1e-9. E <= 512, 1 <= k <= min(E,
    32).

    Under autograd (logits that need a gradient) the call goes through
    ``_MoeRouterTopk`` on every device: the same forward, the gates'
    gradient at the kernel's picks."""
    _check_router("moe_router_topk", logits, k)
    if torch.is_grad_enabled() and logits.requires_grad:
        return _MoeRouterTopk.apply(logits, k)
    return _router_forward(logits, k)


def _router_forward(logits, k: int):
    """The router kernel's launch (inputs already checked); the plain
    version on the CPU, empty outputs on meta."""
    t, e = logits.shape
    with _cost("moe_router", t, t=t, e=e, k=k,
               itemsize=logits.element_size()):
        meta = _on_meta(logits)
        if not meta and not _on_card(logits):
            gates, idx = ref.moe_router_topk_ref(logits, k)
            return gates.contiguous(), idx.contiguous()
        gates = torch.empty((t, k), dtype=torch.float32,
                            device=logits.device)
        idx = torch.empty((t, k), dtype=torch.int32, device=logits.device)
        if t == 0 or meta:
            return gates, idx
        _launch("moe_router", gates, logits.data_ptr(), gates.data_ptr(),
                idx.data_ptr(), t, e, k, _DTYPE_CODE[logits.dtype])
        return gates, idx


ROUTE_TILE = 32           # rows per CTA of moe_route_slots
# device -> (state int32 [4]: the 64-bit epoch | ticket word and the count
# of finished CTAs, used once in 2**30 calls; look-back words int64)
_ROUTE_SCRATCH: dict = {}
_ROUTE_RETIRED: list = []


def _route_scratch(device, words: int):
    """moe_route_slots' persistent scratch on ``device``, with room for at
    least ``words`` look-back words. Zeroed once when made and never
    between calls: the kernel tells this call's words from stale ones by
    an epoch that it advances itself. It grows to the next power of two
    (at least 2**15 words); an outgrown buffer is kept, since a captured
    CUDA graph may still point at it."""
    have = _ROUTE_SCRATCH.get(device)
    if have is not None and have[1].numel() >= words:
        return have
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("moe_route_slots: its scratch cannot grow during "
                           "CUDA graph capture; call it once at this size "
                           "before capturing")
    if have is not None:
        _ROUTE_RETIRED.append(have)
    have = (torch.zeros(4, dtype=torch.int32, device=device),
            torch.zeros(1 << max(15, (words - 1).bit_length()),
                        dtype=torch.int64, device=device))
    _ROUTE_SCRATCH[device] = have
    return have


def moe_route_slots(logits, k: int, cap: int):
    """``moe_router_topk`` fused with the grouped dispatch's slot
    assignment: logits [T, E] f32 or bf16 -> (gates [T, k] f32 and idx
    [T, k] int32, as ``moe_router_topk`` gives them; slot [T, k] int32,
    the pair's rank among all pairs routed to its expert, in flattened
    order t*k + j, where that rank is below ``cap``, else ``cap``; src
    [E*cap] int32, the token in slot s of expert e at e*cap + s, or T where
    that slot stays empty). The limits of ``moe_router_topk``; cap >= 1.

    On the card one launch computes all four, with no host
    synchronisation, so a CUDA graph may capture it. The kernel keeps a
    persistent scratch per device (``_route_scratch``): calls on one
    device must not overlap in time, and a call at the largest T must
    run once before a graph captures one. Under autograd (logits that need
    a gradient) the call goes through ``_MoeRouteSlots`` on every device:
    the same forward, the gates' gradient at the kernel's picks; idx, slot
    and src take none."""
    t, e = _check_router("moe_route_slots", logits, k)
    if cap < 1 or e * cap >= 2 ** 31 or t * k >= 2 ** 31:
        raise ValueError(f"moe_route_slots: cap = {cap}, T*k = {t * k}; "
                         f"need cap >= 1 and E*cap, T*k below 2**31")
    if torch.is_grad_enabled() and logits.requires_grad:
        return _MoeRouteSlots.apply(logits, k, cap)
    return _route_slots_forward(logits, k, cap)


def _route_slots_forward(logits, k: int, cap: int):
    """The route-and-slot kernel's launch (inputs already checked); the
    plain version on the CPU, empty outputs on meta."""
    t, e = logits.shape
    dev = logits.device
    with _cost("moe_route_slots", t, t=t, e=e, k=k, cap=cap,
               itemsize=logits.element_size()):
        meta = _on_meta(logits)
        if not meta and not _on_card(logits):
            return tuple(o.contiguous()
                         for o in ref.moe_route_slots_ref(logits, k, cap))
        gates = torch.empty((t, k), dtype=torch.float32, device=dev)
        idx = torch.empty((t, k), dtype=torch.int32, device=dev)
        slot = torch.empty((t, k), dtype=torch.int32, device=dev)
        if t == 0:                             # every slot empty: src = T
            return gates, idx, slot, torch.zeros(e * cap, dtype=torch.int32,
                                                  device=dev)
        src = torch.empty(e * cap, dtype=torch.int32, device=dev)
        if meta:
            return gates, idx, slot, src
        state, words = _route_scratch(dev, -(-t // ROUTE_TILE) * e)
        _launch("moe_route_slots", gates, logits.data_ptr(), gates.data_ptr(),
                idx.data_ptr(), slot.data_ptr(), src.data_ptr(),
                words.data_ptr(), state.data_ptr(), t, e, k, cap,
                words.numel(), _DTYPE_CODE[logits.dtype])
        return gates, idx, slot, src


SSD_STATE_DIMS = (16, 32, 64, 128)
SSD_HEAD_DIMS = (16, 32, 64)
SSD_MAX_CHUNK = 256


def ssd_kernel(n: int, p: int) -> str:
    """The kernel ``ssd_chunk`` launches on the card for state dim ``n``
    and head dim ``p``: ``ssd_chunk_tc`` (tensor cores, 3xTF32) at every
    N in ``SSD_STATE_DIMS`` and P in ``SSD_HEAD_DIMS``."""
    if n not in SSD_STATE_DIMS or p not in SSD_HEAD_DIMS:
        raise ValueError(f"ssd_kernel: N = {n}, P = {p}; need N in "
                         f"{SSD_STATE_DIMS} and P in {SSD_HEAD_DIMS}")
    return "ssd_chunk_tc"


def ssd_chunk(C, B, acum, dt, x):
    """Mamba2 SSD intra-chunk term (``ref.ssd_chunk_ref``): C, B [G, T, N]
    and acum, dt [G, H, T], contiguous; x [G, H, T, P] with P contiguous
    (the model's [G, T, H, P] chunk view is taken as it is); all fp32, N in
    ``SSD_STATE_DIMS``, P in ``SSD_HEAD_DIMS``, 1 <= T <= 256. Returns y
    [G, H, T, P] fp32 in x's layout (``empty_like``).

    On the card it launches ``ssd_chunk_tc`` (mma.sync TF32 in three
    products per product, so fp32-accurate, cp.async loads), held to
    1e-5 * max|y|. Under autograd (an input that needs a gradient) the call
    goes through ``_SsdChunk`` on every device: the same forward, the
    gradient of the plain version recomputed for all five inputs."""
    if x.dim() != 4:
        raise ValueError(f"x: expected [G, H, T, P], got {tuple(x.shape)}")
    g, h, t, p = x.shape
    n = C.shape[-1]
    _check("C", C, (torch.float32,), (g, t, n))
    _check("B", B, (torch.float32,), (g, t, n))
    _check("acum", acum, (torch.float32,), (g, h, t))
    _check("dt", dt, (torch.float32,), (g, h, t))
    if x.dtype != torch.float32:
        raise TypeError(f"ssd_chunk: x dtype {x.dtype}, expected "
                        f"torch.float32")
    if n not in SSD_STATE_DIMS or p not in SSD_HEAD_DIMS:
        raise ValueError(f"ssd_chunk: N = {n}, P = {p}; need N in "
                         f"{SSD_STATE_DIMS} and P in {SSD_HEAD_DIMS}")
    if not 1 <= t <= SSD_MAX_CHUNK:
        raise ValueError(f"ssd_chunk: chunk length T = {t} not in "
                         f"[1, {SSD_MAX_CHUNK}]")
    if x.stride(-1) != 1:
        raise ValueError("ssd_chunk: x must have its head dim contiguous")
    args = (C, B, acum, dt, x)
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        return _SsdChunk.apply(*args)
    return _ssd_forward(*args)


def _ssd_forward(C, B, acum, dt, x):
    """``ssd_chunk`` past its checks: the plain version on the CPU, an
    empty output on meta, the kernel on the card."""
    g, h, t, p = x.shape
    n = C.shape[-1]
    with _cost(ssd_kernel(n, p), x.numel(), g=g, h=h, t=t, n=n, p=p):
        if not _on_meta(C, B, acum, dt, x) and \
                not _on_card(C, B, acum, dt, x):
            return _into(x, ref.ssd_chunk_ref(C, B, acum, dt, x))
        return _ssd_launch(C, B, acum, dt, x)


def _ssd_launch(C, B, acum, dt, x):
    """The SSD kernel's card-side branch of ``ssd_chunk`` (inputs already
    checked but for what the kernel takes)."""
    g, h, t, p = x.shape
    n = C.shape[-1]
    if g > 65535:
        raise ValueError(f"ssd_chunk: G = {g} > 65535")
    # C, B and x rows are copied 16 bytes at a time
    if any(a.data_ptr() % 16 for a in (C, B, x)) or any(
            st % 4 for _, st in _used_strides(x)[:-1]):
        raise ValueError("ssd_chunk: C, B, x must be 16-byte aligned with "
                         "x's rows on 16-byte boundaries")
    y = torch.empty_like(x)
    if y.numel() == 0 or y.is_meta:
        return y
    return _launch(ssd_kernel(n, p), y, C.data_ptr(), B.data_ptr(),
                   acum.data_ptr(), dt.data_ptr(), x.data_ptr(),
                   y.data_ptr(), g, h, t, n, p, *x.stride()[:3],
                   *y.stride()[:3])


def _gates_grad(ctx, grad_gates):
    """The router kernels' backward: the gradient of the gates at the
    saved picks (``ref.router_gates_at``) with respect to the saved
    logits."""
    logits, idx = ctx.saved_tensors
    g, = _plain_grads(lambda lg: ref.router_gates_at(lg, idx), (logits,),
                      grad_gates)
    return g


class _MoeRouterTopk(torch.autograd.Function):
    """The router kernel under autograd: the forward launches it
    (``_router_forward``); the backward differentiates the gates at the
    kernel's own picks (``ref.router_gates_at``: the softmax gathered at
    idx, renormalised), never by picking again, so a tie or a near-tie
    cannot move the gradient to other experts. idx takes no gradient."""

    @staticmethod
    def forward(ctx, logits, k):
        gates, idx = _router_forward(logits, k)
        ctx.save_for_backward(logits, idx)
        ctx.mark_non_differentiable(idx)
        return gates, idx

    @staticmethod
    def backward(ctx, grad_gates, _):
        return _gates_grad(ctx, grad_gates), None


class _MoeRouteSlots(torch.autograd.Function):
    """The route-and-slot kernel under autograd: the forward launches it
    (``_route_slots_forward``); the backward is ``_MoeRouterTopk``'s, at
    the kernel's own picks. idx, slot and src take no gradient."""

    @staticmethod
    def forward(ctx, logits, k, cap):
        gates, idx, slot, src = _route_slots_forward(logits, k, cap)
        ctx.save_for_backward(logits, idx)
        ctx.mark_non_differentiable(idx, slot, src)
        return gates, idx, slot, src

    @staticmethod
    def backward(ctx, grad_gates, *_):
        return _gates_grad(ctx, grad_gates), None, None


class _SsdChunk(torch.autograd.Function):
    """The SSD kernel under autograd: the forward launches it
    (``_ssd_forward``); the backward recomputes the plain version
    (``ref.ssd_chunk_ref``) from the saved C, B, acum, dt, x and returns
    its gradient for all five (in Mamba2 acum and dt come from dt and A, so
    all five carry one). No backward kernel exists (the JAX package has
    none)."""

    @staticmethod
    def forward(ctx, C, B, acum, dt, x):
        ctx.save_for_backward(C, B, acum, dt, x)
        return _ssd_forward(C, B, acum, dt, x)

    @staticmethod
    def backward(ctx, grad_y):
        return _plain_grads(ref.ssd_chunk_ref, ctx.saved_tensors, grad_y)
