"""Wrappers of the port's kernels: the three gossip mixes, flash attention
(a tensor-core kernel for bf16 at D in {64, 128}, a SIMT kernel for the
rest), the MoE router (alone, and fused with the grouped dispatch's slot
assignment) and the Mamba2 SSD intra-chunk term (a tensor-core kernel in
3xTF32 for P in {32, 64}, a SIMT kernel for P = 16).

Each wrapper checks device, dtype, shape and layout, then runs the plain
PyTorch version (``ref``) when the tensors lie on the CPU and the CUDA
kernel (``csrc/``, built by ``build``) when they lie on the card. On the
card it launches the kernel or raises; it never falls back. Every output
is a fresh tensor. ``LAUNCHES[name]`` counts kernel launches (never
plain-version calls), so a run can show that it went through the kernels.

The padded-CSR ``idx`` must lie in [0, W) (``core.gossip.sparse_weights``
builds it so). It is not checked on the card, where a check would cost a
device synchronize per call.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

LAUNCHES = {name: 0 for name in build.KERNELS}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(name, t, dtypes, shape):
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in "
                        f"{[str(d) for d in dtypes]}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


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
    fn = build.load(name)
    with torch.cuda.device(out.device):
        rc = fn(*args, torch.cuda.current_stream(out.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {rc})")
    LAUNCHES[name] += 1
    return out


def gossip_mix(P, w):
    """Dense mix ``P @ w``: P [W, W] f32; w [W, F] f32, bf16 or int8."""
    n, f = w.shape
    _check("P", P, (torch.float32,), (n, n))
    _check("w", w, tuple(_DTYPE_CODE), (n, f))
    if not _on_card(P, w):
        return ref.gossip_mix_ref(P, w)
    out = torch.empty((n, f), dtype=torch.float32, device=w.device)
    if out.numel() == 0:
        return out
    return _launch("gossip_mix", out, P.data_ptr(), w.data_ptr(),
                   out.data_ptr(), n, f, _DTYPE_CODE[w.dtype])


def gossip_mix_sparse(idx, val, w):
    """Padded-CSR mix: idx [W, K] int32; val [W, K] f32 (0 on pad slots);
    w [W, F] f32 or bf16. out[i] = sum_k val[i, k] * w[idx[i, k]]."""
    n, f = w.shape
    k = idx.shape[1]
    _check("idx", idx, (torch.int32,), (n, k))
    _check("val", val, (torch.float32,), (n, k))
    _check("w", w, (torch.float32, torch.bfloat16), (n, f))
    if not _on_card(idx, val, w):
        return ref.gossip_mix_sparse_ref(idx, val, w)
    out = torch.empty((n, f), dtype=torch.float32, device=w.device)
    if out.numel() == 0:
        return out
    return _launch("gossip_mix_sparse", out, idx.data_ptr(), val.data_ptr(),
                   w.data_ptr(), out.data_ptr(), n, k, f,
                   _DTYPE_CODE[w.dtype])


def gossip_mix_quant(idx, val, scale, q):
    """Fused int8 dequantize -> padded-CSR mix: idx [W, K] int32; val
    [W, K] f32; scale [W] f32; q [W, F] int8.
    out[i] = sum_k val[i, k] * scale[idx[i, k]] * q[idx[i, k]]."""
    n, f = q.shape
    k = idx.shape[1]
    _check("idx", idx, (torch.int32,), (n, k))
    _check("val", val, (torch.float32,), (n, k))
    _check("scale", scale, (torch.float32,), (n,))
    _check("q", q, (torch.int8,), (n, f))
    if not _on_card(idx, val, scale, q):
        return ref.gossip_mix_quant_ref(idx, val, scale, q)
    out = torch.empty((n, f), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    return _launch("gossip_mix_quant", out, idx.data_ptr(), val.data_ptr(),
                   scale.data_ptr(), q.data_ptr(), out.data_ptr(), n, k, f)


FLASH_HEAD_DIMS = (32, 64, 128)
FLASH_TC_HEAD_DIMS = (64, 128)
FLASH_TC_TILE = 128           # query rows per CTA of the tensor-core kernel
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


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Attention with scale 1/sqrt(D) over q, k, v [B, H, S, D] of one
    shape and dtype (f32 or bf16), D in ``FLASH_HEAD_DIMS``. ``causal``
    hides keys after the query, ``window > 0`` keys at or before
    ``q - window``. On the card q, k and v must share their strides, with
    D contiguous (a [B, S, H, D] tensor's ``transpose(1, 2)`` is taken as
    it is); the output has q's dtype and q's layout (``empty_like``).

    On the card the kernel follows from dtype and head dim alone
    (``flash_kernel``), never from a failure: bf16 at D in
    ``FLASH_TC_HEAD_DIMS`` launches the tensor-core kernel
    ``flash_attention_tc`` (TMA loads, wgmma; p enters P.V rounded to
    bf16, held to ``ref.flash_tc_limit``), which needs 16-byte aligned
    bases and (b, h, s) strides of whole 16 bytes; f32 at any D and bf16
    at D = 32 launch the SIMT kernel ``flash_attention`` (fp32
    throughout), so every f32 caller, the reduced f32 models included,
    runs it."""
    if q.dim() != 4:
        raise ValueError(f"q: expected [B, H, S, D], got {tuple(q.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention: dtype {q.dtype} not in "
                        f"[torch.float32, torch.bfloat16]")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, expected {q.dtype}")
        if t.shape != q.shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{tuple(q.shape)}")
    b, h, s, d = q.shape
    if d not in FLASH_HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in "
                         f"{FLASH_HEAD_DIMS}")
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    if q.stride(-1) != 1 or _used_strides(k) != _used_strides(q) \
            or _used_strides(v) != _used_strides(q):
        raise ValueError("flash_attention: q, k and v must share their "
                         "strides, with the head dim contiguous")
    if not _on_card(q, k, v):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    if flash_kernel(q.dtype, d) == "flash_attention_tc":
        return _flash_attention_tc(q, k, v, causal, window)
    if b * h > 65535:
        raise ValueError(f"flash_attention: B*H = {b * h} > 65535")
    # the kernel copies rows of D elements in 4-byte words
    if any(t.data_ptr() % 16 for t in (q, k, v)) or any(
            st * q.element_size() % 4 for i, st in _used_strides(q) if i < 3):
        raise ValueError("flash_attention: q, k, v must be 16-byte aligned "
                         "with rows on 4-byte boundaries")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    return _launch("flash_attention", out, q.data_ptr(), k.data_ptr(),
                   v.data_ptr(), out.data_ptr(), b * h, h, s, d,
                   *q.stride()[:3], *out.stride()[:3], int(causal),
                   int(window), _DTYPE_CODE[q.dtype])


def _tma_strides(t):
    """(b, h, s) element strides of a [B, H, S, D] tensor for its tensor
    map. A size-1 dim's stride is never used, so it gets D, which any
    tensor map takes."""
    return tuple(t.stride(i) if t.shape[i] > 1 else t.shape[3]
                 for i in range(3))


def _flash_attention_tc(q, k, v, causal, window):
    """The tensor-core kernel's card-side branch of ``flash_attention``
    (bf16, D in ``FLASH_TC_HEAD_DIMS``, inputs already checked)."""
    b, h, s, d = q.shape
    strides = _tma_strides(q)
    if any(t.data_ptr() % 16 for t in (q, k, v)) or any(
            st % 8 or st * 2 >= 2 ** 40 for st in strides):
        raise ValueError("flash_attention: bf16 q, k, v go through TMA, "
                         "which needs 16-byte aligned bases and (b, h, s) "
                         "strides of whole 16 bytes")
    if b * h * -(-s // FLASH_TC_TILE) >= 2 ** 31:
        raise ValueError(f"flash_attention: B*H*ceil(S/{FLASH_TC_TILE}) "
                         f"must stay below 2**31")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    return _launch("flash_attention_tc", out, q.data_ptr(), k.data_ptr(),
                   v.data_ptr(), out.data_ptr(), b, h, s, d, *strides,
                   *out.stride()[:3], int(causal), int(window))


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
    32)."""
    t, e = _check_router("moe_router_topk", logits, k)
    if not _on_card(logits):
        return ref.moe_router_topk_ref(logits, k)
    gates = torch.empty((t, k), dtype=torch.float32, device=logits.device)
    idx = torch.empty((t, k), dtype=torch.int32, device=logits.device)
    if t == 0:
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
    run once before a graph captures one."""
    t, e = _check_router("moe_route_slots", logits, k)
    if cap < 1 or e * cap >= 2 ** 31 or t * k >= 2 ** 31:
        raise ValueError(f"moe_route_slots: cap = {cap}, T*k = {t * k}; "
                         f"need cap >= 1 and E*cap, T*k below 2**31")
    if not _on_card(logits):
        return ref.moe_route_slots_ref(logits, k, cap)
    dev = logits.device
    gates = torch.empty((t, k), dtype=torch.float32, device=dev)
    idx = torch.empty((t, k), dtype=torch.int32, device=dev)
    slot = torch.empty((t, k), dtype=torch.int32, device=dev)
    if t == 0:                                 # every slot empty: src = T
        return gates, idx, slot, torch.zeros(e * cap, dtype=torch.int32,
                                              device=dev)
    src = torch.empty(e * cap, dtype=torch.int32, device=dev)
    state, words = _route_scratch(dev, -(-t // ROUTE_TILE) * e)
    _launch("moe_route_slots", gates, logits.data_ptr(), gates.data_ptr(),
            idx.data_ptr(), slot.data_ptr(), src.data_ptr(),
            words.data_ptr(), state.data_ptr(), t, e, k, cap, words.numel(),
            _DTYPE_CODE[logits.dtype])
    return gates, idx, slot, src


SSD_STATE_DIMS = (16, 32, 64, 128)
SSD_HEAD_DIMS = (16, 32, 64)
SSD_TC_HEAD_DIMS = (32, 64)
SSD_MAX_CHUNK = 256


def ssd_kernel(n: int, p: int) -> str:
    """The kernel ``ssd_chunk`` launches on the card for state dim ``n``
    and head dim ``p``: ``ssd_chunk_tc`` (tensor cores, 3xTF32) for P in
    ``SSD_TC_HEAD_DIMS``, else the SIMT ``ssd_chunk``."""
    return "ssd_chunk_tc" if n in SSD_STATE_DIMS \
        and p in SSD_TC_HEAD_DIMS else "ssd_chunk"


def ssd_chunk(C, B, acum, dt, x):
    """Mamba2 SSD intra-chunk term (``ref.ssd_chunk_ref``): C, B [G, T, N]
    and acum, dt [G, H, T], contiguous; x [G, H, T, P] with P contiguous
    (the model's [G, T, H, P] chunk view is taken as it is); all fp32, N in
    ``SSD_STATE_DIMS``, P in ``SSD_HEAD_DIMS``, 1 <= T <= 256. Returns y
    [G, H, T, P] fp32 in x's layout (``empty_like``).

    On the card the kernel follows from N and P alone (``ssd_kernel``),
    never from a failure: P in ``SSD_TC_HEAD_DIMS`` launches
    ``ssd_chunk_tc`` (mma.sync TF32 in three products per product, so
    fp32-accurate, cp.async loads), P = 16 the SIMT ``ssd_chunk`` (fp32
    FMAs). Both take the same arguments and are held to the same limit,
    1e-5 * max|y|."""
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
    if not _on_card(C, B, acum, dt, x):
        return ref.ssd_chunk_ref(C, B, acum, dt, x)
    if g > 65535:
        raise ValueError(f"ssd_chunk: G = {g} > 65535")
    # C, B and x rows are copied 16 bytes at a time
    if any(a.data_ptr() % 16 for a in (C, B, x)) or any(
            st % 4 for _, st in _used_strides(x)[:-1]):
        raise ValueError("ssd_chunk: C, B, x must be 16-byte aligned with "
                         "x's rows on 16-byte boundaries")
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    return _launch(ssd_kernel(n, p), y, C.data_ptr(), B.data_ptr(),
                   acum.data_ptr(), dt.data_ptr(), x.data_ptr(),
                   y.data_ptr(), g, h, t, n, p, *x.stride()[:3],
                   *y.stride()[:3])
