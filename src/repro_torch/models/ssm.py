"""Mamba2 block via SSD (state-space duality), chunked scan [arXiv:2405.21060]
(the port of ``repro.models.ssm``).

Layout: x [B, S, D] -> in_proj -> z (gate), xBC (conv'd), dt. Heads:
H = d_inner / head_dim; one B/C group (n_groups = 1).

Prefill runs the intra-chunk term (the reference's y_diag) through the
``ssd_chunk`` kernel (``kernels.ops.ssd_chunk``) on chunk views laid out as
[G = batch * chunks, ...]: x is read through a transposed view, without a
copy; C, B, acum and dt are passed contiguous (small copies of [G, T, N]
and [G, H, T]). The chunk-final states, the inter-chunk recurrence (a
Python loop over chunks in place of ``lax.scan``), the inter-chunk output
and the D skip stay plain torch. Decode is the exact O(1) recurrence, plain
torch, and updates the cache in place: ``blocks`` hands every layer views
into stacked buffers.

**Tensor parallelism** (``ssm_block_tp``, ``ssm_decode_step_tp``;
``sharding.TensorParallel``). Model shard j takes its H / tp heads of z, x
and dt, plus B and C whole (each shard computes them: replicated work),
and runs ``ops.ssd_chunk`` on its heads; ``out_proj`` is row-parallel
(partial sums). The gated ``rms_norm(y * silu(z), norm)`` normalises over
all of d_inner: each shard's sum of squares is all-reduced first.

The reference's spec splits the packed ``in_proj`` (z | xBC | dt, axis
"d_inner"), ``conv_w`` and ``conv_b`` in contiguous blocks, which do not
follow heads. The port places the per-head columns each shard computes
with instead (``head_layout``: shard j's z, x and dt columns of its heads,
and the B and C columns held by every shard). A device then holds, per
layer, more than the reference's block by

    in_proj: 2 d_state (1 - 1/tp) d_model elements
    conv_w:  2 d_state (1 - 1/tp) d_conv
    conv_b:  2 d_state (1 - 1/tp)

(Mamba2-780M at tp 4: 2 x 128 x 0.75 x 1,536 = 294,912 bf16 elements,
0.59 MB a layer of ``in_proj``); the decode cache's conv window the same
2 d_state (1 - 1/tp) channels a token of its width.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import Builder, rms_norm, torch_dtype
from repro_torch.sharding import Act


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.d_state
    return d_inner, n_heads, conv_dim


def head_layout(cfg: ModelConfig, which: str, tp: int):
    """The per-head column groups of a mixer leaf at model axis ``tp``:
    ``(groups, shared)``, ``groups[j]`` the indices of shard j's columns
    (its heads' z, x and dt in ``in_proj``; its heads' x in the conv's
    channels), ``shared`` those of B and C, which every shard holds;
    ``which`` is "in_proj" or "conv". None where tp does not divide the
    heads (the leaf is then placed as its spec says)."""
    s = cfg.ssm
    d_inner, n_heads, _ = _dims(cfg)
    if tp <= 1 or n_heads % tp:
        return None
    hl = n_heads // tp
    di = hl * s.head_dim
    n = s.d_state

    def ar(a, b):
        return torch.arange(a, b, dtype=torch.long)
    if which == "in_proj":
        dt0 = 2 * d_inner + 2 * n
        groups = [torch.cat([ar(j * di, (j + 1) * di),
                             ar(d_inner + j * di, d_inner + (j + 1) * di),
                             ar(dt0 + j * hl, dt0 + (j + 1) * hl)])
                  for j in range(tp)]
        return groups, ar(2 * d_inner, 2 * d_inner + 2 * n)
    groups = [ar(j * di, (j + 1) * di) for j in range(tp)]
    return groups, ar(d_inner, d_inner + 2 * n)


def _layout(cfg: ModelConfig, which: str):
    def fn(tp):
        lay = head_layout(cfg, which, tp)
        return (None, None) if lay is None else lay
    return (-1, fn)


def init_ssm(b: Builder, cfg: ModelConfig):
    s = cfg.ssm
    d = cfg.d_model
    d_inner, n_heads, conv_dim = _dims(cfg)
    d_proj = 2 * d_inner + 2 * s.d_state + n_heads   # z, xBC, dt
    b.normal("in_proj", (d, d_proj), ("embed", "d_inner"),
             layout=_layout(cfg, "in_proj"))
    b.normal("conv_w", (s.d_conv, conv_dim), (None, "d_inner"), scale=0.1,
             layout=_layout(cfg, "conv"))
    b.zeros("conv_b", (conv_dim,), ("d_inner",),
            layout=_layout(cfg, "conv"))
    b.const("A_log", torch.log(torch.arange(1, n_heads + 1,
                                            dtype=torch.float32)),
            ("heads",))
    b.zeros("D", (n_heads,), ("heads",))
    b.zeros("dt_bias", (n_heads,), ("heads",))
    b.ones("norm", (d_inner,), ("d_inner",))
    b.normal("out_proj", (d_inner, d), ("d_inner", "embed"))


def _split_proj(cfg, proj):
    s = cfg.ssm
    d_inner, n_heads, _ = _dims(cfg)
    return torch.split(proj, [d_inner, d_inner + 2 * s.d_state, n_heads],
                       dim=-1)


def _softplus(x):
    """``jax.nn.softplus``: log(1 + exp(x)) as logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def ssd_chunk_inputs(x, dt, A, B, C, chunk: int):
    """The arguments of ``ops.ssd_chunk`` for ``ssd_scan``'s inputs, and
    the cumulative decays [b, nc, h, q]. x: [b, S, H, P]; dt: [b, S, H];
    A: [H] (A_log); B, C: [b, S, N]; S a multiple of ``chunk``. C, B
    [G, T, N], acum and dt [G, H, T] contiguous; x the [G, H, T, P] view of
    the [G, T, H, P] chunks (no copy)."""
    b_, s, h, p = x.shape
    n = B.shape[-1]
    nc = s // chunk
    g = b_ * nc
    dtc = dt.reshape(b_, nc, chunk, h).permute(0, 1, 3, 2).contiguous()
    dA = dtc * (-torch.exp(A))[None, None, :, None]       # [b,nc,h,q] (<0)
    acum = torch.cumsum(dA, dim=-1)
    args = (C.reshape(g, chunk, n).contiguous(),
            B.reshape(g, chunk, n).contiguous(),
            acum.reshape(g, h, chunk), dtc.reshape(g, h, chunk),
            x.reshape(g, chunk, h, p).transpose(1, 2))
    return args, acum


def ssd_scan(x, dt, A, B, C, D, chunk: int):
    """Chunked SSD. x: [b,S,H,P]; dt: [b,S,H]; A: [H]; B,C: [b,S,N]; D: [H]
    (all fp32; S a multiple of ``chunk``). Returns y: [b,S,H,P] and the
    final state [b,H,P,N]."""
    b_, s, h, p = x.shape
    n = B.shape[-1]
    nc = s // chunk
    args, acum = ssd_chunk_inputs(x, dt, A, B, C, chunk)
    dtc = args[3].reshape(b_, nc, h, chunk)
    xc = x.reshape(b_, nc, chunk, h, p)
    Cc = C.reshape(b_, nc, chunk, n)

    # 1. intra-chunk (diagonal blocks): the kernel
    y_diag = ops.ssd_chunk(*args).transpose(1, 2).reshape(b_, nc, chunk, h,
                                                          p)

    # 2. chunk-final states: sum_k B[k] decay_to_end[k] dt[k] x[k]
    wgt = torch.exp(acum[..., -1:] - acum) * dtc            # [b,nc,h,k]
    xw = xc * wgt.permute(0, 1, 3, 2)[..., None]            # [b,nc,k,h,p]
    states = torch.matmul(xw.reshape(b_, nc, chunk, h * p).transpose(-1, -2),
                          B.reshape(b_, nc, chunk, n))      # [b,nc,h*p,n]
    states = states.reshape(b_, nc, h, p, n)

    # 3. inter-chunk recurrence (sequential over chunks)
    chunk_decay = torch.exp(acum[..., -1])                  # [b,nc,h]
    state = torch.zeros((b_, h, p, n), dtype=x.dtype, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(state)                                  # emit prev state
        state = state * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                  # [b,nc,h,p,n]

    # 4. inter-chunk output: y_off = C . (decay_in * prev_state)
    y_off = torch.matmul(Cc, prev_states.reshape(b_, nc, h * p, n)
                         .transpose(-1, -2))                # [b,nc,q,h*p]
    y_off = y_off.reshape(b_, nc, chunk, h, p) * \
        torch.exp(acum).permute(0, 1, 3, 2)[..., None]

    y = (y_diag + y_off).reshape(b_, s, h, p)
    y = y + x * D[None, None, :, None]
    return y, state


def _causal_conv(xBC, conv_w, conv_b, conv_state=None):
    """Depthwise causal conv1d. xBC: [B,S,C]; conv_w: [K,C]. With
    conv_state [B,K-1,C] (decode) it is prepended, else zeros are. Returns
    (out [B,S,C], new_state [B,K-1,C])."""
    k = conv_w.shape[0]
    if conv_state is None:
        pad = torch.zeros((xBC.shape[0], k - 1, xBC.shape[2]),
                          dtype=xBC.dtype, device=xBC.device)
    else:
        pad = conv_state
    full = torch.cat([pad, xBC], dim=1)                     # [B,S+K-1,C]
    s = xBC.shape[1]
    out = sum(full[:, i:i + s] * conv_w[i] for i in range(k))
    out = F.silu(out + conv_b)
    new_state = full[:, -(k - 1):] if k > 1 else pad
    return out, new_state


def _mixer(p, cfg: ModelConfig, z, xBC, dt, conv_w, conv_b, heads: int):
    """The mixer of ``heads`` heads between ``in_proj`` and the gated
    norm: the causal conv of xBC (their x, then B and C), softplus(dt +
    dt_bias), the chunked SSD scan and the gate. ``p`` holds those heads'
    dt_bias, A_log and D. Returns y * silu(z) [B, S, heads * P]."""
    s_cfg = cfg.ssm
    di = heads * s_cfg.head_dim
    xBC, _ = _causal_conv(xBC, conv_w, conv_b)
    xs, B, C = torch.split(xBC, [di, s_cfg.d_state, s_cfg.d_state], dim=-1)
    dt = _softplus(dt.float() + p["dt_bias"])
    xs = xs.reshape(*xs.shape[:2], heads, s_cfg.head_dim)
    # pad seq to a chunk multiple (the padded tail never reaches a real
    # token and is sliced away)
    s_len = xs.shape[1]
    chunk = min(s_cfg.chunk_size, s_len)
    pad = (-s_len) % chunk
    if pad:
        xs = F.pad(xs, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    y, _ = ssd_scan(xs.float(), dt, p["A_log"].float(), B.float(),
                    C.float(), p["D"].float(), chunk)
    y = y[:, :s_len].reshape(z.shape[0], s_len, di).to(z.dtype)
    return y * F.silu(z)


def ssm_block(params, cfg: ModelConfig, x):
    """Prefill forward. x: [B,S,D] -> [B,S,D]."""
    _, n_heads, _ = _dims(cfg)
    z, xBC, dt = _split_proj(cfg, x @ params["in_proj"])
    v = _mixer(params, cfg, z, xBC, dt, params["conv_w"], params["conv_b"],
               n_heads)
    return rms_norm(v, params["norm"], cfg.norm_eps) @ params["out_proj"]


# ---------------------------------------------------------------------------
# Decode path (recurrent, O(1) per token)
# ---------------------------------------------------------------------------

def init_ssm_cache(cfg: ModelConfig, batch: int, device):
    s = cfg.ssm
    d_inner, n_heads, conv_dim = _dims(cfg)
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, conv_dim),
                            dtype=torch_dtype(cfg.dtype), device=device),
        "ssm": torch.zeros((batch, n_heads, s.head_dim, s.d_state),
                           dtype=torch.float32, device=device),
    }


def ssm_cache_axes():
    return {"conv": ("batch", None, "d_inner"),
            "ssm": ("batch", "heads", None, None)}


def ssm_cache_layouts(cfg: ModelConfig):
    return {"conv": _layout(cfg, "conv")}


def _decode_mixer(p, cfg: ModelConfig, z, xBC, dt, conv_w, conv_b,
                  conv_state, ssm_state, heads: int):
    """``_mixer`` for one token: the conv over the cached window and the
    exact recurrent SSD update from ``ssm_state`` [B, heads, P, N].
    Returns (y * silu(z) [B, 1, heads * P], the new conv window, the new
    state); the cache is not written."""
    s_cfg = cfg.ssm
    di = heads * s_cfg.head_dim
    xBC, new_conv = _causal_conv(xBC, conv_w, conv_b, conv_state)
    xs, B, C = torch.split(xBC, [di, s_cfg.d_state, s_cfg.d_state], dim=-1)
    dt = _softplus(dt.float() + p["dt_bias"])[:, 0]              # [B,H]
    xs = xs.reshape(xs.shape[0], heads, s_cfg.head_dim).float()  # [B,H,P]
    A = -torch.exp(p["A_log"].float())                           # [H]
    dA = torch.exp(dt * A[None, :])                              # [B,H]
    dBx = (dt[:, :, None, None] * B[:, 0].float()[:, None, None, :]) * \
        xs[..., None]                                            # [B,H,P,N]
    state = ssm_state * dA[..., None, None] + dBx
    y = torch.einsum("bn,bhpn->bhp", C[:, 0].float(), state)
    y = y + xs * p["D"].float()[None, :, None]
    y = y.reshape(z.shape[0], 1, di).to(z.dtype)
    return y * F.silu(z), new_conv, state


def ssm_decode_step(params, cfg: ModelConfig, x, cache):
    """x: [B,1,D] -> ([B,1,D], cache). The exact recurrent SSD update;
    the new conv window and state are copied into ``cache["conv"]`` and
    ``cache["ssm"]`` in place (they may be views into stacked buffers)."""
    _, n_heads, _ = _dims(cfg)
    z, xBC, dt = _split_proj(cfg, x @ params["in_proj"])
    v, new_conv, state = _decode_mixer(
        params, cfg, z, xBC, dt, params["conv_w"], params["conv_b"],
        cache["conv"], cache["ssm"], n_heads)
    cache["conv"].copy_(new_conv)
    cache["ssm"].copy_(state)
    y = rms_norm(v, params["norm"], cfg.norm_eps)
    return y @ params["out_proj"], cache


# ---------------------------------------------------------------------------
# Tensor parallelism (``sharding.TensorParallel``; ``params`` one layer's
# placed mixer leaves, x an ``Act`` whole on each shard)
# ---------------------------------------------------------------------------

def _shard_proj(cfg: ModelConfig, p, x, hl: int):
    """A shard's z, x, dt of its ``hl`` heads and the whole B, C columns
    (xBC = x | B | C for the conv), and its conv weights in that order."""
    di = hl * cfg.ssm.head_dim
    w_h, w_bc = p["in_proj"]
    z, xs, dt = torch.split(x @ w_h, [di, di, hl], dim=-1)
    xBC = torch.cat([xs, x @ w_bc], dim=-1)
    conv_w = torch.cat(p["conv_w"], dim=-1)
    conv_b = torch.cat(p["conv_b"], dim=-1)
    return z, xBC, dt, conv_w, conv_b


def _gated_out_tp(tp, params, cfg: ModelConfig, v, d_inner: int):
    """``rms_norm(v, norm) @ out_proj`` over the shards' blocks v[j] of
    the d_inner channels: the sum of squares all-reduced, ``out_proj``
    row-parallel (partial sums)."""
    ss = tp.all_reduce(Act(tp.each(lambda j: v[j].float().square().sum(
        dim=-1, keepdim=True)), partial=True))

    def out(j):
        p = tp.params(params, j)
        y = v[j].float() * torch.rsqrt(ss.parts[j] / d_inner + cfg.norm_eps)
        return (y * p["norm"].float()).to(v[j].dtype) @ p["out_proj"]
    return Act(tp.each(out), partial=True)


def _whole_params(tp, params, j):
    return {k: tp.read(v, j) for k, v in params.items()}


def ssm_block_tp(tp, params, cfg: ModelConfig, x):
    """``ssm_block`` by model shard (partial sums); where tp does not
    divide the heads every shard runs the whole mixer."""
    d_inner, n_heads, _ = _dims(cfg)
    if not isinstance(tp.params(params, 0)["in_proj"], tuple):
        return Act(tp.each(lambda j: ssm_block(
            _whole_params(tp, params, j), cfg, x.parts[j])))
    hl = n_heads // tp.size

    def one(j):
        p = tp.params(params, j)
        return _mixer(p, cfg, *_shard_proj(cfg, p, x.parts[j], hl), hl)
    return _gated_out_tp(tp, params, cfg, tp.each(one), d_inner)


def ssm_decode_step_tp(tp, params, cfg: ModelConfig, x, caches):
    """``ssm_decode_step`` by model shard over each shard's cache block
    (``caches[j]``: the conv window's (own, shared) channels and the state
    of its heads), written in place."""
    d_inner, n_heads, _ = _dims(cfg)
    if not isinstance(tp.params(params, 0)["in_proj"], tuple):
        return Act(tp.each(lambda j: ssm_decode_step(
            _whole_params(tp, params, j), cfg, x.parts[j], caches[j])[0]))
    hl = n_heads // tp.size
    di = hl * cfg.ssm.head_dim

    def one(j):
        p = tp.params(params, j)
        return _decode_mixer(p, cfg, *_shard_proj(cfg, p, x.parts[j], hl),
                             torch.cat(caches[j]["conv"], dim=-1),
                             caches[j]["ssm"], hl)
    outs = tp.each(one)

    def write(j):
        # after every shard has read the window: the B, C channels are
        # one block that every shard holds
        c_h, c_bc = caches[j]["conv"]
        _, new_conv, state = outs[j]
        c_h.copy_(new_conv[..., :di])
        c_bc.copy_(new_conv[..., di:])
        caches[j]["ssm"].copy_(state)
    tp.each(write)
    return _gated_out_tp(tp, params, cfg, [o[0] for o in outs], d_inner)
