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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import Builder, rms_norm, torch_dtype


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.d_state
    return d_inner, n_heads, conv_dim


def init_ssm(b: Builder, cfg: ModelConfig):
    s = cfg.ssm
    d = cfg.d_model
    d_inner, n_heads, conv_dim = _dims(cfg)
    d_proj = 2 * d_inner + 2 * s.d_state + n_heads   # z, xBC, dt
    b.normal("in_proj", (d, d_proj))
    b.normal("conv_w", (s.d_conv, conv_dim), scale=0.1)
    b.zeros("conv_b", (conv_dim,))
    b.const("A_log", torch.log(torch.arange(1, n_heads + 1,
                                            dtype=torch.float32)))
    b.zeros("D", (n_heads,))
    b.zeros("dt_bias", (n_heads,))
    b.ones("norm", (d_inner,))
    b.normal("out_proj", (d_inner, d))


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


def ssm_block(params, cfg: ModelConfig, x):
    """Prefill forward. x: [B,S,D] -> [B,S,D]."""
    s_cfg = cfg.ssm
    d_inner, n_heads, _ = _dims(cfg)
    proj = x @ params["in_proj"]
    z, xBC, dt = _split_proj(cfg, proj)
    xBC, _ = _causal_conv(xBC, params["conv_w"], params["conv_b"])
    xs, B, C = torch.split(xBC, [d_inner, s_cfg.d_state, s_cfg.d_state],
                           dim=-1)
    dt = _softplus(dt.float() + params["dt_bias"])
    xs = xs.reshape(*xs.shape[:2], n_heads, s_cfg.head_dim)
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
    y, _ = ssd_scan(xs.float(), dt, params["A_log"].float(), B.float(),
                    C.float(), params["D"].float(), chunk)
    y = y[:, :s_len]
    y = y.reshape(*y.shape[:2], d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), params["norm"], cfg.norm_eps)
    return y @ params["out_proj"]


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


def ssm_decode_step(params, cfg: ModelConfig, x, cache):
    """x: [B,1,D] -> ([B,1,D], cache). The exact recurrent SSD update;
    the new conv window and state are copied into ``cache["conv"]`` and
    ``cache["ssm"]`` in place (they may be views into stacked buffers)."""
    s_cfg = cfg.ssm
    d_inner, n_heads, _ = _dims(cfg)
    proj = x @ params["in_proj"]
    z, xBC, dt = _split_proj(cfg, proj)
    xBC, new_conv = _causal_conv(xBC, params["conv_w"], params["conv_b"],
                                 cache["conv"])
    xs, B, C = torch.split(xBC, [d_inner, s_cfg.d_state, s_cfg.d_state],
                           dim=-1)
    dt = _softplus(dt.float() + params["dt_bias"])[:, 0]          # [B,H]
    xs = xs.reshape(xs.shape[0], n_heads, s_cfg.head_dim).float()  # [B,H,P]
    A = -torch.exp(params["A_log"].float())                       # [H]
    dA = torch.exp(dt * A[None, :])                               # [B,H]
    dBx = (dt[:, :, None, None] * B[:, 0].float()[:, None, None, :]) * \
        xs[..., None]                                             # [B,H,P,N]
    state = cache["ssm"] * dA[..., None, None] + dBx
    y = torch.einsum("bn,bhpn->bhp", C[:, 0].float(), state)
    y = y + xs * params["D"].float()[None, :, None]
    y = y.reshape(x.shape[0], 1, d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), params["norm"], cfg.norm_eps)
    cache["conv"].copy_(new_conv)
    cache["ssm"].copy_(state)
    return y @ params["out_proj"], cache
