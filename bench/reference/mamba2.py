"""Plain reference of Mamba2 (arXiv:2405.21060, "Transformers are SSMs"):
an attention-free stack of SSD mixer blocks, tied embeddings.

    x = E[tokens]
    each layer l:  x = x + Mixer_l(RMSNorm(x))
    logits = RMSNorm(x) E^T

The mixer (one B/C group): [z, xBC, dt] = h W_in; xBC = SiLU(causal
depthwise conv_K(xBC) + b); split xBC into x [H, P], B [N], C [N];
dt = softplus(dt + dt_bias); A = -exp(A_log); the SSD recurrence

    s_t = exp(dt_t A) s_{t-1} + dt_t x_t B_t^T,    y_t = s_t C_t + D x_t

computed as the paper's own listing computes it (its "SSD minimal"
chunked form: y = ((C B^T) o L) (dt x) + D x within each chunk, with
L[t, s] = exp(sum_{r=s+1..t} dt_r A) for s <= t, plus the states carried
between chunks); then out = RMSNorm(y * SiLU(z)) W_out (the gate before
the norm, Mamba2's gated RMSNorm). No kernel.

Parameters are a flat dict of float32 leaves in the layout the
configuration is served in (``layout``): the layers' leaves stacked on a
leading layer axis under ``scan/0/``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench.reference.lm import Precision, next_token_loss, rms_norm


def dims(cfg: dict):
    s = cfg["ssm"]
    d = cfg["d_model"]
    d_inner = s["expand"] * d
    heads = d_inner // s["head_dim"]
    conv_dim = d_inner + 2 * s["d_state"]
    return d, d_inner, heads, conv_dim


def layout(cfg: dict) -> dict:
    """{leaf name: (shape, init kind)}; the kinds are ``weights.py``'s."""
    s = cfg["ssm"]
    d, d_inner, heads, conv_dim = dims(cfg)
    n_layers = cfg["num_layers"]
    d_proj = 2 * d_inner + 2 * s["d_state"] + heads
    per_layer = {
        "ln1": ((d,), "ones"),
        "ssm/in_proj": ((d, d_proj), "normal"),
        "ssm/conv_w": ((s["d_conv"], conv_dim), "conv"),
        "ssm/conv_b": ((conv_dim,), "zeros"),
        "ssm/A_log": ((heads,), "a_log"),
        "ssm/D": ((heads,), "ones"),
        "ssm/dt_bias": ((heads,), "dt_bias"),
        "ssm/norm": ((d_inner,), "ones"),
        "ssm/out_proj": ((d_inner, d), "normal"),
    }
    out = {"embedding": ((cfg["vocab_size"], d), "normal"),
           "ln_f": ((d,), "ones")}
    for k, (shape, kind) in per_layer.items():
        out[f"scan/0/{k}"] = ((n_layers,) + shape, kind)
    return out


def segsum(a):
    """a [..., T] -> [..., T, T]: sum of a over (s, t] at [t, s] for s <= t,
    -inf above the diagonal."""
    t = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    causal = torch.ones(t, t, dtype=torch.bool, device=a.device).tril()
    return (cum[..., :, None] - cum[..., None, :]).masked_fill(
        ~causal, float("-inf"))


def ssd(x, dt, A, B, C, D, chunk: int, prec: Precision):
    """x [b, S, H, P], dt [b, S, H], A [H] (negative), B, C [b, S, N],
    D [H] -> y [b, S, H, P]: the SSD of the Mamba2 paper's listing (its
    chunked form, which equals the quadratic one exactly): the diagonal
    blocks' quadratic form, each chunk's final state, the states carried
    across chunks by their decays, and each chunk's output from the state
    it starts with."""
    b_, s, h, p = x.shape
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"sequence {s} is not a whole number of chunks {q}")
    c = s // q
    xs = (x * dt[..., None]).reshape(b_, c, q, h, p)
    a = (dt * A).reshape(b_, c, q, h).permute(0, 3, 1, 2)      # [b,h,c,q]
    Bc, Cc = B.reshape(b_, c, q, -1), C.reshape(b_, c, q, -1)
    cum = torch.cumsum(a, dim=-1)
    w = prec.einsum("bcln,bcsn->bcls", Cc, Bc)[:, None] * \
        torch.exp(segsum(a))                                     # [b,h,c,q,q]
    y_diag = prec.einsum("bhcls,bcshp->bclhp", w, xs)
    decay = torch.exp(cum[..., -1:] - cum).permute(0, 2, 3, 1)    # [b,c,q,h]
    states = prec.einsum("bcln,bclhp->bchpn", Bc, xs * decay[..., None])
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    carry = torch.exp(segsum(F.pad(cum[..., -1], (1, 0))))   # [b,h,c+1,c+1]
    states = prec.einsum("bhzc,bchpn->bzhpn", carry, states)[:, :-1]
    y_off = prec.einsum("bcln,bchpn->bclhp", Cc, states) * \
        torch.exp(cum).permute(0, 2, 3, 1)[..., None]
    return (y_diag + y_off).reshape(b_, s, h, p) + x * D[:, None]


def mixer(p: dict, cfg: dict, h, prec: Precision):
    s = cfg["ssm"]
    d, d_inner, heads, conv_dim = dims(cfg)
    n, k = s["d_state"], s["d_conv"]
    proj = prec.mm(h, p["in_proj"])
    z, xbc, dt = torch.split(proj, [d_inner, conv_dim, heads], dim=-1)
    pad = F.pad(xbc, (0, 0, k - 1, 0))                           # causal
    seq = xbc.shape[1]
    xbc = sum(pad[:, i:i + seq] * p["conv_w"][i] for i in range(k))
    xbc = F.silu(xbc + p["conv_b"])
    xs, B, C = torch.split(xbc, [d_inner, n, n], dim=-1)
    dt = F.softplus(dt + p["dt_bias"])
    b_ = h.shape[0]
    y = ssd(xs.reshape(b_, seq, heads, s["head_dim"]), dt,
            -torch.exp(p["A_log"]), B, C, p["D"], s["chunk_size"], prec)
    y = y.reshape(b_, seq, d_inner) * F.silu(z)
    return prec.mm(rms_norm(y, p["norm"], cfg["norm_eps"]), p["out_proj"])


class Model:
    def __init__(self, cfg: dict, precision: str = "fp32"):
        self.cfg = cfg
        self.prec = Precision(precision)

    def _layer(self, x, *leaves):
        names = ("ln1", "in_proj", "conv_w", "conv_b", "A_log", "D",
                 "dt_bias", "norm", "out_proj")
        p = dict(zip(names, leaves))
        h = rms_norm(x, p["ln1"], self.cfg["norm_eps"])
        return x + mixer(p, self.cfg, h, self.prec)

    def loss(self, params: dict, tokens):
        cfg = self.cfg
        emb = params["embedding"]
        x = emb[tokens]
        names = ("ln1", "ssm/in_proj", "ssm/conv_w", "ssm/conv_b",
                 "ssm/A_log", "ssm/D", "ssm/dt_bias", "ssm/norm",
                 "ssm/out_proj")
        for l in range(cfg["num_layers"]):
            leaves = [params[f"scan/0/{k}"][l] for k in names]
            x = checkpoint(self._layer, x, *leaves, use_reentrant=False)
        x = rms_norm(x, params["ln_f"], cfg["norm_eps"])
        return next_token_loss(self.prec.mm(x, emb.t()), tokens)
