"""Core layers: parameter builder, norms, RoPE, MLPs, embeddings (the port
of ``repro.models.layers``).

Parameters are plain nested dicts of tensors with the reference's names
and layouts, so ``convert`` carries a reference tree across leaf by leaf.
The reference's logical-axes trees and sharding constraints are not
ported: on one card they are the identity.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig


# ---------------------------------------------------------------------------
# Param builder
# ---------------------------------------------------------------------------

class Builder:
    """Names parameters into a nested dict, drawing them from one explicit
    ``torch.Generator`` on ``device`` in a fixed order.

    ``abstract=True`` records meta tensors (shape and dtype, no storage):
    the full-size tree without touching memory. ``into`` fills an existing
    tree of tensors in place instead of allocating (``blocks.init_stack``
    fills one layer's slice of the stacked parameters at a time). Normal
    draws are made in fp32 and cast into the tensor, as the reference
    does.
    """

    def __init__(self, gen, dtype, device=None, abstract: bool = False,
                 into=None):
        self.gen = gen
        self.dtype = dtype
        self.device = device
        self.abstract = abstract
        self.into = into
        self.params = {}

    def empty(self, shape):
        """An uninitialised tensor of the builder's dtype (meta when
        abstract)."""
        dev = "meta" if self.abstract else self.device
        return torch.empty(tuple(shape), dtype=self.dtype, device=dev)

    def _put(self, name, shape, fill):
        if self.into is not None:
            t = self.into[name]
            assert tuple(t.shape) == tuple(shape), (name, t.shape, shape)
        else:
            t = self.empty(shape)
        if not self.abstract:
            fill(t)
        self.params[name] = t
        return t

    def normal(self, name, shape, scale=0.02):
        def fill(t):
            draw = torch.randn(t.shape, generator=self.gen,
                               dtype=torch.float32, device=t.device)
            t.copy_(draw.mul_(scale))
        return self._put(name, shape, fill)

    def zeros(self, name, shape):
        return self._put(name, shape, lambda t: t.zero_())

    def ones(self, name, shape):
        return self._put(name, shape, lambda t: t.fill_(1))

    def const(self, name, value):
        """A given value (array-like, computed in fp32) cast to the
        builder's dtype (round to nearest even, as the reference's
        ``jnp.asarray(value, dtype)``)."""
        value = torch.as_tensor(value)
        return self._put(name, tuple(value.shape), lambda t: t.copy_(value))

    def sub(self, name):
        into = None if self.into is None else self.into[name]
        b = Builder(self.gen, self.dtype, self.device, self.abstract, into)
        self.params[name] = b.params
        return b


def torch_dtype(name: str) -> torch.dtype:
    """A config's dtype string ("bfloat16", "float32") as a torch dtype."""
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x, weight, eps):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * weight.float()).to(dt)


def head_rms_norm(x, weight, eps):
    """Per-head RMSNorm over head_dim (Qwen3 qk_norm). x: [..., H, hd]."""
    return rms_norm(x, weight, eps)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float):
    half = head_dim // 2
    return 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))


def apply_rope(x, positions, theta):
    """x: [B, S, H, hd]; positions: [B, S] (absolute). Pairs are split-half;
    the rotation is computed in fp32."""
    if theta <= 0:
        return x
    freqs = torch.from_numpy(rope_frequencies(x.shape[-1], theta)).to(
        x.device)                                              # [hd/2]
    angles = positions[..., None].float() * freqs              # [B, S, hd/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Dense FFNs
# ---------------------------------------------------------------------------

def init_mlp(b: Builder, d_model: int, d_ff: int):
    b.normal("wi", (d_model, d_ff))
    b.normal("wg", (d_model, d_ff))
    b.normal("wo", (d_ff, d_model))


def mlp(params, x):
    """SwiGLU MLP. x: [..., D]."""
    h = x @ params["wi"]
    g = x @ params["wg"]
    return (F.silu(g) * h) @ params["wo"]


def init_gelu_mlp(b: Builder, d_model: int, d_ff: int):
    b.normal("wi", (d_model, d_ff))
    b.zeros("bi", (d_ff,))
    b.normal("wo", (d_ff, d_model))
    b.zeros("bo", (d_model,))


def gelu_mlp(params, x):
    """2-matrix GELU MLP (tanh approximation, as ``jax.nn.gelu``)."""
    h = F.gelu(x @ params["wi"] + params["bi"], approximate="tanh")
    return h @ params["wo"] + params["bo"]


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def init_embed(b: Builder, cfg: ModelConfig):
    b.normal("embedding", (cfg.vocab_size, cfg.d_model), scale=0.01)
    if not cfg.tie_embeddings:
        b.normal("lm_head", (cfg.d_model, cfg.vocab_size))


def embed(params, tokens):
    return F.embedding(tokens, params["embedding"])


def unembed(params, x, tie: bool):
    if tie:
        return x @ params["embedding"].t()
    return x @ params["lm_head"]
