"""Core layers: parameter builder, norms, RoPE, MLPs, embeddings (the port
of ``repro.models.layers``).

Parameters are plain nested dicts of tensors with the reference's names
and layouts, so ``convert`` carries a reference tree across leaf by leaf.
The ``Builder`` records each leaf's logical axes as the reference's does
(``model.param_axes``; ``sharding.resolve_spec`` maps them to mesh axes),
and a leaf's column layout where its columns follow heads
(``models.ssm.head_layout``). The tensor-parallel forms (``mlp_tp``,
``gelu_mlp_tp``, ``embed_tp``, ``unembed_tp``) run each model shard's
columns or rows (``sharding.TensorParallel``).
"""
from __future__ import annotations

import functools

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
    does. ``axes`` holds each leaf's logical axes, ``layouts`` a leaf's
    ``(dim, fn(tp) -> (groups, shared))`` column layout.
    """

    def __init__(self, gen, dtype, device=None, abstract: bool = False,
                 into=None):
        self.gen = gen
        self.dtype = dtype
        self.device = device
        self.abstract = abstract
        self.into = into
        self.params = {}
        self.axes = {}
        self.layouts = {}

    def empty(self, shape):
        """An uninitialised tensor of the builder's dtype (meta when
        abstract)."""
        dev = "meta" if self.abstract else self.device
        return torch.empty(tuple(shape), dtype=self.dtype, device=dev)

    def _put(self, name, shape, axes, fill, layout=None):
        if axes is None:                    # replicated
            axes = (None,) * len(shape)
        assert len(shape) == len(axes), (name, shape, axes)
        self.axes[name] = tuple(axes)
        if layout is not None:
            self.layouts[name] = layout
        if self.into is not None:
            t = self.into[name]
            assert tuple(t.shape) == tuple(shape), (name, t.shape, shape)
        else:
            t = self.empty(shape)
        if not self.abstract:
            fill(t)
        self.params[name] = t
        return t

    def normal(self, name, shape, axes=None, scale=0.02, layout=None):
        def fill(t):
            draw = torch.randn(t.shape, generator=self.gen,
                               dtype=torch.float32, device=t.device)
            t.copy_(draw.mul_(scale))
        return self._put(name, shape, axes, fill, layout)

    def zeros(self, name, shape, axes=None, layout=None):
        return self._put(name, shape, axes, lambda t: t.zero_(), layout)

    def ones(self, name, shape, axes=None):
        return self._put(name, shape, axes, lambda t: t.fill_(1))

    def const(self, name, value, axes=None):
        """A given value (array-like, computed in fp32) cast to the
        builder's dtype (round to nearest even, as the reference's
        ``jnp.asarray(value, dtype)``)."""
        value = torch.as_tensor(value)
        return self._put(name, tuple(value.shape), axes,
                         lambda t: t.copy_(value))

    def sub(self, name):
        into = None if self.into is None else self.into[name]
        b = Builder(self.gen, self.dtype, self.device, self.abstract, into)
        self.params[name] = b.params
        self.axes[name] = b.axes
        self.layouts[name] = b.layouts
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
# Sinusoidal positions (whisper)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _sinusoid_table(seq_len: int, d_model: int, pinned: bool):
    """The float32 table, computed in float64 numpy and cast once, as the
    reference's table is; kept per shape (whisper's 1,500 x 384 costs
    milliseconds of host time: PERF.md) and never handed out, only copied
    from (in pinned host memory for the card)."""
    half = d_model // 2
    freqs = np.exp(-np.log(10_000.0) * np.arange(half) / max(half - 1, 1))
    pos = np.arange(seq_len)[:, None] * freqs[None, :]
    table = torch.from_numpy(np.concatenate([np.sin(pos), np.cos(pos)],
                                            axis=1).astype(np.float32))
    return table.pin_memory() if pinned else table


def sinusoidal_positions(seq_len: int, d_model: int, device=None,
                         dtype=torch.float32):
    """Whisper-style fixed sinusoidal table [S, D] on ``device`` (default
    the CPU) in ``dtype``: a fresh tensor each call. To the card it is
    copied from pinned host memory, so the host does not wait for the
    stream."""
    device = torch.device("cpu" if device is None else device)
    if device.type != "cpu":            # the card; meta makes the same ops
        return _sinusoid_table(seq_len, d_model, device.type == "cuda").to(
            device, non_blocking=True).to(dtype)
    return _sinusoid_table(seq_len, d_model, False).to(dtype=dtype,
                                                       copy=True)


def sinusoidal_at(pos: int, d_model: int, device=None):
    """The sinusoidal embedding [D] of one position, computed in float32
    throughout (the reference's scalar form, which decode uses; it differs
    from the table's row in the last bits)."""
    half = d_model // 2
    log_1e4 = float(np.log(np.float32(10_000.0)))       # the float32 log
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=device)
                      * -log_1e4 / max(half - 1, 1))
    # host scalars enter as kernel arguments: no copy to the card, no sync
    angles = freqs * float(pos)
    return torch.cat([torch.sin(angles), torch.cos(angles)])


# ---------------------------------------------------------------------------
# Dense FFNs
# ---------------------------------------------------------------------------

def init_mlp(b: Builder, d_model: int, d_ff: int):
    b.normal("wi", (d_model, d_ff), ("embed", "mlp"))
    b.normal("wg", (d_model, d_ff), ("embed", "mlp"))
    b.normal("wo", (d_ff, d_model), ("mlp", "embed"))


def mlp(params, x):
    """SwiGLU MLP. x: [..., D]."""
    h = x @ params["wi"]
    g = x @ params["wg"]
    return (F.silu(g) * h) @ params["wo"]


def init_gelu_mlp(b: Builder, d_model: int, d_ff: int):
    b.normal("wi", (d_model, d_ff), ("embed", "mlp"))
    b.zeros("bi", (d_ff,), ("mlp",))
    b.normal("wo", (d_ff, d_model), ("mlp", "embed"))
    b.zeros("bo", (d_model,), ("embed",))


def gelu_mlp(params, x):
    """2-matrix GELU MLP (tanh approximation, as ``jax.nn.gelu``)."""
    h = F.gelu(x @ params["wi"] + params["bi"], approximate="tanh")
    return h @ params["wo"] + params["bo"]


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def init_embed(b: Builder, cfg: ModelConfig):
    b.normal("embedding", (cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
             scale=0.01)
    if not cfg.tie_embeddings:
        b.normal("lm_head", (cfg.d_model, cfg.vocab_size),
                 ("embed", "vocab"))


def embed(params, tokens):
    return F.embedding(tokens, params["embedding"])


def unembed(params, x, tie: bool):
    if tie:
        return x @ params["embedding"].t()
    return x @ params["lm_head"]


# ---------------------------------------------------------------------------
# Tensor-parallel forms (``sharding.TensorParallel``; ``ps[j]`` is model
# shard j's blocks of the layer's parameters)
# ---------------------------------------------------------------------------

def rms_norm_tp(tp, x, ps, name, eps):
    """``rms_norm`` of each shard's block of x (any layout but partial)
    with the replicated weight ``ps[j][name]``."""
    from repro_torch.sharding import Act
    return Act(tp.each(lambda j: rms_norm(x.parts[j], ps[j][name], eps)),
               split=x.split)


def mlp_tp(tp, ps, x, d_ff: int):
    """SwiGLU MLP with "mlp" over the model axis: shard j's wi, wg
    columns and wo rows over the whole x (an ``Act`` whole on each shard).
    Returns partial sums (an ``Act``); where "mlp" is replicated each
    shard's output is whole."""
    from repro_torch.sharding import Act
    parts = tp.each(lambda j: mlp(ps[j], x.parts[j]))
    return Act(parts, partial=ps[0]["wi"].shape[-1] < d_ff)


def gelu_mlp_tp(tp, ps, x, d_ff: int):
    """``gelu_mlp`` by model shard: the bias ``bo`` enters shard 0's
    partial sum only."""
    from repro_torch.sharding import Act
    split = ps[0]["wi"].shape[-1] < d_ff

    def one(j):
        p = ps[j]
        h = F.gelu(x.parts[j] @ p["wi"] + p["bi"], approximate="tanh")
        y = h @ p["wo"]
        return y + p["bo"] if (j == 0 or not split) else y
    return Act(tp.each(one), partial=split)


def embed_tp(tp, ps, tokens, vocab: int):
    """Vocabulary-parallel lookup: shard j reads the tokens in its rows
    (the others give 0), so the shards' partial sums are the embedding;
    with "vocab" replicated every shard looks up whole."""
    from repro_torch.sharding import Act
    rows = ps[0]["embedding"].shape[0]
    if rows == vocab:
        return Act(tp.each(lambda j: embed(ps[j], tokens.to(
            tp.devices[j]))))

    def one(j):
        t = tokens.to(tp.devices[j]) - j * rows
        inside = (t >= 0) & (t < rows)
        e = F.embedding(t.clamp(0, rows - 1), ps[j]["embedding"])
        return e * inside[..., None].to(e.dtype)
    return Act(tp.each(one), partial=True)


def unembed_tp(tp, ps, x, tie: bool, vocab: int):
    """Vocabulary-parallel logits: shard j's [..., V / tp] columns from the
    whole x (``Act`` whole on each shard), split along the last dim; with
    "vocab" replicated every shard's logits are whole."""
    from repro_torch.sharding import Act
    parts = tp.each(lambda j: unembed(ps[j], x.parts[j], tie))
    split = parts[0].shape[-1] < vocab
    return Act(parts, split=parts[0].dim() - 1 if split else None)
