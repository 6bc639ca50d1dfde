"""The paper-scale local tasks of ``repro.core.tasks`` as batched forward
passes over the worker axis.

A Task is a struct of plain functions on worker-stacked tensors:

    init(generator, num_workers) -> params    dict of [W, ...] tensors
    loss(params, x, y, mask)     -> [W]       per-worker masked mean
    accuracy(params, x, y, mask) -> [W]

``x``/``y``/``mask`` carry the worker axis first ([W, B, ...]). Parameter
layouts are the reference's (the CNN keeps NHWC activations and HWIO
weights at the interface and converts for ``conv2d`` inside ``apply``), so
``convert.params_from_jax`` carries weights across unchanged. Each
worker's loss depends only on its own slice, so one ``backward()`` of
``loss(...).sum()`` yields the stacked per-worker gradients.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class Task:
    name: str
    init: Callable
    loss: Callable
    accuracy: Callable


def _flat(logits, y, mask):
    w, c = logits.shape[0], logits.shape[-1]
    return logits.reshape(w, -1, c), y.reshape(w, -1), mask.reshape(w, -1)


def _masked_ce(logits, y, mask):
    logits, y, mask = _flat(logits, y, mask)
    logp = F.log_softmax(logits, dim=-1)
    ll = logp.gather(-1, y.long()[..., None])[..., 0]
    return -(ll * mask).sum(-1) / mask.sum(-1).clamp_min(1.0)


def _masked_acc(logits, y, mask):
    logits, y, mask = _flat(logits, y, mask)
    correct = (logits.argmax(-1) == y.long()).float()
    return (correct * mask).sum(-1) / mask.sum(-1).clamp_min(1.0)


def _normal(gen, shape, scale):
    return torch.randn(shape, generator=gen, device=gen.device) * scale


def _make(name, init, apply, loss_io=None):
    loss_io = loss_io or (lambda p, x, y, m: (apply(p, x), y, m))
    return Task(name, init,
                lambda p, x, y, m: _masked_ce(*loss_io(p, x, y, m)),
                lambda p, x, y, m: _masked_acc(*loss_io(p, x, y, m)))


# ---------------------------------------------------------------------------
# MLP (paper's MLP on MNIST)
# ---------------------------------------------------------------------------

def mlp_task(input_dim: int, num_classes: int, hidden: int = 64) -> Task:
    def init(gen, w):
        dev = gen.device
        return {
            "w1": _normal(gen, (w, input_dim, hidden), input_dim ** -0.5),
            "b1": torch.zeros(w, hidden, device=dev),
            "w2": _normal(gen, (w, hidden, num_classes), hidden ** -0.5),
            "b2": torch.zeros(w, num_classes, device=dev),
        }

    def apply(p, x):                                   # x [W, B, D]
        h = torch.relu(x @ p["w1"] + p["b1"][:, None])
        return h @ p["w2"] + p["b2"][:, None]

    return _make("mlp", init, apply)


# ---------------------------------------------------------------------------
# CNN (paper's MnistNet/CNNCifar class) on [H, W, C] images
# ---------------------------------------------------------------------------

def _grouped_conv(x, k):
    """x [B, W·Cin, H, W'] (workers as conv groups); k HWIO [W, 3, 3, Cin,
    Cout] -> [B, W·Cout, H, W'], SAME padding, cross-correlation as in
    ``lax.conv_general_dilated``."""
    w, kh, kw, cin, cout = k.shape
    kt = k.permute(0, 4, 3, 1, 2).reshape(w * cout, cin, kh, kw)
    return F.conv2d(x, kt, padding=(kh // 2, kw // 2), groups=w)


def cnn_task(image_hw: int, channels: int, num_classes: int,
             width: int = 16) -> Task:
    def init(gen, w):
        flat = (image_hw // 4) ** 2 * (2 * width)
        return {
            "c1": _normal(gen, (w, 3, 3, channels, width), 0.1),
            "c2": _normal(gen, (w, 3, 3, width, 2 * width), 0.1),
            "w": _normal(gen, (w, flat, num_classes), flat ** -0.5),
            "b": torch.zeros(w, num_classes, device=gen.device),
        }

    def apply(p, x):                                   # x [W, B, H·W·C]
        w, b = x.shape[:2]
        x = x.reshape(w, b, image_hw, image_hw, channels)
        x = x.permute(1, 0, 4, 2, 3).reshape(b, w * channels, image_hw,
                                             image_hw)
        x = F.max_pool2d(torch.relu(_grouped_conv(x, p["c1"])), 2)
        x = F.max_pool2d(torch.relu(_grouped_conv(x, p["c2"])), 2)
        _, _, h2, w2 = x.shape
        # back to the reference's NHWC flatten order, per worker
        x = x.reshape(b, w, -1, h2, w2).permute(1, 0, 3, 4, 2)
        x = x.reshape(w, b, -1)
        return x @ p["w"] + p["b"][:, None]

    return _make("cnn", init, apply)


# ---------------------------------------------------------------------------
# Tiny transformer LM (paper's Transformer on Wikitext-2 class)
# ---------------------------------------------------------------------------

def lm_task(vocab: int, d: int = 32, seq: int = 16, heads: int = 2) -> Task:
    """Causal 1-layer transformer; x: [W, B, seq] int tokens, y = x
    shifted."""
    e = d // heads

    def init(gen, w):
        return {
            "emb": _normal(gen, (w, vocab, d), 0.1),
            "wq": _normal(gen, (w, d, d), d ** -0.5),
            "wk": _normal(gen, (w, d, d), d ** -0.5),
            "wv": _normal(gen, (w, d, d), d ** -0.5),
            "w1": _normal(gen, (w, d, 4 * d), d ** -0.5),
            "w2": _normal(gen, (w, 4 * d, d), (4 * d) ** -0.5),
        }

    def apply(p, x):                                   # x [W, B, S]
        w, b, s = x.shape
        rows = torch.arange(w, device=x.device)[:, None, None]
        h = p["emb"][rows, x.long()]                   # [W, B, S, d]
        q, k, v = ((h @ p[n][:, None]).reshape(w, b, s, heads, e)
                   for n in ("wq", "wk", "wv"))
        sc = torch.einsum("wbqhe,wbkhe->wbhqk", q, k) / e ** 0.5
        causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        sc = torch.where(causal, sc, torch.full_like(sc, -1e30))
        o = torch.einsum("wbhqk,wbkhe->wbqhe", torch.softmax(sc, -1), v)
        h = h + o.reshape(w, b, s, d)
        h = h + torch.relu(h @ p["w1"][:, None]) @ p["w2"][:, None]
        return h @ p["emb"].transpose(1, 2)[:, None]   # tied unembed

    def loss_io(p, x, y, m):
        logits = apply(p, x)[:, :, :-1]
        tgt = x[:, :, 1:]
        return logits, tgt, m[:, :, None].expand(tgt.shape).float()

    return _make("lm", init, apply, loss_io)
