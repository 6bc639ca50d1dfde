"""The benchmark's inputs, made from ``--seed`` on the device: the model's
weights, the token batches and the gossip rounds' Gumbel draws. The same
seed gives the same inputs, and both sides (the program and the plain
reference) are handed the same ones.

Weights follow the configuration's layout (``reference.<model>.layout``:
each leaf's shape and how it starts): matrices N(0, 0.02) (the published
configs' initializer_range), norm scales 1, the causal conv N(0, 1/(3K))
(the variance of PyTorch's default U(-1/sqrt(K), 1/sqrt(K))), the conv
bias 0, Mamba2's A_log = log(1..H), D = 1 and dt_bias = softplus^-1(dt)
with dt log-uniform in [1e-3, 0.1] (mamba_ssm's init). Every normal leaf
is a slice of one draw, made in the type the weights are served in.
"""
from __future__ import annotations

import math

import torch

MATRIX_STD = 0.02
DT_MIN, DT_MAX = 1e-3, 0.1
_STREAMS = {"weights": 1, "tokens": 2, "draws": 3, "sample": 4}


def stream_seed(seed: int, stream: str) -> int:
    """One generator seed a stream, from the run's seed (any whole number
    that fits 62 bits)."""
    return (int(seed) * 8 + _STREAMS[stream]) % (1 << 63)


def generator(seed: int, stream: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        stream_seed(seed, stream))


def make_weights(layout: dict, seed: int, device, dtype) -> dict:
    """{leaf: tensor} in ``dtype`` on ``device``, drawn from ``seed``."""
    gen = generator(seed, "weights", device)
    names = sorted(layout)
    normal = [k for k in names if layout[k][1] in ("normal", "conv")]
    total = sum(math.prod(layout[k][0]) for k in normal)
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out, at = {}, 0
    for k in normal:
        shape, kind = layout[k]
        n = math.prod(shape)
        std = MATRIX_STD if kind == "normal" else 1.0 / math.sqrt(
            3 * shape[-2])
        out[k] = flat[at:at + n].view(shape).mul_(std)
        at += n
    for k in names:
        shape, kind = layout[k]
        if kind == "ones":
            out[k] = torch.ones(shape, device=device, dtype=dtype)
        elif kind == "zeros":
            out[k] = torch.zeros(shape, device=device, dtype=dtype)
        elif kind == "a_log":
            heads = shape[-1]
            a = torch.log(torch.arange(1, heads + 1, dtype=torch.float32,
                                       device=device))
            out[k] = a.expand(shape).to(dtype).contiguous()
        elif kind == "dt_bias":
            u = torch.rand(shape, generator=gen, device=device)
            dt = torch.exp(u * (math.log(DT_MAX) - math.log(DT_MIN))
                           + math.log(DT_MIN))
            out[k] = (dt + torch.log(-torch.expm1(-dt))).to(dtype)
    return out


def token_batches(seed: int, vocab: int, shape, device):
    """An endless iterator of token batches [pods, B, S] (int64), each
    drawn uniformly over the vocabulary; the same seed gives the same
    sequence."""
    gen = generator(seed, "tokens", device)
    while True:
        yield torch.randint(0, vocab, tuple(shape), generator=gen,
                            device=device)


class GumbelDraws:
    """The gossip rounds' randomness, as the pod round asks for it (an
    ``rng.Draws`` provider): a [W, W] Gumbel(0, 1) draw a round from the
    seed; the first round's is kept, so the reference can be handed it."""

    def __init__(self, seed: int, device, round_draws_cls):
        self.gen = generator(seed, "draws", device)
        self.cls = round_draws_cls
        self.first = None

    def __call__(self, w, local_epochs, n, noise_shapes, **extra):
        if noise_shapes is not None or any(v is not None
                                           for v in extra.values()):
            raise ValueError("the benchmark's rounds draw Gumbel rows only")
        u = torch.rand(w, w, generator=self.gen, device=self.gen.device)
        gumbel = -torch.log(-torch.log(u.clamp(1e-20, 1 - 1e-7)))
        if self.first is None:
            self.first = gumbel.clone()
        perm = torch.zeros((w, local_epochs, n), dtype=torch.int64,
                           device=gumbel.device)
        return self.cls(gumbel=gumbel, perm=perm, noise=None)
