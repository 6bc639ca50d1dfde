"""The draw seam: every random number a round consumes, as tensors.

The round asks its ``Draws`` provider once per round for a ``RoundDraws``.
The default provider, ``TorchDraws``, draws from an explicit seeded
``torch.Generator``. A test can plug in a provider that re-derives the
reference's ``jax.random`` draws from its frozen key layout, so that the
port and the JAX package consume identical randomness.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Protocol

import torch


@dataclass
class RoundDraws:
    gumbel: torch.Tensor      # [W, W] Gumbel(0, 1), one row per worker
                              # (peer_sample: dts.sample_peers)
    perm: torch.Tensor        # [W, local_epochs, n] int64: each worker's
                              # minibatch permutation of its n = Nmax
                              # (padded) samples, per local epoch
    noise: Optional[dict]     # leaf name -> [W, ...] N(0, 1) for the noise
                              # attack; None when the world has no attacker


class Draws(Protocol):
    def __call__(self, w: int, local_epochs: int, n: int,
                 noise_shapes: Optional[dict]) -> RoundDraws:
        """Draws for one round: W workers, ``local_epochs`` permutations of
        ``n`` samples each, and one normal draw per leaf of
        ``noise_shapes`` (name -> shape), or none if it is None."""


class TorchDraws:
    """The default provider: draws on the generator's device."""

    def __init__(self, generator: torch.Generator):
        self.gen = generator

    def __call__(self, w, local_epochs, n, noise_shapes):
        g, dev = self.gen, self.gen.device
        # Gumbel(0, 1) = -log(E) with E ~ Exp(1)
        gumbel = -torch.empty(w, w, device=dev).exponential_(generator=g).log()
        perm = torch.rand(w, local_epochs, n, generator=g,
                          device=dev).argsort(dim=-1)
        noise = None
        if noise_shapes is not None:
            noise = {name: torch.randn(shape, generator=g, device=dev)
                     for name, shape in sorted(noise_shapes.items())}
        return RoundDraws(gumbel=gumbel, perm=perm, noise=noise)
