"""The draw seams: every random number a round or a tick consumes, as
tensors.

A DeFTA round asks its ``Draws`` provider once per round for a
``RoundDraws`` (with two build-time-gated extras: the scenario attacks'
per-kind noise and the stochastic int8 wire's uniforms, asked for by
keyword only when the round needs them, so a provider that knows neither
serves every other world unchanged); a FedAvg round asks its
``FedAvgDraws`` provider once per round for a ``FedAvgRoundDraws``; an
async tick asks its ``TickDraws`` provider once per live tick for one
``[W]`` uniform. The default
providers (``TorchDraws``, ``TorchFedAvgDraws``, ``TorchTickDraws``) draw
from an explicit seeded ``torch.Generator``. A test can plug in providers
that re-derive the reference's ``jax.random`` draws from its frozen key
layouts, so that the port and the JAX package consume identical
randomness.
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
                              # (or runs a scenario)
    kind_noise: Optional[dict] = None
                              # scenario attacks: kind -> {leaf name ->
                              # [W, ...] N(0, 1)} for each kind present that
                              # consumes randomness (noise, alie_decor)
    wire_u: Optional[dict] = None
                              # stochastic int8 wire: leaf name -> [W, F]
                              # U[0, 1), the rounding uniforms


class Draws(Protocol):
    def __call__(self, w: int, local_epochs: int, n: int,
                 noise_shapes: Optional[dict], *,
                 kind_noise: Optional[dict] = None,
                 wire_shapes: Optional[dict] = None) -> RoundDraws:
        """Draws for one round: W workers, ``local_epochs`` permutations of
        ``n`` samples each, and one normal draw per leaf of
        ``noise_shapes`` (name -> shape), or none if it is None. The round
        passes ``kind_noise`` (attack kind -> {leaf name -> shape}) and
        ``wire_shapes`` (leaf name -> [W, F]) only when it needs them."""


def _perm(g: torch.Generator, w, local_epochs, n) -> torch.Tensor:
    return torch.rand(w, local_epochs, n, generator=g,
                      device=g.device).argsort(dim=-1)


def _noise(g: torch.Generator, noise_shapes) -> Optional[dict]:
    if noise_shapes is None:
        return None
    return {name: torch.randn(shape, generator=g, device=g.device)
            for name, shape in sorted(noise_shapes.items())}


def _uniform(g: torch.Generator, shapes) -> Optional[dict]:
    if shapes is None:
        return None
    return {name: torch.rand(shape, generator=g, device=g.device)
            for name, shape in sorted(shapes.items())}


class TorchDraws:
    """The default provider: draws on the generator's device."""

    def __init__(self, generator: torch.Generator):
        self.gen = generator

    def __call__(self, w, local_epochs, n, noise_shapes, *,
                 kind_noise=None, wire_shapes=None):
        g = self.gen
        # Gumbel(0, 1) = -log(E) with E ~ Exp(1)
        gumbel = -torch.empty(w, w, device=g.device).exponential_(
            generator=g).log()
        d = RoundDraws(gumbel=gumbel, perm=_perm(g, w, local_epochs, n),
                       noise=_noise(g, noise_shapes))
        # the extras draw after everything else, and nothing when not asked
        # for: every other world's stream stays as it was
        if kind_noise is not None:
            d.kind_noise = {k: _noise(g, shapes)
                            for k, shapes in kind_noise.items()}
        d.wire_u = _uniform(g, wire_shapes)
        return d


@dataclass
class FedAvgRoundDraws:
    perm: torch.Tensor        # [W, local_epochs, n] int64, as RoundDraws
    noise: Optional[dict]     # leaf name -> [W, ...] N(0, 1) (the broadcast
                              # server's leaves); None without attackers
    cohort: Optional[torch.Tensor]   # [sample_workers] int64 distinct
                                     # worker indices (CFL-S); None for
                                     # CFL-F (sample_workers=0)


class FedAvgDraws(Protocol):
    def __call__(self, w: int, local_epochs: int, n: int,
                 noise_shapes: Optional[dict],
                 sample_workers: int) -> FedAvgRoundDraws:
        """Draws for one FedAvg round: the permutations and the noise as
        ``Draws`` gives them, and ``sample_workers`` distinct indices of
        ``range(w)`` drawn without replacement (none when 0)."""


class TorchFedAvgDraws:
    """The default FedAvg provider: draws on the generator's device."""

    def __init__(self, generator: torch.Generator):
        self.gen = generator

    def __call__(self, w, local_epochs, n, noise_shapes, sample_workers):
        g = self.gen
        cohort = torch.randperm(w, generator=g, device=g.device)[
            :sample_workers] if sample_workers else None
        return FedAvgRoundDraws(perm=_perm(g, w, local_epochs, n),
                                noise=_noise(g, noise_shapes), cohort=cohort)


class TickDraws(Protocol):
    def __call__(self, w: int) -> torch.Tensor:
        """One live tick's [W] float32 uniforms in [0, 1): worker i fires
        where its uniform is below its speed."""


class TorchTickDraws:
    """The default tick provider: draws on the generator's device."""

    def __init__(self, generator: torch.Generator):
        self.gen = generator

    def __call__(self, w):
        return torch.rand(w, generator=self.gen, device=self.gen.device)
