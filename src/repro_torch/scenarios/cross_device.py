"""Cross-device participation worlds: churn as the DEFAULT, not a fault.

Production FL (the simple_fedavg exemplar; Kairouz et al.'s cross-device
setting) never trains all users at once: a huge enrolled population holds
stateful per-user trust / residuals / data shards, and each round samples
a small cohort of whoever is reachable — dropout, stragglers and mid-round
departure are the normal case (Gabrielli et al. 2308.04604 names partial
participation at population scale as THE open problem decentralized
frameworks must solve; DeceFL 2107.07171 shows convergence needs
aggregation weights renormalized over who actually showed up).

A ``CrossDeviceSpec`` describes that world declaratively:

* the enrolled population size N and the per-round cohort size k;
* an ``availability`` rate (a user is reachable when the round starts),
  with default-on ``dropout`` (mid-round departure — the slot's partial
  contribution is masked out of the mixing row-normalization) and
  ``straggle`` (timeout — the slot is consumed by peers but its own
  update misses the merge) probabilities;
* the cohort gossip topology (random k-out, redrawn every round — a fresh
  cohort has no standing links); and
* the attack assignment over the ENROLLED population: ``(kind, fraction)``
  pairs, so "29% of enrolled are malicious" means ~29% of every cohort in
  expectation — the sparse-observation threat model DTS must survive.

``compile_world`` evaluates the whole participation timeline ONCE on the
host (same philosophy as ``scenarios.compile``): per-round cohort indices
``part_ix [T, k]`` (distinct within a round — scatter-safe), the
``filled``/``survive``/``complete`` masks, per-round adjacencies
``adj [T, k, k]``, and the per-user ``attack_kind``/``attack_scale``
arrays. ``core.engine.build_cross_device_round`` replays it device-side
from the traced round index with zero extra dispatches.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Tuple

import numpy as np

from repro_torch.scenarios.compile import ATTACK_CODE, DEFAULT_SCALE
from repro_torch.scenarios.spec import ATTACK_KINDS


@dataclass(frozen=True)
class CrossDeviceSpec:
    """A cross-device world. ``attacks``: ``((kind, fraction), ...)`` over
    the enrolled population; ``scale=0`` per kind means the zoo default
    (``compile.DEFAULT_SCALE``)."""
    name: str = "cross_device"
    enrolled: int = 10_000
    sample_k: int = 64
    k_min: int = 1                   # < k_min surviving sampled peers →
                                     # identity mixing row (self-train)
    avg_peers: int = 4               # cohort out-degree (redrawn per round)
    availability: float = 0.7        # P(reachable at round start)
    dropout: float = 0.05            # P(mid-round departure | selected)
    straggle: float = 0.10           # P(straggler timeout | survived)
    attacks: Tuple[Tuple[str, float], ...] = ()
    attack_scale: float = 0.0        # 0 → per-kind DEFAULT_SCALE
    seed: int = 0

    def __post_init__(self):
        if self.sample_k > self.enrolled:
            raise ValueError(f"sample_k={self.sample_k} exceeds "
                             f"enrolled={self.enrolled}")
        if not (0.0 < self.availability <= 1.0):
            raise ValueError("availability must be in (0, 1]")
        for kind, frac in self.attacks:
            if kind not in ATTACK_KINDS:
                raise ValueError(f"unknown attack kind {kind!r}")
            if not (0.0 <= frac < 1.0):
                raise ValueError(f"attack fraction {frac} out of [0, 1)")
        if sum(f for _, f in self.attacks) >= 1.0:
            raise ValueError("attack fractions sum to >= 1: nobody honest")


@dataclass
class CompiledWorld:
    """Host-compiled participation timeline (numpy — the engine converts
    to device arrays once at build time)."""
    name: str
    enrolled: int
    sample_k: int
    k_min: int
    epochs: int
    part_ix: np.ndarray          # [T, k] int32 cohort indices (distinct
                                 # within each round)
    filled: np.ndarray           # [T, k] bool — False on vacancy pad slots
    survive: np.ndarray          # [T, k] bool — False on mid-round dropout
    complete: np.ndarray         # [T, k] bool — False on straggler timeout
    adj: np.ndarray              # [T, k, k] bool cohort topology
    attack_kind: np.ndarray      # [N] int32 (ATTACK_CODE, 0 = honest)
    attack_scale: np.ndarray     # [N] float32
    kinds_present: Tuple[str, ...]
    malicious: np.ndarray        # [N] bool
    spec: Any = field(default=None, repr=False)

    def summary(self) -> dict:
        fire = self.filled & self.survive & self.complete
        return {
            "enrolled": self.enrolled,
            "sample_k": self.sample_k,
            "rounds": self.epochs,
            "attacks": {kk: int((self.attack_kind
                                 == ATTACK_CODE[kk]).sum())
                        for kk in self.kinds_present},
            "malicious_frac": float(self.malicious.mean()),
            "mean_filled": float(self.filled.mean()),
            "mean_survive": float(self.survive[self.filled].mean())
            if self.filled.any() else 1.0,
            "mean_fire": float(fire.sum() / max(self.filled.sum(), 1)),
            "participation_rate": float(fire.sum()
                                        / (self.epochs * self.enrolled)),
        }


def _cohort_topology(rng: np.random.Generator, k: int,
                     avg_peers: int) -> np.ndarray:
    """Random k-out digraph over the cohort: each row i listens to
    ``avg_peers`` distinct peers (adj[i, j] = i listens to j)."""
    deg = min(avg_peers, k - 1)
    adj = np.zeros((k, k), bool)
    if deg <= 0:
        return adj
    for i in range(k):
        peers = rng.choice(k - 1, size=deg, replace=False)
        peers = peers + (peers >= i)         # skip self
        adj[i, peers] = True
    return adj


def compile_world(spec: CrossDeviceSpec, epochs: int) -> CompiledWorld:
    """Evaluate the participation timeline over ``epochs`` global rounds.

    Per round: draw availability over the population, pick k DISTINCT
    users preferring available ones (unavailable fillers get
    ``filled=False`` — they occupy the static-shape slot but never train,
    never fire, and are masked out of the cohort topology), then draw the
    mid-round dropout and straggler-timeout fates and a fresh cohort
    topology. Everything is deterministic in ``spec.seed``.
    """
    if epochs <= 0:
        raise ValueError("cross-device world needs epochs > 0")
    n, k = spec.enrolled, spec.sample_k
    rng = np.random.default_rng(spec.seed * 7_919 + 0xD1CE)

    # enrolled-population attack assignment
    attack_kind = np.zeros(n, np.int32)
    attack_scale = np.zeros(n, np.float32)
    order = rng.permutation(n)
    pos = 0
    for kind, frac in spec.attacks:
        cnt = int(round(frac * n))
        slots = order[pos:pos + cnt]
        pos += cnt
        attack_kind[slots] = ATTACK_CODE[kind]
        attack_scale[slots] = spec.attack_scale or DEFAULT_SCALE[kind]
    kinds_present = tuple(kk for kk in ATTACK_KINDS
                          if (attack_kind == ATTACK_CODE[kk]).any())

    part_ix = np.zeros((epochs, k), np.int32)
    filled = np.zeros((epochs, k), bool)
    survive = np.zeros((epochs, k), bool)
    complete = np.zeros((epochs, k), bool)
    adj = np.zeros((epochs, k, k), bool)
    for t in range(epochs):
        avail = rng.random(n) < spec.availability
        av = rng.permutation(np.flatnonzero(avail))
        if av.size >= k:
            ix = av[:k]
            fl = np.ones(k, bool)
        else:                       # vacancy: pad with distinct absentees
            pad = rng.permutation(np.flatnonzero(~avail))[:k - av.size]
            ix = np.concatenate([av, pad])
            fl = np.arange(k) < av.size
        part_ix[t] = ix
        filled[t] = fl
        survive[t] = fl & (rng.random(k) >= spec.dropout)
        complete[t] = rng.random(k) >= spec.straggle
        adj[t] = _cohort_topology(rng, k, spec.avg_peers)

    return CompiledWorld(
        name=spec.name, enrolled=n, sample_k=k, k_min=spec.k_min,
        epochs=epochs, part_ix=part_ix, filled=filled, survive=survive,
        complete=complete, adj=adj, attack_kind=attack_kind,
        attack_scale=attack_scale, kinds_present=kinds_present,
        malicious=attack_kind > 0, spec=spec)
