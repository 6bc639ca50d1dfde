"""Declarative scenario grammar for the adversarial scenario engine.

A ``ScenarioSpec`` is a *typed event timeline* over global epochs: worker
churn (join/leave), link failures, network partitions, straggler
slowdowns, and an attack zoo. It is pure data (frozen dataclasses,
hashable) — ``scenarios.compile.compile_scenario`` turns it into
device-side per-epoch mask/param arrays ONCE, so the engines replay
arbitrary scenarios inside their existing ``lax.scan`` supersteps with
zero host round-trips.

Grammar
-------
::

    ScenarioSpec(
      attacks=(                       # each spawns / targets one attacker
        AttackSpec("sign_flip", scale=2.0),            # appended worker
        AttackSpec("noise", worker=3, start=5),        # corrupt worker 3
        AttackSpec("alie", period=8, duty=4),          # intermittent
      ),
      churn=(ChurnSpec(worker=1, leave=10),            # leaves at epoch 10
             ChurnSpec(worker=6, join=4)),             # dark until epoch 4
      links=(LinkSpec(src=2, dst=0, start=3, stop=8),),# 2->0 down in [3,8)
      partitions=(PartitionSpec(groups=((0, 1, 2), (3, 4, 5)),
                                start=6, stop=12),),   # no cross-group links
      stragglers=(StragglerSpec(worker=4, speed=0.25),),
      seed=0,
    )

Epoch windows are half-open ``[start, stop)``; ``stop=0`` means "until the
end of the run". Attacks with ``worker=-1`` (default) append a NEW
malicious worker after the vanilla ones (the paper's §4.3 setting: normal
workers fixed, attackers newly joined); ``worker>=0`` corrupts an existing
slot. ``period>0`` makes an attack intermittent: on for ``duty`` epochs
(default period/2) out of every ``period``, within its [start, stop)
window.

Attack zoo (see ``scenarios.attacks`` for the transforms):

* ``noise``      — aggregate + scale·N(0,1)   (the paper's attack model)
* ``sign_flip``  — agg − scale·(trained − agg): inverted local update
* ``scaling``    — agg + scale·(trained − agg): boosted / model-replacement
* ``alie``       — collusion, "a little is enough"-lite: all colluders send
                   the identical mean − scale·std of the worker stack
* ``label_flip`` — data poisoning: trains honestly on labels y → C−1−y

Adaptive attacks (observe the defense, then dodge it):

* ``dts_dodge``   — norm-capped inverted update: ships the sign-flipped
                    update RESCALED to stay just under the population's
                    median update norm — the detection margin a norm-ratio
                    detector calibrates on (geometry still sees direction)
* ``theta_aware`` — attacks only while its observed DTS sampling weight θ
                    is above a floor; lies low (honest sends) once victims
                    stop trusting it, so loss-trust never builds a stable
                    negative trend
* ``alie_decor``  — alie colluders that add per-attacker decorrelation
                    noise to their shared payload, trading attack
                    coherence for a lower cross-round correlation
                    signature (the counter-attack to the DTS v3
                    correlation-clustering signal)

Stragglers advance only a ``speed`` fraction of epochs (a deterministic
schedule drawn from ``seed`` at compile time — device-side it is just a
[E, W] fire mask). Dead/not-yet-joined workers are removed from the
topology (nobody receives from them, they receive from nobody, their state
is frozen); their slots stay in the stacked arrays so shapes are static.

Time-varying topologies: ``topology=TopologySpec(kind, avg_peers)`` makes
the compiler REGENERATE the adjacency per topology segment (a rekeyed
``core.topology`` draw per distinct churn/link segment) instead of only
masking a build-time one — peers genuinely change over the run. The
compiled scenario carries the per-segment adjacencies plus their support
UNION, which is what the padded-CSR sparse backend keys its
``sparse_support`` memo on (one static entry for the whole run).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

# Order is load-bearing: ATTACK_CODE (scenarios.compile) assigns integer
# codes by position, and compiled scenarios store those codes in device
# arrays — only ever APPEND new kinds.
ATTACK_KINDS = ("noise", "sign_flip", "scaling", "alie", "label_flip",
                "dts_dodge", "theta_aware", "alie_decor")


@dataclass(frozen=True)
class AttackSpec:
    """One attacker. ``worker=-1`` appends a new malicious worker."""
    kind: str
    scale: float = 0.0          # 0 -> the kind's default magnitude
    worker: int = -1
    start: int = 0
    stop: int = 0               # 0 = until the end
    period: int = 0             # >0: intermittent on/off cycling
    duty: int = 0               # epochs on per period (default period//2)

    def __post_init__(self):
        if self.kind not in ATTACK_KINDS:
            raise ValueError(f"unknown attack kind {self.kind!r} "
                             f"(one of {ATTACK_KINDS})")


@dataclass(frozen=True)
class ChurnSpec:
    """Worker joins at ``join`` and/or leaves at ``leave`` (0 = never)."""
    worker: int
    join: int = 0
    leave: int = 0


@dataclass(frozen=True)
class LinkSpec:
    """Directed link ``src -> dst`` (dst receives from src) down in
    ``[start, stop)``."""
    src: int
    dst: int
    start: int
    stop: int = 0


@dataclass(frozen=True)
class PartitionSpec:
    """Network partition in ``[start, stop)``: links between different
    groups are down. Workers not listed keep all their links."""
    groups: Tuple[Tuple[int, ...], ...]
    start: int
    stop: int = 0


@dataclass(frozen=True)
class StragglerSpec:
    """Worker completes only ~``speed`` of its rounds in [start, stop)."""
    worker: int
    speed: float
    start: int = 0
    stop: int = 0


_TOPOLOGY_KINDS = ("ring", "random_kout", "erdos", "dense")


@dataclass(frozen=True)
class TopologySpec:
    """Time-varying topology: regenerate the adjacency from a rekeyed
    ``core.topology`` draw at every topology segment boundary (each
    distinct churn/link/partition segment gets its own draw) instead of
    masking one build-time graph. ``every>1`` additionally forces a
    re-draw every that-many epochs even without an event boundary."""
    kind: str = "random_kout"
    avg_peers: int = 4
    every: int = 0               # >0: extra segment boundary every N epochs

    def __post_init__(self):
        if self.kind not in _TOPOLOGY_KINDS:
            raise ValueError(f"unknown topology kind {self.kind!r} "
                             f"(one of {_TOPOLOGY_KINDS})")


@dataclass(frozen=True)
class ScenarioSpec:
    name: str = "scenario"
    attacks: Tuple[AttackSpec, ...] = ()
    churn: Tuple[ChurnSpec, ...] = ()
    links: Tuple[LinkSpec, ...] = ()
    partitions: Tuple[PartitionSpec, ...] = ()
    stragglers: Tuple[StragglerSpec, ...] = ()
    topology: "TopologySpec | None" = None
    seed: int = 0

    def num_appended_attackers(self) -> int:
        return sum(1 for a in self.attacks if a.worker < 0)

    def event_count(self) -> int:
        return (len(self.attacks) + len(self.churn) + len(self.links)
                + len(self.partitions) + len(self.stragglers))


# ---------------------------------------------------------------------------
# Named presets (the --scenario registry)
# ---------------------------------------------------------------------------

def _paper_noise(k: int):
    return ScenarioSpec(name=f"paper_noise_{k}",
                        attacks=tuple(AttackSpec("noise")
                                      for _ in range(k)))


def _churn_signflip(num_vanilla: int):
    """The CI smoke: 2 sign-flippers + churn (one worker leaves mid-run,
    one joins late) — two simultaneous event classes. With a single
    vanilla worker there is no second slot to churn, so only the leave
    event applies (one worker can't both leave and join-late)."""
    churn = (ChurnSpec(worker=0, leave=6),)
    if num_vanilla >= 2:
        churn += (ChurnSpec(worker=1, join=3),)
    return ScenarioSpec(
        name="churn_signflip",
        attacks=(AttackSpec("sign_flip"), AttackSpec("sign_flip")),
        churn=churn,
    )


def _storm(num_vanilla: int):
    """Everything at once: churn + partition + straggler + mixed attacks
    (one intermittent) — the "as many scenarios as you can imagine" demo."""
    half = tuple(range(num_vanilla // 2))
    rest = tuple(range(num_vanilla // 2, num_vanilla))
    return ScenarioSpec(
        name="storm",
        attacks=(AttackSpec("sign_flip"),
                 AttackSpec("alie"),
                 AttackSpec("noise", period=6, duty=3)),
        churn=(ChurnSpec(worker=0, leave=8),),
        partitions=(PartitionSpec(groups=(half, rest), start=4, stop=8),),
        stragglers=(StragglerSpec(worker=1, speed=0.5),),
    )


def get_scenario(name: str, num_vanilla: int) -> ScenarioSpec:
    """Resolve a --scenario name. ``paper_noise@K`` takes an attacker
    count (e.g. ``paper_noise@40`` is the paper's 66%-malicious row)."""
    if name == "paper_noise" or name.startswith("paper_noise@"):
        # exact spelling only: a loose prefix match would quietly turn a
        # typo like "paper_noise_40" into the 1-attacker default
        k = int(name.split("@", 1)[1]) if "@" in name else 1
        return _paper_noise(k)
    if name == "churn_signflip":
        return _churn_signflip(num_vanilla)
    if name == "storm":
        return _storm(num_vanilla)
    raise ValueError(f"unknown scenario {name!r} (one of: paper_noise[@K], "
                     f"churn_signflip, storm)")
