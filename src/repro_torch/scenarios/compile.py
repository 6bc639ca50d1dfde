"""Compile a ``ScenarioSpec`` to per-epoch mask and parameter tensors (the
port of ``repro.scenarios.compile``).

``compile_scenario`` evaluates the whole event timeline once on the host
(numpy, line for line the reference's) and puts the arrays the round
indexes on an explicit device, so a scenario is data, not control flow:
the round reads its epoch's state with ``epoch_view`` and launches the
same kernels as a static run.

Layout
------
Topology-shaped state (who is alive, which links are up) changes at event
boundaries only, so it is segment-compressed: ``seg_of_epoch [E] int32``
maps an epoch to one of S distinct segments, with ``alive [S, W]`` and
``link_ok [S, W, W]``. Per-epoch state that is cheap or genuinely
per-epoch (straggler fire schedule, intermittent attack on/off) stays
``[E, W]``. Per-worker attack parameters are ``[W]``.

``epoch_view`` clamps indices past the compiled horizon to the last epoch
as a safety net, but the engines' ``resolve_scenario`` requires the
horizon to cover the run: topology state persists fine under the clamp,
yet the per-epoch fire/attack_on schedules would freeze at one arbitrary
final-epoch draw (a straggler stuck never firing), so a precompiled
scenario shorter than the run is rejected rather than silently replayed.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np

import torch

from repro_torch.device import resolve_device
from repro_torch.scenarios.spec import ATTACK_KINDS, ScenarioSpec

# attack-kind integer codes (0 = honest); order is ATTACK_KINDS
ATTACK_CODE = {k: i + 1 for i, k in enumerate(ATTACK_KINDS)}

# default magnitudes per kind (scale=0 in the spec picks these; the noise
# default matches the engines' historical noise_scale=200; sign_flip 1.0
# is the textbook inverted-update attack)
DEFAULT_SCALE = {"noise": 200.0, "sign_flip": 1.0, "scaling": 10.0,
                 "alie": 1.5, "label_flip": 1.0,
                 # adaptive attacks: dts_dodge's scale multiplies the
                 # norm cap (1.0 = exactly the observed median update
                 # norm × DODGE_MARGIN); theta_aware's scale is the
                 # underlying sign_flip magnitude while active;
                 # alie_decor's scale is the underlying alie z-shift (its
                 # decorrelation noise is DECOR_FRAC of the stack std)
                 "dts_dodge": 1.0, "theta_aware": 1.0, "alie_decor": 1.5}


_TENSORS = ("seg_of_epoch", "alive", "link_ok", "fire", "attack_on",
            "attack_kind", "attack_scale", "adj_seg")


def _check_worker(idx: int, w: int, what: str) -> int:
    if not 0 <= idx < w:
        raise ValueError(f"{what} targets worker {idx} but W={w} "
                         f"(negative indices are not allowed)")
    return idx


def _window(start: int, stop: int, epochs: int) -> np.ndarray:
    """[E] bool for the half-open window [start, stop or end)."""
    e = np.arange(epochs)
    on = e >= start
    if stop:
        on &= e < stop
    return on


@dataclass
class CompiledScenario:
    spec: ScenarioSpec
    num_vanilla: int
    num_workers: int            # W = vanilla + appended attackers
    epochs: int                 # compiled horizon E
    # -- device arrays (torch, on the compiled device) ------------------
    seg_of_epoch: Any           # [E] int32
    alive: Any                  # [S, W] bool
    link_ok: Any                # [S, W, W] bool (i receives from j)
    fire: Any                   # [E, W] bool (straggler schedule ∧ alive)
    attack_on: Any              # [E, W] bool
    attack_kind: Any            # [W] int32 (ATTACK_CODE, 0 = honest)
    attack_scale: Any           # [W] f32
    # -- host-side metadata --------------------------------------------
    kinds_present: Tuple[str, ...]
    malicious: np.ndarray       # [W] bool (attack_kind > 0)
    alive_np: np.ndarray        # [S, W] host copy for summaries
    link_ok_np: np.ndarray      # [S, W, W]
    seg_of_epoch_np: np.ndarray
    # -- time-varying topology (spec.topology; None = mask-only) -------
    adj_seg: Any = None         # [S, W, W] bool — per-segment regenerated
                                # adjacency (rekeyed topology draw)
    adj_union: Optional[np.ndarray] = None
                                # [W, W] support union over segments — the
                                # static padded-CSR support the sparse
                                # backend memoizes on
    adj_seg_np: Optional[np.ndarray] = None

    @property
    def num_segments(self) -> int:
        return self.alive_np.shape[0]

    def summary(self, adj: Optional[np.ndarray] = None) -> dict:
        """Human/JSON-facing digest (the reference's): per-segment alive
        counts and (with the static topology) the fraction of its edges
        still up — the scenario cost delta (wire bytes scale with live
        edges). Reads ``attack_kind`` back once."""
        segs = []
        e_of_seg = [np.flatnonzero(self.seg_of_epoch_np == s)
                    for s in range(self.num_segments)]
        for s in range(self.num_segments):
            d = {"epochs": [int(e_of_seg[s][0]), int(e_of_seg[s][-1]) + 1],
                 "alive": int(self.alive_np[s].sum())}
            if adj is not None:
                a = np.asarray(adj, bool)
                # under a time-varying topology the segment's own drawn
                # adjacency carries the edges; the fraction stays
                # normalized by the STATIC graph so it remains the
                # wire-byte multiplier vs the static run
                seg_a = self.adj_seg_np[s] if self.adj_seg_np is not None \
                    else a
                eff = seg_a & self.link_ok_np[s] \
                    & self.alive_np[s][None, :] & self.alive_np[s][:, None]
                d["edge_fraction"] = round(
                    float(eff.sum()) / max(int(a.sum()), 1), 4)
            segs.append(d)
        kinds = self.attack_kind.cpu().numpy()
        out = {
            "name": self.spec.name,
            "workers": self.num_workers,
            "vanilla": self.num_vanilla,
            "epochs": self.epochs,
            "events": self.spec.event_count(),
            "segments": segs,
            "attacks": {k: int((kinds == ATTACK_CODE[k]).sum())
                        for k in self.kinds_present},
            "stragglers": len(self.spec.stragglers),
        }
        if adj is not None:
            # mean live-edge fraction over the timeline = the wire-byte
            # multiplier vs the static run (each live edge ships one model)
            fracs = [segs[self.seg_of_epoch_np[e]]["edge_fraction"]
                     for e in range(self.epochs)]
            out["mean_edge_fraction"] = round(float(np.mean(fracs)), 4)
        return out


def compile_scenario(spec: ScenarioSpec, num_vanilla: int, epochs: int,
                     device=None) -> CompiledScenario:
    """Evaluate the event timeline over ``epochs`` global epochs; the
    arrays the round reads are tensors on ``device`` (``None``: the card,
    as ``device.resolve_device`` rules)."""
    if epochs <= 0:
        raise ValueError("scenario horizon must be >= 1 epoch")
    w = num_vanilla + spec.num_appended_attackers()

    # ---- attacker slots ----------------------------------------------
    attack_kind = np.zeros(w, np.int32)
    attack_scale = np.zeros(w, np.float32)
    attack_on = np.zeros((epochs, w), bool)
    next_slot = num_vanilla
    for a in spec.attacks:
        slot = a.worker if a.worker >= 0 else next_slot
        if a.worker < 0:
            next_slot += 1
        if slot >= w:
            raise ValueError(f"attack targets worker {slot} but W={w}")
        if attack_kind[slot]:
            raise ValueError(f"worker {slot} already has an attack")
        attack_kind[slot] = ATTACK_CODE[a.kind]
        attack_scale[slot] = a.scale or DEFAULT_SCALE[a.kind]
        on = _window(a.start, a.stop, epochs)
        if a.period:
            duty = a.duty or a.period // 2
            on &= (np.arange(epochs) - a.start) % a.period < duty
        attack_on[:, slot] = on

    # ---- churn: alive timeline ---------------------------------------
    alive_e = np.ones((epochs, w), bool)
    churned = set()
    for c in spec.churn:
        _check_worker(c.worker, w, "churn")
        if c.worker in churned:
            # assignment is wholesale — a second entry would silently
            # discard the first; one ChurnSpec(join=, leave=) expresses
            # any single join/leave window
            raise ValueError(f"worker {c.worker} has multiple ChurnSpecs")
        churned.add(c.worker)
        alive_e[:, c.worker] = _window(c.join, c.leave, epochs)

    # ---- links + partitions: link_ok timeline ------------------------
    link_ok_e = np.ones((epochs, w, w), bool)
    for l in spec.links:
        _check_worker(l.src, w, "link src")
        _check_worker(l.dst, w, "link dst")
        link_ok_e[_window(l.start, l.stop, epochs), l.dst, l.src] = False
    for p in spec.partitions:
        group_of = {}
        for gi, g in enumerate(p.groups):
            for wk in g:
                group_of[_check_worker(wk, w, "partition")] = gi
        cross = np.zeros((w, w), bool)
        for i in range(w):
            for j in range(w):
                gi, gj = group_of.get(i), group_of.get(j)
                if gi is not None and gj is not None and gi != gj:
                    cross[i, j] = True
        link_ok_e[_window(p.start, p.stop, epochs)] &= ~cross

    # ---- segment-compress the topology state -------------------------
    # (a TopologySpec's ``every`` forces extra boundaries: epochs in
    # different re-draw windows must land in different segments even when
    # their alive/link state is identical)
    every = spec.topology.every if spec.topology else 0
    keys = [alive_e[e].tobytes() + link_ok_e[e].tobytes()
            + ((e // every).to_bytes(4, "little") if every else b"")
            for e in range(epochs)]
    seg_of_epoch = np.zeros(epochs, np.int32)
    seg_index: dict = {}
    for e, k in enumerate(keys):
        if k not in seg_index:
            seg_index[k] = len(seg_index)
        seg_of_epoch[e] = seg_index[k]
    firsts = {}
    for e in range(epochs):
        firsts.setdefault(int(seg_of_epoch[e]), e)
    order = [firsts[s] for s in range(len(seg_index))]
    alive = alive_e[order]
    link_ok = link_ok_e[order]

    # ---- time-varying topology: rekeyed draw per segment -------------
    adj_seg = adj_union = None
    if spec.topology is not None:
        from repro_torch.core.topology import make_topology
        t = spec.topology
        adj_seg = np.stack([
            make_topology(t.kind, w, t.avg_peers,
                          seed=spec.seed + 7919 * (s + 1))
            for s in range(len(order))])
        # support union: the ONE static padded-CSR support covering every
        # segment (sparse_support memoizes on its bytes — no per-epoch
        # cache churn)
        adj_union = adj_seg.any(axis=0)

    # ---- straggler fire schedule (deterministic from seed) -----------
    fire = np.ones((epochs, w), bool)
    rng = np.random.default_rng(spec.seed + 1234)
    slowed = set()
    for s in spec.stragglers:
        _check_worker(s.worker, w, "straggler")
        if s.worker in slowed:
            raise ValueError(f"worker {s.worker} has multiple "
                             f"StragglerSpecs")
        slowed.add(s.worker)
        if not 0.0 < s.speed <= 1.0:
            raise ValueError(f"straggler speed must be in (0, 1]: {s.speed}")
        window = _window(s.start, s.stop, epochs)
        slow = rng.random(epochs) < s.speed
        fire[:, s.worker] = np.where(window, slow, True)
    fire &= alive_e
    attack_on &= alive_e          # dead attackers don't attack

    kinds_present = tuple(k for k in ATTACK_KINDS
                          if (attack_kind == ATTACK_CODE[k]).any())
    dev = resolve_device(device)
    t = lambda a: torch.as_tensor(a).to(dev)
    return CompiledScenario(
        spec=spec, num_vanilla=num_vanilla, num_workers=w, epochs=epochs,
        seg_of_epoch=t(seg_of_epoch),
        alive=t(alive),
        link_ok=t(link_ok),
        fire=t(fire),
        attack_on=t(attack_on),
        attack_kind=t(attack_kind),
        attack_scale=t(attack_scale),
        kinds_present=kinds_present,
        malicious=attack_kind > 0,
        alive_np=alive, link_ok_np=link_ok, seg_of_epoch_np=seg_of_epoch,
        adj_seg=t(adj_seg) if adj_seg is not None else None,
        adj_union=adj_union, adj_seg_np=adj_seg,
    )


def to_device(compiled: CompiledScenario, device) -> CompiledScenario:
    """The same compiled scenario with its tensors on ``device``."""
    dev = torch.device(device)
    moved = {f: getattr(compiled, f).to(dev) for f in _TENSORS
             if getattr(compiled, f) is not None}
    return dataclasses.replace(compiled, **moved)


def epoch_view(compiled: CompiledScenario, epoch: int):
    """One epoch's scenario state, looked up from the driver's Python-int
    epoch (clamped to the horizon). Returns a dict of tensors: alive [W],
    link_ok [W, W], fire [W], attack_on [W], adj [W, W] or None."""
    e = min(max(int(epoch), 0), compiled.epochs - 1)
    seg = int(compiled.seg_of_epoch_np[e])
    return {
        "alive": compiled.alive[seg],
        "link_ok": compiled.link_ok[seg],
        "fire": compiled.fire[e],
        "attack_on": compiled.attack_on[e],
        # time-varying topology: the segment's regenerated adjacency
        # (None when the spec only masks a build-time graph)
        "adj": compiled.adj_seg[seg]
        if compiled.adj_seg is not None else None,
    }
