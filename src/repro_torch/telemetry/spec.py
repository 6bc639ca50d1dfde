"""MetricSpec registry: the device-side half of the telemetry plane (port
of ``repro.telemetry.spec``).

A probe is DECLARED when a round is built (``MetricSpec``) and EMITTED by
its stages (``Telemetry.emit``) into the round context; the round collects
the declared frame (``Telemetry.collect``) and returns it beside the next
state. The drivers write each round's frame into preallocated ``[chunk,
...]`` buffers on the device (``Telemetry.zero_buffers``), copy them to
pinned host memory once a chunk, before the chunk's synchronize, and hand
them to the ``RunLedger`` (``gather_frames``).

The contract is the reference's:

* gated at build time: a round built with ``telemetry=None`` runs no
  probe operation at all;
* read-only: probes read values the stages already computed (plus
  reductions of them); they never write a context key a stage consumes and
  never ask the draw provider for anything;
* declared == emitted: ``collect`` raises if a declared probe was never
  emitted, so the registry and the stage bodies cannot drift.

The spec sets (``defta_specs`` / ``fedavg_specs`` / ``cross_device_specs``
/ ``tick_specs``) are the reference's field for field: names, stages,
shapes, dtypes, docs and declaration order.

A Python-loop driver launches every probe's reduction and buffer write as
kernels of their own, so the reference's "zero extra dispatches" has no
counterpart here. What the port keeps instead: no probe reads a device
value back to the host, and a round with probes on takes the same draws
and leaves the same state as one with probes off.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

TORCH_DTYPES = {"int32": torch.int32, "float32": torch.float32,
                "bool": torch.bool}


@dataclass(frozen=True)
class MetricSpec:
    """One named probe: per-round shape/dtype (NO leading time axis — the
    driver's buffer adds it) plus the stage that emits it, for docs and
    panels."""
    name: str
    stage: str
    shape: Tuple[int, ...]
    dtype: str
    doc: str = ""

    @property
    def nbytes(self) -> int:
        """Per-round buffer bytes of this probe."""
        return int(np.prod(self.shape, dtype=np.int64) *
                   np.dtype(self.dtype).itemsize) if self.shape \
            else np.dtype(self.dtype).itemsize


def frame_bytes(specs) -> int:
    """Per-round bytes of one telemetry frame over ``specs``."""
    return sum(s.nbytes for s in specs)


def gather_frames(frames: Dict[str, object]) -> Dict[str, np.ndarray]:
    """A dict of ``[n, ...]`` probe buffers as plain numpy: one
    ``.cpu().numpy()`` per probe (the drivers pass buffers already staged
    in host memory, so on the card this reads back nothing); numpy values
    pass through."""
    return {k: v.cpu().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v) for k, v in frames.items()}


class Telemetry:
    """The build-time probe registry and the stages' emission surface.

    One Telemetry object per BUILT round: the engine builder declares the
    probes its stages will emit, stages call ``emit`` (inside ``if
    telemetry is not None`` blocks: the None path runs nothing), and the
    round returns ``collect(ctx)`` beside the next state. ``zero_frame`` is
    the all-zeros frame of the declared set (the reference's fire-gated
    tick returns it from a dead padding tick; the port's driver never runs
    one).
    """

    def __init__(self, specs=()):
        self.specs: Tuple[MetricSpec, ...] = ()
        self._by_name = {}
        if specs:
            self.declare(*specs)

    def declare(self, *specs: MetricSpec) -> "Telemetry":
        for s in specs:
            prev = self._by_name.get(s.name)
            if prev is not None:
                if prev != s:
                    raise ValueError(
                        f"probe {s.name!r} already declared with a "
                        f"different spec ({prev} vs {s}) — one Telemetry "
                        f"object per built round")
                continue                    # identical redeclare: no-op
            self._by_name[s.name] = s
            self.specs = self.specs + (s,)
        return self

    def __contains__(self, name: str) -> bool:
        return name in self._by_name

    def __len__(self) -> int:
        return len(self.specs)

    def spec(self, name: str) -> MetricSpec:
        return self._by_name[name]

    def emit(self, ctx: dict, name: str, value) -> None:
        """Record ``value`` for probe ``name`` in the round context, cast
        to the declared dtype and checked against the declared shape. A
        tensor stays on its device (nothing is read back); a host number
        (the round stamp) becomes a host tensor."""
        s = self._by_name.get(name)
        if s is None:
            raise KeyError(f"probe {name!r} was never declared "
                           f"(declared: {sorted(self._by_name)})")
        dtype = TORCH_DTYPES[s.dtype]
        v = value.to(dtype) if isinstance(value, torch.Tensor) \
            else torch.tensor(value, dtype=dtype)
        if tuple(v.shape) != tuple(s.shape):
            raise ValueError(f"probe {name!r}: emitted shape "
                             f"{tuple(v.shape)} != declared {s.shape}")
        ctx.setdefault("_tm", {})[name] = v

    def collect(self, ctx: dict, specs=None) -> dict:
        """The round's frame: every declared probe, in declaration order.
        Raises if a stage forgot to emit one. ``specs``: an explicit
        snapshot to collect (a builder that declared its set BEFORE a
        wrapper added more — the async tick's ``fired`` — collects only
        its own)."""
        specs = self.specs if specs is None else specs
        got = ctx.get("_tm", {})
        missing = [s.name for s in specs if s.name not in got]
        if missing:
            raise RuntimeError(f"declared probes never emitted: {missing}")
        return {s.name: got[s.name] for s in specs}

    def zero_frame(self, device=None) -> dict:
        return {s.name: torch.zeros(s.shape, dtype=TORCH_DTYPES[s.dtype],
                                    device=device) for s in self.specs}

    def zero_buffers(self, window: int, device=None) -> dict:
        """Preallocated ``[window, ...]`` buffers, one per probe: a driver
        chunk's frames are written into them on the device."""
        return {s.name: torch.zeros((window,) + tuple(s.shape),
                                    dtype=TORCH_DTYPES[s.dtype],
                                    device=device)
                for s in self.specs}

    def frame_bytes(self) -> int:
        return frame_bytes(self.specs)

    def buffer_bytes(self, window: int) -> int:
        """Device bytes of a ``window``-round telemetry buffer."""
        return self.frame_bytes() * int(window)


# ---------------------------------------------------------------------------
# Wire-byte pricing (the realized-bytes probe)
# ---------------------------------------------------------------------------

def wire_payload_bytes(n_params: int, wire, rows: int = 1) -> float:
    """One serialized model payload priced by the gossip wire format (int8
    adds one fp32 scale per quantization row), from the port's
    ``core.gossip.WIRE_BYTES`` table (imported here, as in the reference:
    ``core`` imports this module)."""
    from repro_torch.core.gossip import WIRE_BYTES, normalize_wire
    per = WIRE_BYTES[normalize_wire(wire)]
    b = n_params * per
    if per == 1:
        b += 4 * rows
    return float(b)


def stacked_payload_bytes(stacked, wire) -> float:
    """Payload bytes of ONE worker's model from a stacked [W, ...] dict of
    tensors (leading axis stripped); shapes only, no device read."""
    leaves = list(stacked.values())
    n_params = sum(int(np.prod(tuple(l.shape[1:]), dtype=np.int64))
                   for l in leaves)
    return wire_payload_bytes(n_params, wire, rows=len(leaves))


def tree_payload_bytes(tree, wire) -> float:
    """Payload bytes of one UN-stacked model dict (the FedAvg server)."""
    leaves = list(tree.values())
    n_params = sum(int(np.prod(tuple(l.shape), dtype=np.int64))
                   for l in leaves)
    return wire_payload_bytes(n_params, wire, rows=len(leaves))


# ---------------------------------------------------------------------------
# Spec sets per round program
# ---------------------------------------------------------------------------

def defta_specs(w: int, *, scenario: bool = False,
                use_ef: bool = False) -> Tuple[MetricSpec, ...]:
    """The sync/async DeFTA round's probes."""
    specs = [
        MetricSpec("round", "scenario_view", (), "int32",
                   "global round (epoch/tick) index"),
        MetricSpec("theta_in", "peer_sample", (w,), "float32",
                   "mean DTS sampling weight each worker RECEIVES"),
        MetricSpec("edges", "transport", (), "int32",
                   "realized gossip edges this round (sampled ∧ live)"),
        MetricSpec("wire_bytes", "transport", (), "float32",
                   "realized wire bytes = edges × payload(wire format)"),
        MetricSpec("loss_agg", "damage_check", (w,), "float32",
                   "each worker's self-evaluation of the aggregate"),
        MetricSpec("damaged", "damage_check", (w,), "bool",
                   "time-machine trigger mask"),
        MetricSpec("train_loss", "local_train", (w,), "float32",
                   "mean local-SGD loss per worker"),
        MetricSpec("loss_trust", "trust_update", (w,), "float32",
                   "the loss-delta trust signal (damage penalty applied)"),
        MetricSpec("conf_in", "trust_update", (w,), "float32",
                   "mean confidence each worker is HELD in by peers"),
        MetricSpec("update_norm", "trust_update", (w,), "float32",
                   "‖trained − start‖ per worker (the scored delta)"),
    ]
    if use_ef:
        specs.append(MetricSpec("ef_norm", "transport", (w,), "float32",
                                "‖EF21 residual‖ per worker"))
    if scenario:
        specs.append(MetricSpec("alive", "scenario_view", (w,), "bool",
                                "churn liveness mask"))
        specs.append(MetricSpec("fire", "scenario_view", (w,), "bool",
                                "round-completion mask (stragglers drop)"))
    return tuple(specs)


def tick_specs(w: int) -> Tuple[MetricSpec, ...]:
    """The async fire-gated tick adds one probe on top of the wrapped
    round's set."""
    return (MetricSpec("fired", "tick", (w,), "bool",
                       "speed-sampled completion mask this tick"),)


def fedavg_specs(w: int) -> Tuple[MetricSpec, ...]:
    """The FedAvg star round's probes."""
    return (
        MetricSpec("round", "star_broadcast", (), "int32",
                   "global round index"),
        MetricSpec("train_loss", "local_train", (w,), "float32",
                   "mean local-SGD loss per worker"),
        MetricSpec("wire_bytes", "star_aggregate", (), "float32",
                   "star wire bytes: W broadcasts down + cohort up"),
    )


def cross_device_specs(k: int, *, use_ef: bool = False
                       ) -> Tuple[MetricSpec, ...]:
    """The cross-device participation round's probes (cohort width k)."""
    specs = [
        MetricSpec("round", "participation", (), "int32",
                   "global round index"),
        MetricSpec("cohort", "participation", (k,), "int32",
                   "enrolled-population indices of this round's cohort"),
        MetricSpec("occupancy", "participation", (), "int32",
                   "cohort slots filled ∧ surviving (vacancy/dropout out)"),
        MetricSpec("dropout_count", "participation", (), "int32",
                   "filled slots that departed mid-round"),
        MetricSpec("straggler_count", "participation", (), "int32",
                   "surviving slots that timed out (no merge)"),
        MetricSpec("fire", "participation", (k,), "bool",
                   "slots whose state scatters back this round"),
        MetricSpec("scatter_writes", "participation", (), "int32",
                   "fire-gated population rows written per buffer"),
        MetricSpec("edges", "transport", (), "int32",
                   "realized cohort gossip edges"),
        MetricSpec("wire_bytes", "transport", (), "float32",
                   "realized cohort wire bytes"),
        MetricSpec("loss_agg", "damage_check", (k,), "float32",
                   "cohort self-evaluation of the aggregate"),
        MetricSpec("train_loss", "local_train", (k,), "float32",
                   "mean local-SGD loss per cohort slot"),
        MetricSpec("loss_trust", "trust_update", (k,), "float32",
                   "the loss-delta trust signal on the cohort block"),
        MetricSpec("conf_in", "trust_update", (k,), "float32",
                   "mean confidence each cohort slot is held in"),
        MetricSpec("update_norm", "trust_update", (k,), "float32",
                   "‖trained − start‖ per cohort slot"),
    ]
    if use_ef:
        specs.append(MetricSpec("ef_norm", "transport", (k,), "float32",
                                "‖EF21 residual‖ per cohort slot"))
    return tuple(specs)
