"""RunLedger: a numpy copy of ``repro.telemetry.ledger`` (a test pins
``as_stats`` equal), the port driver's accounting object.

The ledger records, per driver chunk (a "dispatch" in the reference's
words: one eval chunk of rounds), how many rounds it covered and its
wall-clock seconds; plus, once telemetry is ported, the ``[n_rounds,
...]`` probe frames flushed at each eval boundary. ``as_stats`` gives the
``{"dispatches": n, "epochs": e}`` view the reference's tests use.
"""
from __future__ import annotations

import numpy as np


class RunLedger:
    """Unified run accounting: dispatches, per-superstep wall clock,
    flushed telemetry frames, and an optional JSONL sink.

    Parameters
    ----------
    sink : optional object with a ``write(row: dict)`` method
        (a JSONL sink). When set, the ledger
        streams one ``{"type": "round", ...}`` row per flushed round and
        a final ``{"type": "summary", ...}`` row at ``finish``.
    meta : optional dict
        Run manifest (config/seed/git digest); written to the sink
        immediately as the ``{"type": "manifest", ...}`` header row.
    """

    def __init__(self, sink=None, meta=None):
        self.sink = sink
        self.meta = dict(meta) if meta else None
        self.dispatches = 0
        self.rounds_done = 0
        self.superstep_s: list = []
        self.kind = None            # "epochs" | "ticks", set by finish()
        self.total = 0
        self._frames: dict = {}     # probe name -> list of np chunks
        if self.sink is not None and self.meta is not None:
            self.sink.write({"type": "manifest", **self.meta})

    # -- recording -------------------------------------------------------

    def record_dispatch(self, n_rounds: int, wall_s: float) -> None:
        """One XLA dispatch covering ``n_rounds`` rounds took ``wall_s``."""
        self.dispatches += 1
        self.rounds_done += int(n_rounds)
        self.superstep_s.append(float(wall_s))

    def record_frames(self, frames: dict, start_round: int) -> None:
        """Flush a ``[n, ...]`` frame chunk per probe (the scan ys of one
        superstep, or the trimmed while-carry buffers), stamped as rounds
        ``start_round .. start_round+n-1`` in the JSONL stream."""
        if not frames:
            return
        n = 0
        for name, chunk in frames.items():
            arr = np.asarray(chunk)
            self._frames.setdefault(name, []).append(arr)
            n = arr.shape[0]
        if self.sink is not None:
            names = list(frames)
            for i in range(n):
                row = {"type": "round", "t": int(start_round) + i}
                for name in names:
                    v = np.asarray(frames[name])[i]
                    row[name] = v.tolist() if v.ndim else v.item()
                self.sink.write(row)

    def finish(self, kind: str, total: int) -> None:
        """Close out the run: record the driver's unit ("epochs" or
        "ticks") and total, and write the summary row to the sink."""
        self.kind = kind
        self.total = int(total)
        if self.sink is not None:
            self.sink.write({
                "type": "summary",
                "dispatches": self.dispatches,
                kind: self.total,
                "rounds_recorded": self.rounds_done,
                "wall_s": self.wall_s,
                "superstep_s": [round(s, 6) for s in self.superstep_s],
            })

    # -- views -----------------------------------------------------------

    @property
    def wall_s(self) -> float:
        """Total wall-clock seconds spent inside superstep dispatches."""
        return float(sum(self.superstep_s))

    def names(self):
        return list(self._frames)

    def series(self, name: str):
        """The full ``[rounds, ...]`` series of one probe, or None if the
        run carried no telemetry / no such probe."""
        chunks = self._frames.get(name)
        if not chunks:
            return None
        return np.concatenate(chunks, axis=0)

    def as_stats(self) -> dict:
        """Deprecated view: the exact legacy ``stats`` dict both drivers
        used to fill — ``{"dispatches": n, "epochs": e}`` or
        ``{"dispatches": n, "ticks": t}``. Kept key-for-key because
        existing tests assert dict equality on it."""
        out = {"dispatches": self.dispatches}
        if self.kind is not None:
            out[self.kind] = self.total
        return out
