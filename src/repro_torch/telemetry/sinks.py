"""Host-side telemetry sinks: JSONL event log + run manifest.

The JSONL layout is line-delimited and append-only so a crashed run
still leaves a readable prefix: first row ``{"type": "manifest", ...}``
(git digest, seed, config, argv), then one ``{"type": "round", ...}``
row per flushed round, then ``{"type": "summary", ...}``. The dashboard
renderer (``benchmarks/render_experiments.py --telemetry-panel``) reads
this format back.
"""
from __future__ import annotations

import json
import subprocess
import time

import numpy as np


def _jsonable(obj):
    """json.dumps default= hook: numpy scalars/arrays → python."""
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, (set, tuple)):
        return list(obj)
    return str(obj)


class JsonlSink:
    """Line-delimited JSON writer with per-row flush (crash-readable)."""

    def __init__(self, path):
        self.path = str(path)
        self._fh = open(self.path, "w")

    def write(self, row: dict) -> None:
        self._fh.write(json.dumps(row, default=_jsonable) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def git_digest() -> str:
    """Short commit digest of the working tree, or "unknown" outside a
    repo — never raises (telemetry must not take a run down)."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=5, check=False)
        d = out.stdout.strip()
        return d if d else "unknown"
    except Exception:
        return "unknown"


def run_manifest(*, config=None, seed=None, argv=None, extra=None) -> dict:
    """The reproducibility header row: enough to re-run this exact run."""
    m = {"git": git_digest(), "time": time.time()}
    if seed is not None:
        m["seed"] = int(seed)
    if argv is not None:
        m["argv"] = list(argv)
    if config is not None:
        m["config"] = json.loads(json.dumps(config, default=_jsonable))
    if extra:
        m.update(extra)
    return m
