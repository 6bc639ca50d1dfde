"""What holds a counted step's peak: the dry run's count of one pair
(``repro_torch.launch.dryrun``, on torch's meta device, no card needed),
stopped in thought at the op where a device's live bytes peak: the port's
frames of that op and the live storages then, largest first, by shape,
dtype and place (a model shard, the batch's split, a device).

Usage: PYTHONPATH=src python benchmarks/port_dryrun_peak.py \\
    qwen3-0.6b:train_4k [granite-3-2b:train_4k:2 ...] [--multi-pod]

Each argument is ARCH:SHAPE[:BATCH[:SEQ]] (0 or absent keeps the shape's).
"""
from __future__ import annotations

import collections
import dataclasses
import sys
import traceback

from repro_torch import counting
from repro_torch.config import SHAPES
from repro_torch.launch import dryrun


def peak_of(arch: str, shape: str, batch: int = 0, seq: int = 0,
            multi_pod: bool = False, top: int = 8):
    """(a device's peak GB, the port frames of the op that set it, the
    ``top`` live storage groups then as (GB, shape, dtype, place))."""
    p = dryrun.plan(arch, SHAPES[shape], multi_pod=multi_pod)
    p = dataclasses.replace(p, shape=dataclasses.replace(
        p.shape, global_batch=batch or p.shape.global_batch,
        seq_len=seq or p.shape.seq_len))
    shapes, best = {}, {"gb": 0.0, "frames": [], "live": []}
    real = counting.Counter._track

    def track(self, out, kind=None, pod=None):
        for t in counting._tensors(out):
            try:
                key = t.untyped_storage()._cdata
            except (RuntimeError, NotImplementedError):
                continue
            if key not in self._live:          # a new (or reused) storage
                shapes[key] = (tuple(t.shape), str(t.dtype)[6:])
        real(self, out, kind, pod)
        if self.peak_device_bytes > best["gb"] * 1e9:
            best["gb"] = self.peak_device_bytes / 1e9
            best["frames"] = [f"{f.filename.split('src/')[-1]}:{f.lineno} "
                              f"{f.name}" for f in traceback.extract_stack()
                              if "repro_torch" in f.filename
                              and "counting.py" not in f.filename][-6:]
            live = collections.Counter()
            for key, (n, tag) in self._live.items():
                live[(*shapes.get(key, ((), "?")), str(tag[1]))] += n
            best["live"] = [(n / 1e9, *k) for k, n in live.most_common(top)]
    counting.Counter._track = track
    try:
        dryrun.count_step(p, dryrun.build_state(p))
    finally:
        counting.Counter._track = real
    return best


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    multi = "--multi-pod" in args
    for pair in (a for a in args if a != "--multi-pod"):
        arch, shape, *rest = pair.split(":")
        nums = [int(x) for x in rest] + [0, 0]
        best = peak_of(arch, shape, nums[0], nums[1], multi)
        print(f"{arch} {shape} {'multi' if multi else 'single'}-pod: a "
              f"device's peak {best['gb']:.1f} GB, at")
        for f in best["frames"]:
            print(f"    {f}")
        print("  live then (GB of the whole program, shape, dtype, place):")
        for gb, shp, dt, place in best["live"]:
            print(f"    {gb:10.2f}  {list(shp)} {dt} {place}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
