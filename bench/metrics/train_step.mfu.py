"""The window's model FLOPs (``bench/flops.py``: every pod's step, nothing
recomputed) over the window's wall time at the H100's bf16 peak, in %."""
from bench.roofline import BF16_FLOPS


def read(record):
    w = record["window"]
    if not w.get("model_flops"):
        return None
    return 100.0 * w["model_flops"] / (w["wall_s"] * BF16_FLOPS)
