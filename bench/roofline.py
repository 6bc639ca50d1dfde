"""The yardstick: the H100's published peaks and the least time each
kernel of the port could take at a shape, frozen here so that a change to
the program cannot move it.

Peaks: NVIDIA's H100 SXM data sheet (dense, no sparsity), at the card's
700 W limit. A kernel's bound is the larger of its bytes over the memory
rate (each input read once, each output written once) and its operations
over the rate of the pipe that runs them. The kernels' operations and
bytes are those of ``repro_torch.kernels.cost.pipes`` as it stood when the
benchmark was defined (copied, not imported).
"""
from __future__ import annotations

BF16_FLOPS = 989e12          # bf16 tensor cores, dense
TF32_FLOPS = 495e12          # TF32 tensor cores, dense
FP32_FLOPS = 67e12           # fp32 outside the tensor cores
HBM_BW = 3.35e12             # bytes/s, HBM3
RATE = {"bf16": BF16_FLOPS, "tf32": TF32_FLOPS, "fp32": FP32_FLOPS}


def flash_cost(b, h, s, d, itemsize, causal=True):
    """(ops by pipe, bytes) of one causal self-attention forward: q, k, v
    read and out written once; 4 d flops per visible (q, k) pair."""
    pairs = s * (s + 1) // 2 if causal else s * s
    pipe = "bf16" if itemsize == 2 else "fp32"
    return {pipe: 4 * b * h * pairs * d}, 2 * b * h * 2 * s * d * itemsize


def route_slots_cost(t, e, k, cap, itemsize):
    """Logits read once; gates, indices, slots and the inverse map written
    once; the softmax's 3 and the top-k's k fp32 operations a logit."""
    nbytes = t * e * itemsize + t * k * 8 + t * k * 4 + e * cap * 4
    return {"fp32": t * e * (3 + k)}, nbytes


def ssd_cost(g, h, t, n, p):
    """The SSD intra-chunk term: C, B [G, T, N], acum, dt [G, H, T], x and
    y [G, H, T, P], fp32, read or written once; the products (2N flops a
    causal (q, k) pair for the scores, 2P a pair and head for w . x) as
    three TF32 products each (3xTF32), and 4 fp32 operations a pair and
    head (the exponent and two scalings) on the CUDA cores."""
    pairs = t * (t + 1) // 2
    nbytes = 4 * (2 * g * t * n + 2 * g * h * t + 2 * g * h * t * p)
    products = g * pairs * (2 * n + 2 * p * h)
    return {"tf32": 3 * products, "fp32": g * pairs * h * 4}, nbytes


def bound_s(ops: dict, nbytes: float) -> float:
    """The least time: bytes at the memory rate against each pipe's
    operations at its rate (pipes run side by side)."""
    return max([nbytes / HBM_BW] + [n / RATE[pipe] for pipe, n in ops.items()])
