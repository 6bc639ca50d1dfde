"""The port's kernels' costs: the operations and the bytes of one launch
of each kernel at a shape. ``kernel_cost`` is what the counting pass
(``repro_torch.counting``) records for each call of a wrapper in
``kernels.ops``; ``launch.roofline`` builds the bound columns of
``chip_smoke.py`` and PERF.md's kernel table from ``pipes``.
"""
from __future__ import annotations


def pipes(name: str, **kw):
    """(operations by pipe {"fp32" | "tf32" | "bf16": count}, bytes) of one
    launch of kernel ``name``: each input read once and each output
    written once; the operations at the pipe that runs them."""
    if name in ("gossip_mix", "gossip_mix_sparse", "gossip_mix_quant"):
        w, f, in_bytes = kw["w"], kw["f"], kw["in_bytes"]
        if name == "gossip_mix":
            nbytes = w * f * in_bytes + w * f * 4 + w * w * 4
            flops = 2 * w * w * f
            if kw.get("tensor_cores"):
                # 3xTF32 products for an f32 payload, two for bf16 / int8
                return {"tf32": (3 if in_bytes == 4 else 2) * flops}, nbytes
            return {"fp32": flops}, nbytes
        k = kw["k"]
        nnz = w * k if kw.get("nnz") is None else kw["nnz"]
        nbytes = w * f * in_bytes + w * f * 4 + w * k * 8
        nbytes += w * 4 if name == "gossip_mix_quant" else 0
        return {"fp32": 2 * nnz * f}, nbytes
    if name in ("flash_attention", "flash_attention_tc"):
        b, h, s, d = kw["b"], kw["h"], kw["s"], kw["d"]
        sk = s if kw.get("sk") is None else kw["sk"]
        causal, window = kw.get("causal", True), kw.get("window", 0)
        if window > 0:          # keys in (q - window, q]: sum of min(q + 1, w)
            w = min(window, s)
            pairs = w * (w + 1) // 2 + (s - w) * window
        elif causal:
            pairs = s * (s + 1) // 2
        else:
            pairs = s * sk
        nbytes = 2 * b * h * (s + sk) * d * kw["itemsize"]
        pipe = "bf16" if kw["itemsize"] == 2 else "fp32"
        return {pipe: 4 * b * h * pairs * d}, nbytes
    if name in ("moe_router", "moe_route_slots"):
        t, e, k = kw["t"], kw["e"], kw["k"]
        nbytes = t * e * kw["itemsize"] + t * k * 8
        if name == "moe_route_slots":
            nbytes += t * k * 4 + e * kw["cap"] * 4
        return {"fp32": t * e * (3 + k)}, nbytes
    if name == "ssd_chunk_tc":
        g, h, t, n, p = kw["g"], kw["h"], kw["t"], kw["n"], kw["p"]
        pairs = t * (t + 1) // 2
        nbytes = 4 * (2 * g * t * n + 2 * g * h * t + 2 * g * h * t * p)
        products = g * pairs * (2 * n + 2 * p * h)
        return {"tf32": 3 * products, "fp32": g * pairs * h * 4,
                "products": products}, nbytes
    raise ValueError(f"kernel_cost: unknown kernel {name!r}")


def kernel_cost(name: str, **shape):
    """(flops, bytes) of one launch of the port's kernel ``name`` at
    ``shape`` (the keywords of its bound function below). flops are the
    kernel's own operations: the products (2 per multiply-add, counted
    once however many TF32 passes the kernel makes) and, for the router and
    the SSD term, its scalar work; bytes every input read once and every
    output written once. The counting pass (``counting``) adds this for
    each call of a wrapper in ``kernels.ops``."""
    ops, nbytes = pipes(name, **shape)
    if "products" in ops:            # the SSD term: products + scalar work
        return ops["products"] + ops["fp32"], nbytes
    return sum(ops.values()), nbytes
