#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

1. Build: compile the nine kernels (three gossip mixes, the SIMT and
   the tensor-core flash attention, the MoE router alone and fused with
   the grouped dispatch's slots, the SIMT and the tensor-core SSD
   intra-chunk term) from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, in parallel) and print ptxas's register and
   spill report and warnings; a spill in ``ssd_chunk_tc`` or in the dense
   gossip mix's tile regime fails.
2. Kernels: hold each kernel against its plain PyTorch version on the card.
   Gossip mixes at the main path's leaf shapes (W = 22), at a ragged F, at
   W in {48, 49, 64, 65, 128, 129, 200} (both sides of the dense mix's
   regime boundary at 48), at W=500 / density 0.05 / F in {4096, 4099}, at
   W = 1,000 / K = 100 (the sparse mix's slot groups), for every
   payload type, and the sparse and int8 mixes at W = 12,000 (their gather
   branches), each call checked to launch once in the regime or branch it
   should (``ops.REGIMES``); a zero-weight slot of the sparse mix that
   names a row holding inf, whose NaN and inf masks must equal the plain
   version's, in both branches; flash attention at
   S in {17, 64, 200, 256, 512, 1000, 4096}, D in {64, 128}, causal,
   window 128 and non-causal, f32 (the SIMT kernel, one-ulp limit) and
   bf16 (the tensor-core kernel, ``ref.flash_tc_limit``), bf16 at D = 32
   (SIMT), four adversarial cases (``ref.flash_adversarial``), and the
   main path's two prefill shapes and Jamba's [1, 32, 4096, 128] in its
   layout (bf16 views of [B, S, H, D] tensors), each call checked to
   launch the kernel its dtype and D select; the router at T in {4, 1000,
   2048, 4096}, (E, k) in {(64, 6), (16, 2)}, with rows of exact ties;
   both in f32 and bf16; the fused route-and-slot kernel on the same
   cases plus T = 32768 (1024 tiles) and routers skewed to overflow the
   capacity: gates and indices as the router's, slots and the inverse
   map exact against the plain rank of the kernel's own indices, equal
   across two calls and in a CUDA graph replay, and one grouped MoE layer
   captured in a CUDA graph (no host synchronisation). ssd_chunk in the
   main path's layout (x a view of the model's [G, T, H, P] chunks) with
   the model's decays (A_log = log(1..H), dt = softplus): Mamba2-780M's
   [G, H, T, N, P] = [32, 48, 256, 128, 64] and [64, 48, 256, 128, 64],
   a ragged T = 200, the Jamba shape
   (N = 16, H = 128), a reduced shape (N = 16, P = 32, T = 32), H = 12
   at P = 16, and the main shape with x contiguous, each through the
   kernel ``ops.ssd_kernel`` picks (the tensor-core ``ssd_chunk_tc`` at
   P in {32, 64}, the SIMT ``ssd_chunk`` at P = 16) and through the SIMT
   kernel's C entry; limit 1e-5 * max|y| of each call.
3. Timings: device time per call (CUDA graphs of back-to-back calls, timed
   with CUDA events) of the kernel, its plain version and, where one
   exists, one PyTorch library call computing the same function, at the
   main paths' shapes (the gossip mixes at W = 22 and W = 500, with the
   dense mix's bound both on the CUDA cores and in 3xTF32 on the tensor
   cores and ``torch.matmul`` beside it, the sparse mix also on a bf16
   payload; flash and ssd_chunk in the main
   path's layout;
   flash as the tensor-core kernel, the SIMT kernel through its C entry
   at the same bf16 shapes, the plain version and SDPA; ssd_chunk as the
   tensor-core kernel, the SIMT kernel through its C entry and the plain
   version at Mamba2-780M's two prefill shapes and Jamba's [16, 128, 256,
   16, 64]; the fused route-and-slot kernel, its plain version and the
   route it replaced, the router and a one-hot ``cumsum`` rank, at T in
   {2048, 4096, 4}, E = 64, k = 6 and T = 4096, E = 16, k = 2).
4. DeFTA, FedAvg and AsyncDeFTA end to end, all in the Table 2 world (20
   workers + 2 noise attackers, MLP, ``local_epochs=5``). The port's
   ``run_defta`` (20 epochs) on the fp32 wire with ``auto`` (sparse
   kernel), the int8 + EF21 wire (quant kernel) and ``backend="pallas"``
   (dense kernel), and the CNN world on ``auto``; every run's launch counts
   must equal leaves x epochs (0 for the serving kernels). ``run_fedavg``
   as CFL-F, CFL-S and FedAdam (20 epochs each): no kernel launch and a
   finite server loss; CFL-F's accuracy > 0.3 in the world without the
   attackers, which drag the undefended server down (paper Table 3).
   ``run_async_defta`` for 20
   ticks on the same three wires, and once with a target (``check_every=4``)
   that stops it early: each must launch its wire's kernel exactly leaves
   x ticks run times and nothing else, and its workers' epochs must spread.
   Small worlds (DeFTA, FedAdam with an attacker on CFL-S, async on each of
   the three kernels) also run on the card and on the CPU (plain versions)
   from the same initial state and draws, and the two must agree, with
   equal epoch counters.
4s. Scenarios end to end. The paper's Table 3 world (20 vanilla workers +
   40 noise attackers, W = 60, DTS and the time machine) as the scenario
   ``paper_noise@40`` and as ``num_malicious=40`` on ``auto``, 20 epochs:
   4 leaves x 20 = 80 ``gossip_mix_sparse`` launches in its slice branch
   each, vanilla accuracy > 0.3; the same world on ``pallas``: the dense
   mix's tile regime only. ``storm`` (W = 23) on the fp32 wire (sparse
   mix), the int8 + EF21 wire with stochastic rounding (quant mix) and
   ``pallas`` (dense mix, stream regime): leaves x epochs launches each.
   Time-varying topologies at W = 60 (re-drawn every 5 and every 2
   epochs): each support union's density and the kernel ``auto`` picks
   for it. trimmed_mean, median and krum at W = 60
   with noise@40: no mix launch. AsyncDeFTA under ``storm`` with a target
   (an early exit). Card vs CPU: a reduced ``storm`` on each kernel and a
   ``krum`` world, from one initial state and draw stream: states within
   the phase-4 limits, equal epoch counters, Krum's picks equal round by
   round.
4t. DTS v2 and v3 trust channels end to end (update geometry, the
   sign-sketch ring buffer, cross-round correlation). The trust grid's
   world (``benchmarks/table_trust.py``: 20 vanilla workers + 8 attackers,
   W = 28, non-iid α = 0.5, 3 local epochs): ``alie`` and ``label_flip``
   × ``dts_signal`` ∈ loss, geom, both, corr, all on ``auto`` (sparse
   mix, slice branch), 10 epochs each: leaves x epochs launches, a finite
   ``conf`` and, under corr / all, every fired worker's ring buffer
   filled. The Table 3 world at full width (20 vanilla + 40 ``alie``
   colluders, W = 60) under ``loss`` and ``all`` on ``auto`` (sparse),
   and under ``all`` on ``pallas`` (the dense mix's tile regime only), 10
   epochs each. AsyncDeFTA under
   ``storm`` with ``all``, 20 ticks, a ring buffer deeper than the run:
   each worker's filled slots equal its epoch (rows of ticks it did not
   fire stay put). Card vs CPU: ``port_robustness_demo``'s world (12
   vanilla + 4 alie colluders, a straggler, ``all``), 6 epochs from one
   initial state and draw stream: equal epochs, ``conf`` and losses within
   1e-4, sketches equal outside buckets whose projection is within 1e-5
   of its row's norm of 0. The trust functions at W = 60, D = 2,762 make
   no host synchronisation (``torch.cuda.set_sync_debug_mode``).
5. Serving end to end: DeepSeekMoE-16B at full width and depth (28 layers,
   64 routed experts top-6 + 2 shared, bf16, random weights from a seed)
   initialised on the card; ``build_prefill_step`` at B=4, S=512 and at
   B=1, S=4096 (finite logits, wall ms), then the port's serve loop at its
   defaults (batch 4, prompt 32, 32 new tokens, greedy). Launch counts:
   28 tensor-core flash (0 SIMT flash) and 27 route-and-slot launches (0
   router) per prefill call, 27 router launches per decode step, none of
   the gossip kernels nor ssd_chunk. A reduced DeepSeekMoE (f32) is also
   served on the card and on the CPU from the same parameters (logits
   within 1e-4, equal greedy tokens), and its teacher-forced decode on the
   card must match its prefill within 2e-3; its card runs must launch the
   SIMT flash kernel and not the tensor-core one.
6. Mamba2-780M at full width and depth (48 layers, bf16, 780,148,992
   parameters, random weights from a seed) initialised on the card;
   prefill at B=4, S=2048 and B=1, S=16384 with exactly 48 ssd_chunk_tc
   launches per call and no other kernel (0 SIMT ssd_chunk); the serve
   loop at its defaults with no kernel launch (decode is the plain
   recurrence); peak memory. A reduced Mamba2 (f32) card vs CPU as in 5,
   at S = 40, which is not a multiple of its chunk of 32, so the pad path
   runs on the card; its card runs must launch ssd_chunk_tc.
7. Jamba at full width cut to one 8-layer period (13,267,656,416
   parameters, bf16): two prefill calls at B=1, S=4096 with 7
   ssd_chunk_tc, 1 tensor-core flash and 4 route-and-slot launches each
   (0 SIMT ssd_chunk, 0 router) and finite logits.

Exits non-zero, before the last line, on any failure or without a card.
The last lines are the card's name and power limit, one JSON object with
every kernel's numbers, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
FP32_FLOPS = 67e12                 # H100 SXM, fp32 outside tensor cores
BF16_FLOPS = 989e12                # H100 SXM, bf16 tensor cores, dense
TF32_FLOPS = 495e12                # H100 SXM, TF32 tensor cores, dense
REPLACES = {
    "gossip_mix": "src/repro/kernels/gossip_mix.py:40",
    "gossip_mix_sparse": "src/repro/kernels/gossip_mix_sparse.py:66",
    "gossip_mix_quant": "src/repro/kernels/gossip_mix_quant.py:68",
    "flash_attention": "src/repro/kernels/flash_attention.py:87",
    "flash_attention_tc": "src/repro/kernels/flash_attention.py:87",
    "moe_router": "src/repro/kernels/moe_router.py:45",
    "moe_route_slots": "src/repro/kernels/moe_router.py:45",
    "ssd_chunk": "src/repro/kernels/ssd_chunk.py:44",
    "ssd_chunk_tc": "src/repro/kernels/ssd_chunk.py:44",
}
GOSSIP = ("gossip_mix", "gossip_mix_sparse", "gossip_mix_quant")
SERVING = ("flash_attention_tc", "moe_router", "moe_route_slots")
MAMBA2_PARAMS = 780_148_992             # repro.models.model.abstract_params
JAMBA_PERIOD_PARAMS = 13_267_656_416    # the same, jamba at num_layers=8
SOURCES = {k: f"src/repro_torch/kernels/csrc/{k}.cu" for k in REPLACES}


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------

def world_csr(w: int, k_peers: int, seed: int, dev):
    """A random k-out topology with self-loops and a row-stochastic P on it
    (about half the peers unsampled, i.e. zero weight, as in a round):
    returns P [W, W], idx [W, K] int32, val [W, K], nnz (non-pad slots)."""
    from repro_torch.core.gossip import sparse_support, sparse_weights
    rng = np.random.default_rng(seed)
    adj = np.zeros((w, w), bool)
    for i in range(w):
        adj[i, rng.choice([j for j in range(w) if j != i], size=k_peers,
                          replace=False)] = True
    keep = (adj & (rng.random((w, w)) < 0.5)) | np.eye(w, dtype=bool)
    P = keep * rng.uniform(0.5, 1.5, (w, w))
    P = torch.tensor(P / P.sum(1, keepdims=True), dtype=torch.float32,
                     device=dev)
    idx, val = sparse_weights(P, adj)
    return P, idx, val.contiguous(), int(sparse_support(adj)[1].sum())


def payload(gen, w: int, f: int, dtype):
    x = torch.randn(w, f, generator=gen, device=gen.device)
    if dtype == "int8":
        from repro_torch.core.gossip import quantize_rows_int8
        return quantize_rows_int8(x)
    return x.to(getattr(torch, dtype)).contiguous(), None


# ---------------------------------------------------------------------------
# Phase 2: kernel vs plain version
# ---------------------------------------------------------------------------

def kernel_calls(ops, ref, P, idx, val, w_in, scale):
    """(kernel call, plain call) per kernel for one payload; P None: the
    padded-CSR mixes alone (the gather branches' W, where no dense P is
    made)."""
    calls = {}
    if scale is None:
        if P is not None:
            calls["gossip_mix"] = (lambda: ops.gossip_mix(P, w_in),
                                   lambda: ref.gossip_mix_ref(P, w_in))
        if w_in.dtype != torch.int8:
            calls["gossip_mix_sparse"] = (
                lambda: ops.gossip_mix_sparse(idx, val, w_in),
                lambda: ref.gossip_mix_sparse_ref(idx, val, w_in))
    else:
        if P is not None:
            Pw = (P * scale[None, :]).contiguous()  # the pallas backend's fold
            calls["gossip_mix"] = (lambda: ops.gossip_mix(Pw, w_in),
                                   lambda: ref.gossip_mix_ref(Pw, w_in))
        calls["gossip_mix_quant"] = (
            lambda: ops.gossip_mix_quant(idx, val, scale, w_in),
            lambda: ref.gossip_mix_quant_ref(idx, val, scale, w_in))
    return calls


def gather_world(w: int, k: int, seed: int, dev):
    """idx [W, K] int32, val [W, K] for a large W without a dense P: slot 0
    the row itself, K - 2 random peers, the last slot a pad (val 0)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, w, size=(w, k)).astype(np.int32)
    idx[:, 0] = np.arange(w)
    idx[:, -1] = np.arange(w)
    val = rng.uniform(0.5, 1.5, size=(w, k))
    val[:, -1] = 0.0
    val /= val.sum(1, keepdims=True)
    return (torch.tensor(idx, device=dev),
            torch.tensor(val, dtype=torch.float32, device=dev))


# the padded-CSR mixes take their gather branches at K = 5 past W = 11,617
# (int8, ops.gossip_mix_quant_plan), 3,119 (f32) and 6,239 (bf16,
# ops.gossip_mix_sparse_plan)
GATHER_W = 12000


def expected_regime(ops, name, w, tag):
    """The regime or branch a gossip call must launch (ops.REGIMES key)."""
    if name == "gossip_mix":
        return "gossip_mix/" + ("stream" if w <= ops.GOSSIP_STREAM_MAX_W
                                else "tile")
    if name in ("gossip_mix_sparse", "gossip_mix_quant"):
        return name + ("/gather" if tag.startswith("gather") else "/slices")
    return None


def check_kernels(dev):
    """Every gossip mix against its plain version on every payload type:
    the main path's leaves (W = 22), the MLP's leaves in the scenario
    worlds (Table 3 at W = 60, K = 5; storm at W = 23), a ragged F, W in
    {48, 49} (both sides
    of the dense mix's regime boundary), W in {64, 65, 128, 129, 200} (both
    sides of the tile regime's 32-deep k step and 128-row tile; W = 49, 65
    and 129 leave P's rows unaligned), W =
    500 at F = 4096 and 4099, W = 1,000 at K = 100 (the sparse mix's slots
    no longer fit beside its slice: double-buffered slot groups) at F =
    2048 and 1001, and the sparse (f32, bf16) and int8 mixes at W = 12,000
    (their gather branches) at F = 4096 and 1001. Each call must
    launch once, in the regime or branch it should (``expected_regime``).
    Limit 1e-5 (1 + max|plain|) for every kernel and payload."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cases = []
    # the main path's leaves: MLP(32, 10, hidden 64) and CNN(10, 1, 10, 8)
    for f in (2048, 64, 640, 10, 72, 1152):
        cases.append(("main", 22, 4, f))
    # the MLP's leaves in the Table 3 world (W = 60, K = 5: the dense mix's
    # tile regime, mostly ragged tiles at F = 640, 64 and 10) and in the
    # storm world (W = 23)
    for f in (2048, 640, 64, 10):
        cases += [("table3", 60, 4, f), ("storm", 23, 4, f)]
    cases += [("ragged", 22, 4, 1001), ("W48", 48, 16, 2048),
              ("W49", 49, 16, 1001), ("W64", 64, 21, 2048),
              ("W65", 65, 21, 1001), ("W128", 128, 42, 4096),
              ("W129", 129, 43, 2048), ("W200", 200, 66, 4099),
              ("w500", 500, 24, 4096), ("w500-ragged", 500, 24, 4099),
              ("groups", 1000, 99, 2048), ("groups-ragged", 1000, 99, 1001),
              ("gather", GATHER_W, 5, 4096),
              ("gather-ragged", GATHER_W, 5, 1001)]
    max_err = {k: 0.0 for k in GOSSIP}
    seen = set()
    for tag, w, kp, f in cases:
        if tag.startswith("gather"):
            P = None
            idx, val = gather_world(w, kp, seed=f, dev=dev)
        else:
            P, idx, val, _ = world_csr(w, kp, seed=w + f, dev=dev)
        for dtype in ("float32", "bfloat16", "int8"):
            w_in, scale = payload(gen, w, f, dtype)
            for name, (kern, plain) in kernel_calls(
                    ops, ref, P, idx, val, w_in, scale).items():
                before, regimes = ops.LAUNCHES[name], dict(ops.REGIMES)
                got = kern()
                torch.cuda.synchronize()
                want = plain()
                regime = expected_regime(ops, name, w, tag)
                launched = {k: v - regimes.get(k, 0)
                            for k, v in ops.REGIMES.items()
                            if v != regimes.get(k, 0)}
                if ops.LAUNCHES[name] - before != 1 or (
                        regime is not None and launched != {regime: 1}):
                    fail(f"{name} {tag} {dtype}: launches {launched}, "
                         f"expected one in {regime}")
                seen.add(regime)
                if got.shape != want.shape or got.dtype != torch.float32:
                    fail(f"{name} {tag} {dtype}: shape/dtype {got.shape} "
                         f"{got.dtype}")
                err = float((got - want).abs().max())
                tol = 1e-5 * (1.0 + float(want.abs().max()))
                print(f"  check {name:18s} {tag:13s} W={w:5d} F={f:5d} "
                      f"{dtype:8s} max_abs_err={err:.3e} tol={tol:.1e}"
                      f"{'' if regime is None else ' ' + regime}")
                if not err <= tol:
                    fail(f"{name} disagrees with its plain version")
                max_err[name] = max(max_err[name], err)
    want_seen = {"gossip_mix/stream", "gossip_mix/tile",
                 "gossip_mix_sparse/slices", "gossip_mix_sparse/gather",
                 "gossip_mix_quant/slices", "gossip_mix_quant/gather"}
    if not want_seen <= seen:
        fail(f"gossip regimes launched {sorted(seen - {None})}, expected "
             f"{sorted(want_seen)}")
    return max_err


def check_sparse_nonfinite(dev):
    """The sparse mix folds every slot, weight 0 included, as the TPU kernel
    does: a zero-weight slot that names a row holding inf adds 0 * inf =
    NaN. At W = 22 and 500 (slices: an unsampled peer's slot) and at
    ``GATHER_W`` (gather: the pad slot, which names the row itself), f32
    and bf16, the kernel's NaN and inf masks must equal the plain
    version's, with NaN where the slot points, and the finite values agree
    within the usual limit."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    for tag, w, kp, f in (("slices", 22, 4, 72), ("slices", 500, 24, 4099),
                          ("gather", GATHER_W, 5, 1001)):
        if tag == "gather":
            idx, val = gather_world(w, kp, seed=f, dev=dev)
            i, kk = 0, kp - 1                 # the pad slot: row 0 itself
        else:
            _, idx, val, _ = world_csr(w, kp, seed=w + f, dev=dev)
            zero = (val == 0) & (idx != torch.arange(w, device=dev)[:, None])
            i, kk = (int(t) for t in zero.nonzero()[0])
        j = int(idx[i, kk])
        for dtype in ("float32", "bfloat16"):
            x, _ = payload(gen, w, f, dtype)
            x[j, 3:9] = float("inf")
            before = dict(ops.REGIMES)
            got = ops.gossip_mix_sparse(idx, val, x)
            torch.cuda.synchronize()
            want = ref.gossip_mix_sparse_ref(idx, val, x)
            fin = want.isfinite()
            err = float((got[fin] - want[fin]).abs().max())
            tol = 1e-5 * (1.0 + float(want[fin].abs().max()))
            n_nan = int(want.isnan().sum())
            print(f"  check gossip_mix_sparse inf row W={w:5d} F={f:4d} "
                  f"{dtype:8s} slot ({i}, {kk}) -> row {j} weight "
                  f"{float(val[i, kk]):.1f}: NaN {n_nan} (plain), finite "
                  f"max_abs_err={err:.3e} tol={tol:.1e}")
            if ops.REGIMES.get(f"gossip_mix_sparse/{tag}", 0) - \
                    before.get(f"gossip_mix_sparse/{tag}", 0) != 1:
                fail(f"gossip_mix_sparse inf row W={w}: not in its {tag} "
                     f"branch")
            if not (torch.equal(got.isnan(), want.isnan())
                    and torch.equal(got.isinf(), want.isinf())
                    and bool(want[i, 3:9].isnan().all()) and err <= tol):
                fail("gossip_mix_sparse: a zero-weight slot on an inf row "
                     "gives another result than the plain version")


# ---------------------------------------------------------------------------
# Phase 3: timings
# ---------------------------------------------------------------------------

def device_ms(fn, calls: int = 50, repeats: int = 7) -> float:
    """Median device milliseconds per call: ``calls`` back-to-back calls
    captured in one CUDA graph (so host overhead does not show), replayed
    ``repeats`` times between CUDA events, after a warm-up."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def bound(name, w, k_nnz, k_slots, f, in_bytes, tensor_cores=False):
    """(bound_ms, bound_by): bytes over the card's memory rate vs the
    operations over their peak rate, each input read once and the output
    written once. The operations are fp32 FMAs on the CUDA cores, or, for
    the dense mix's tile regime (``tensor_cores``), its TF32 products on
    the tensor cores: three per product for an f32 payload, two for bf16
    and int8."""
    if name == "gossip_mix":
        nbytes = w * f * in_bytes + w * f * 4 + w * w * 4
        flops = 2 * w * w * f
    else:
        nbytes = w * f * in_bytes + w * f * 4 + w * k_slots * 8
        nbytes += w * 4 if name == "gossip_mix_quant" else 0
        flops = 2 * k_nnz * f
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    if tensor_cores:
        t_ops = (3 if in_bytes == 4 else 2) * flops / TF32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops \
        else "operations"


def time_kernels(dev, tag, w, kp, f):
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    P, idx, val, nnz = world_csr(w, kp, seed=7, dev=dev)
    w32, _ = payload(gen, w, f, "float32")
    w16, _ = payload(gen, w, f, "bfloat16")
    q, scale = payload(gen, w, f, "int8")
    csr = torch.sparse_coo_tensor(
        torch.stack([torch.arange(w, device=dev).repeat_interleave(
            idx.shape[1]), idx.reshape(-1).long()]), val.reshape(-1),
        (w, w)).coalesce().to_sparse_csr()
    rows = {
        "gossip_mix": (lambda: ops.gossip_mix(P, w32),
                       lambda: ref.gossip_mix_ref(P, w32),
                       lambda: torch.matmul(P, w32), 4),
        "gossip_mix_sparse": (lambda: ops.gossip_mix_sparse(idx, val, w32),
                              lambda: ref.gossip_mix_sparse_ref(idx, val,
                                                                w32),
                              lambda: torch.sparse.mm(csr, w32), 4),
        "gossip_mix_quant": (
            lambda: ops.gossip_mix_quant(idx, val, scale, q),
            lambda: ref.gossip_mix_quant_ref(idx, val, scale, q), None, 1),
    }
    out = {}
    for name, (kern, plain, lib, in_bytes) in rows.items():
        ms, plain_ms = device_ms(kern), device_ms(plain)
        lib_ms = device_ms(lib) if lib is not None else None
        tile = name == "gossip_mix" and \
            ops.gossip_mix_plan(w, f, w32.dtype)[0] == "tile"
        b_ms, b_by = bound(name, w, nnz, idx.shape[1], f, in_bytes, tile)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                     "bound_ms": b_ms, "bound_by": b_by}
        both = ""
        if name == "gossip_mix":    # the bound both ways
            cc = bound(name, w, nnz, idx.shape[1], f, in_bytes)
            tc = bound(name, w, nnz, idx.shape[1], f, in_bytes, True)
            both = (f" [fp32 CUDA cores {cc[0] * 1e3:.2f}us ({cc[1]}), "
                    f"3xTF32 tensor cores {tc[0] * 1e3:.2f}us ({tc[1]}); "
                    f"{'tile' if tile else 'stream'} regime]")
        print(f"  time {name:18s} {tag:5s} W={w:3d} K={idx.shape[1]:2d} "
              f"F={f:5d} kernel={ms * 1e3:9.2f}us plain={plain_ms * 1e3:9.2f}"
              f"us library={'-' if lib_ms is None else f'{lib_ms * 1e3:.2f}'}"
              f"us bound={b_ms * 1e3:.2f}us ({b_by}){both}")
    ms = device_ms(lambda: ops.gossip_mix_sparse(idx, val, w16))
    plain_ms = device_ms(lambda: ref.gossip_mix_sparse_ref(idx, val, w16))
    b_ms, b_by = bound("gossip_mix_sparse", w, nnz, idx.shape[1], f, 2)
    print(f"  time {'gossip_mix_sparse':18s} {tag:5s} W={w:3d} "
          f"K={idx.shape[1]:2d} F={f:5d} kernel={ms * 1e3:9.2f}us plain="
          f"{plain_ms * 1e3:9.2f}us bound={b_ms * 1e3:.2f}us ({b_by}) "
          f"[bf16 payload]")
    return out


def flash_err(got, want, dtype):
    """The SIMT kernel's limit: (max |got - want|, its worst ratio to the
    limit) over the elements. f32: 5e-5 (the JAX package's bound). bf16:
    one ulp of each element, |want| * 2**-7 (ulp(x) <= |x| * 2**-7),
    + 1e-5: both compute in fp32 (they agree within 1e-6 in f32) and round
    once to bf16, so they differ by at most one rounding step of the
    element itself."""
    err = (got.float() - want.float()).abs()
    lim = 5e-5 if dtype == torch.float32 \
        else want.float().abs() * 2.0 ** -7 + 1e-5
    return float(err.max()), float((err / lim).max())


def main_path_qkv(gen, b, s, dev, h=16):
    """q, k, v as attention.py hands them to the kernel: bf16 [B, H, S,
    128] views of [B, S, H, 128] tensors (DeepSeekMoE-16B's 16 heads;
    Jamba's 32)."""
    return tuple(torch.randn(b, s, h, 128, generator=gen, device=dev)
                 .to(torch.bfloat16).transpose(1, 2) for _ in range(3))


def check_flash(dev):
    """flash_attention against its plain version, each call checked to
    launch the kernel its dtype and D select (``ops.flash_kernel``): S in
    {17 (shorter than a tile), 64, 200 (ragged), 256, 512, 1000 (ragged),
    4096}, D in {64, 128}, causal / window 128 / non-causal, f32 (SIMT,
    ``flash_err``) and bf16 (tensor cores, ``ref.flash_tc_limit``); bf16
    at D = 32 (SIMT, ``flash_err``); the four adversarial cases of
    ``ref.flash_adversarial`` at both D; the main path's two prefill
    shapes and Jamba's [1, 32, 4096, 128] in its layout (``main_path_qkv``),
    causal, window 0. Returns the worst max |error| of each kernel."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    cases = []
    for s in (17, 64, 200, 256, 512, 1000, 4096):
        b, h = (2, 4) if s <= 1000 else (1, 2)
        for d in (64, 128):
            for dtype in (torch.float32, torch.bfloat16):
                qkv = tuple(torch.randn(b, h, s, d, generator=gen,
                                        device=dev).to(dtype)
                            for _ in range(3))
                cases += [("", qkv, causal, window) for causal, window in
                          ((True, 0), (True, 128), (False, 0))]
    qkv = tuple(torch.randn(2, 4, 200, 32, generator=gen, device=dev)
                .to(torch.bfloat16) for _ in range(3))
    cases += [("D=32", qkv, causal, window) for causal, window in
              ((True, 0), (True, 128), (False, 0))]
    for kind in ref.FLASH_ADVERSARIAL:
        for d in (64, 128):
            *qkv, causal, window = ref.flash_adversarial(kind, d, seed=d,
                                                         device=dev)
            cases.append((f"adversarial {kind}",
                          tuple(x.to(torch.bfloat16) for x in qkv), causal,
                          window))
    for b, s, h in ((4, 512, 16), (1, 4096, 16), (1, 4096, 32)):
        cases.append(("main-path strided" if h == 16 else
                      "jamba strided", main_path_qkv(gen, b, s, dev, h),
                      True, 0))
    worst = {"flash_attention": 0.0, "flash_attention_tc": 0.0}
    worst_ratio = dict(worst)
    for tag, (q, k, v), causal, window in cases:
        name = ops.flash_kernel(q.dtype, q.shape[-1])
        before = dict(ops.LAUNCHES)
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        launched = {n: ops.LAUNCHES[n] - before[n] for n in worst}
        if name == "flash_attention_tc":
            lim = ref.flash_tc_limit(q, k, v, want, causal=causal,
                                     window=window)
            diff = (got.float() - want.float()).abs()
            err, ratio = float(diff.max()), float((diff / lim).max())
        else:
            err, ratio = flash_err(got, want, q.dtype)
        print(f"  check {name:18s} {list(q.shape)} {str(q.dtype)[6:]:8s}"
              f" causal={causal:d} window={window:3d} max_abs_err={err:.3e}"
              f" worst_err/limit={ratio:.3f} {tag}")
        if launched != {n: int(n == name) for n in worst}:
            fail(f"flash_attention {tag}: launches {launched}, expected one "
                 f"of {name}")
        if got.dtype != q.dtype or got.shape != q.shape or not ratio <= 1.0:
            fail(f"{name} disagrees with its plain version")
        worst[name] = max(worst[name], err)
        worst_ratio[name] = max(worst_ratio[name], ratio)
    print(f"  flash worst err/limit: {worst_ratio}")
    return worst


def router_rows(gen, t, e, dev, dtype):
    """Normal logits; every third row has an exact tie across the top
    (half the experts at 6.0), every fifth row rounded logits (ties inside
    the top-k). Returns (logits, mask of tie rows)."""
    x = torch.randn(t, e, generator=gen, device=dev)
    x[::3, : e // 2] = 6.0
    x[1::5] = torch.round(x[1::5])
    ties = torch.zeros(t, dtype=torch.bool, device=dev)
    ties[::3] = True
    ties[1::5] = True
    return x.to(dtype), ties


def check_router(dev):
    """moe_router against its plain version: T in {4, 1000, 2048, 4096},
    (E, k) in {(64, 6), (16, 2)}, f32 and bf16 logits. Indices must be
    equal, except that on a row of random logits two experts whose fp32
    probabilities round to within 1e-6 may swap (the two softmaxes sum in
    another order); the gates of such a swap still agree. Rows with exact
    ties must match exactly. Gates within 1e-6."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    worst, swaps = 0.0, 0
    for t in (4, 1000, 2048, 4096):
        for e, k in ((64, 6), (16, 2)):
            for dtype in (torch.float32, torch.bfloat16):
                x, ties = router_rows(gen, t, e, dev, dtype)
                gates, idx = ops.moe_router_topk(x, k)
                wgates, widx = ref.moe_router_topk_ref(x, k)
                torch.cuda.synchronize()
                err = float((gates - wgates).abs().max())
                bad = (idx != widx).any(dim=1)
                print(f"  check moe_router T={t:4d} E={e:2d} k={k} "
                      f"{str(dtype)[6:]:8s} gate_max_abs_err={err:.3e} "
                      f"tol=1.0e-06 idx_rows_differ={int(bad.sum())}")
                if idx.dtype != torch.int32 or not err <= 1e-6 \
                        or bool((bad & ties).any()):
                    fail("moe_router disagrees with its plain version")
                swaps += int(bad.sum())
                worst = max(worst, err)
    if swaps > 2:
        fail(f"moe_router: {swaps} rows with swapped indices")
    return worst


def graph_outputs(fn):
    """``fn``'s outputs from an eager call and from two replays of a CUDA
    graph that captured it (after warm-up calls on a side stream)."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        eager = [t.clone() for t in fn()]
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = fn()
    replays = []
    for _ in range(2):
        g.replay()
        torch.cuda.synchronize()
        replays.append([t.clone() for t in out])
    return eager, replays


def check_route_slots(dev):
    """The fused route-and-slot kernel against its plain version on
    ``check_router``'s cases, on T = 32768 (1024 tiles of 32 rows, many
    look-back windows) and on routers skewed to overflow the capacity
    (expert 3 raised by 4 on 80 % of the rows), f32 and bf16, at
    ``moe_grouped``'s capacity. Gates and indices as ``check_router``
    holds the router (gates within 1e-6; at most 2 rows with swapped
    near-equal indices over all cases, none on a tie row) and bit-equal
    to the router kernel's on the same logits (the same per-row code);
    slot and the inverse map src exactly ``ref.route_slots_ref`` of the
    kernel's own indices; a second call and two CUDA graph replays equal
    to the first. Returns the worst gate error."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models.moe import grouped_capacity
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    worst, swaps = 0.0, 0
    cases = [(t, e, k, kind) for t in (4, 1000, 2048, 4096, 32768)
             for e, k in ((64, 6), (16, 2)) for kind in ("ties", "skewed")]
    for t, e, k, kind in cases:
        for dtype in (torch.float32, torch.bfloat16):
            x, ties = router_rows(gen, t, e, dev, torch.float32)
            if kind == "skewed":
                x[torch.rand(t, generator=gen, device=dev) < 0.8, 3] += 4.0
            x = x.to(dtype)
            cap = grouped_capacity(t, e, k)
            got = ops.moe_route_slots(x, k, cap)
            again = ops.moe_route_slots(x, k, cap)
            gates, idx, slot, src = got
            rgates, ridx = ops.moe_router_topk(x, k)
            wgates, widx = ref.moe_router_topk_ref(x, k)
            wslot, wsrc = ref.route_slots_ref(idx, e, cap)
            torch.cuda.synchronize()
            err = float((gates - wgates).abs().max())
            bad = (idx != widx).any(dim=1)
            dropped = int((slot == cap).sum())
            print(f"  check moe_route_slots T={t:5d} E={e:2d} k={k} "
                  f"cap={cap:5d} {kind:6s} {str(dtype)[6:]:8s} "
                  f"gate_max_abs_err={err:.3e} tol=1.0e-06 "
                  f"idx_rows_differ={int(bad.sum())} dropped={dropped}")
            if not (err <= 1e-6 and not bool((bad & ties).any())):
                fail("moe_route_slots: gates or indices disagree with the "
                     "plain version")
            if not (torch.equal(gates, rgates) and torch.equal(idx, ridx)):
                fail("moe_route_slots: gates or indices differ from the "
                     "router kernel's")
            if not (torch.equal(slot, wslot) and torch.equal(src, wsrc)):
                fail("moe_route_slots: slots disagree with the plain rank "
                     "of the kernel's own indices")
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                fail("moe_route_slots: two calls differ")
            if kind == "skewed" and t >= 1000 and not dropped:
                fail("moe_route_slots: the skewed case does not overflow")
            swaps += int(bad.sum())
            worst = max(worst, err)
    if swaps > 2:
        fail(f"moe_route_slots: {swaps} rows with swapped indices")
    x, _ = router_rows(gen, 4096, 64, dev, torch.float32)
    eager, replays = graph_outputs(
        lambda: ops.moe_route_slots(x, 6, grouped_capacity(4096, 64, 6)))
    if not all(torch.equal(a, b) for r in replays for a, b in zip(eager, r)):
        fail("moe_route_slots: a CUDA graph replay differs from the eager "
             "call")
    print("  check moe_route_slots T=4096 E=64 k=6 in a CUDA graph: two "
          "replays equal to the eager call")
    return worst


def check_grouped_capture(dev):
    """One grouped MoE layer (``moe_grouped`` at the reduced DeepSeekMoE's
    shapes, f32, T = 96) captured in a CUDA graph, which fails on any
    host synchronisation; two replays equal to the eager call."""
    from repro_torch.config import reduced
    from repro_torch.configs import get_config
    from repro_torch.models import layers, moe
    cfg = reduced(get_config("deepseek-moe-16b"))
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    b = layers.Builder(gen, torch.float32, dev)
    moe.init_moe(b, cfg)
    x = torch.randn(96, cfg.d_model, generator=gen, device=dev)
    eager, replays = graph_outputs(lambda: moe.moe_grouped(b.params, cfg, x))
    if not all(torch.equal(a, b) for r in replays for a, b in zip(eager, r)):
        fail("moe_grouped: a CUDA graph replay differs from the eager call")
    print(f"  check moe_grouped captured in a CUDA graph (E="
          f"{cfg.moe.num_experts}, k={cfg.moe.top_k}, T=96): two replays "
          f"equal to the eager call")


def flash_bound(b, h, s, d, itemsize, causal=True):
    """(bound_ms, bound_by): q, k, v read and out written once, against
    4*D flops per visible (q, k) pair at the bf16 tensor-core peak (bf16
    inputs) or the fp32 CUDA-core peak."""
    pairs = s * (s + 1) // 2 if causal else s * s
    nbytes = 4 * b * h * s * d * itemsize
    flops = 4 * b * h * pairs * d
    peak = BF16_FLOPS if itemsize == 2 else FP32_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops \
        else "operations"


def router_bound(t, e, k, itemsize):
    """Logits read once, gates and indices written once, against the
    softmax's 3 and the k rounds' k fp32 operations per logit."""
    nbytes = t * e * itemsize + t * k * 8
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, t * e * (3 + k) / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops \
        else "operations"


def simt_flash(q, k, v):
    """The SIMT flash kernel through its C entry (causal, window 0), on
    any dtype and D it takes; bypasses ``ops`` and its launch counter, so
    it times the SIMT kernel on shapes the wrapper sends to the tensor
    cores."""
    from repro_torch.kernels import build, ops
    b, h, s, d = q.shape
    out = torch.empty_like(q)
    rc = build.load("flash_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, h,
        s, d, *q.stride()[:3], *out.stride()[:3], 1, 0,
        ops._DTYPE_CODE[q.dtype], torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        fail(f"SIMT flash launch failed (cudaError {rc})")
    return out


def time_serving_kernels(dev):
    """Flash attention at the prefill shapes and layout
    (``main_path_qkv``: [4, 16, 512, 128] and [1, 16, 4096, 128], bf16,
    causal): the tensor-core kernel (timed first and last), the SIMT
    kernel through its C entry, SDPA and the plain version, in one call;
    and the router at T = 2048 (prefill B=4 x S=512), 4096 and 4 (a decode
    step), E = 64, k = 6, f32 logits. Returns the rows of the first shape
    of each."""
    from repro_torch.kernels import ops, ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    out = {}
    for b, s in ((4, 512), (1, 4096)):
        q, k, v = main_path_qkv(gen, b, s, dev)
        calls = 50 if s <= 512 else 5
        ms = device_ms(lambda: ops.flash_attention(q, k, v), calls)
        simt_ms = device_ms(lambda: simt_flash(q, k, v), calls)
        lib_ms = device_ms(lambda: sdpa(q, k, v, is_causal=True), calls)
        plain_ms = device_ms(lambda: ref.flash_attention_ref(q, k, v),
                             calls)
        ms_again = device_ms(lambda: ops.flash_attention(q, k, v), calls)
        b_ms, b_by = flash_bound(b, 16, s, 128, 2)
        tflops = 4 * b * 16 * (s * (s + 1) // 2) * 128 / (ms * 1e-3) / 1e12
        print(f"  time flash_attention_tc [{b},16,{s},128] bf16 strided "
              f"causal kernel={ms * 1e3:.2f}us (again {ms_again * 1e3:.2f}"
              f"us, {tflops:.1f} TFLOP/s) simt={simt_ms * 1e3:.2f}us "
              f"plain={plain_ms * 1e3:.2f}us library(sdpa)="
              f"{lib_ms * 1e3:.2f}us bound={b_ms * 1e3:.2f}us ({b_by}) "
              f"simt/tc={simt_ms / ms:.2f} tc/sdpa={ms / lib_ms:.3f}")
        if s == 4096 and not simt_ms >= 5 * ms:
            fail(f"flash_attention_tc at [{b},16,{s},128] is not 5x faster "
                 f"than the SIMT kernel ({ms:.4f} vs {simt_ms:.4f} ms)")
        row = {"plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
               "bound_by": b_by}
        out.setdefault("flash_attention_tc", dict(row, ms=ms))
        out.setdefault("flash_attention", dict(row, ms=simt_ms))
    for t in (2048, 4096, 4):
        x = torch.randn(t, 64, generator=gen, device=dev)
        ms = device_ms(lambda: ops.moe_router_topk(x, 6))
        plain_ms = device_ms(lambda: ref.moe_router_topk_ref(x, 6))
        b_ms, b_by = router_bound(t, 64, 6, 4)
        print(f"  time moe_router T={t:4d} E=64 k=6 f32 kernel="
              f"{ms * 1e3:.2f}us plain={plain_ms * 1e3:.2f}us library=- "
              f"bound={b_ms * 1e3:.3f}us ({b_by})")
        out.setdefault("moe_router", {
            "ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": b_ms, "bound_by": b_by})
    return out


def route_slots_bound(t, e, k, cap, itemsize):
    """Logits read once; gates, indices, slots and the inverse map written
    once; against ``router_bound``'s operations."""
    nbytes = t * e * itemsize + t * k * 12 + e * cap * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, t * e * (3 + k) / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops \
        else "operations"


def replaced_route(x, k, cap):
    """What ``moe_grouped`` ran before the fused kernel, up to the slots:
    the router kernel, then the rank by a ``cumsum`` over the [T*k, E]
    int64 one-hot along its outer axis, its gather and the capacity."""
    from repro_torch.kernels import ops
    gates, idx = ops.moe_router_topk(x, k)
    flat = idx.reshape(-1).long()
    rank = torch.cumsum(torch.nn.functional.one_hot(flat, x.shape[1]),
                        dim=0) - 1
    rank = rank.gather(1, flat[:, None])[:, 0]
    return gates, idx, torch.where(rank < cap, rank,
                                   torch.full_like(rank, cap))


def time_route_slots(dev):
    """The fused route-and-slot kernel (timed first and last), its plain
    version and the route it replaced (``replaced_route``) at T = 2048
    (prefill B=4 x S=512), 4096 and 4, E = 64, k = 6, and at T = 4096,
    E = 16, k = 2 (Jamba), f32 logits, ``moe_grouped``'s capacity.
    Returns the row of the first shape."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models.moe import grouped_capacity
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    out = {}
    for t, e, k in ((2048, 64, 6), (4096, 64, 6), (4, 64, 6), (4096, 16, 2)):
        x = torch.randn(t, e, generator=gen, device=dev)
        cap = grouped_capacity(t, e, k)
        ms = device_ms(lambda: ops.moe_route_slots(x, k, cap))
        plain_ms = device_ms(lambda: ref.moe_route_slots_ref(x, k, cap), 10)
        old_ms = device_ms(lambda: replaced_route(x, k, cap), 10)
        ms_again = device_ms(lambda: ops.moe_route_slots(x, k, cap))
        b_ms, b_by = route_slots_bound(t, e, k, cap, 4)
        print(f"  time moe_route_slots T={t:4d} E={e:2d} k={k} cap={cap} f32 "
              f"kernel={ms * 1e3:.2f}us (again {ms_again * 1e3:.2f}us) "
              f"plain={plain_ms * 1e3:.2f}us replaced route (router + "
              f"one-hot cumsum)={old_ms * 1e3:.2f}us library=- "
              f"bound={b_ms * 1e3:.3f}us ({b_by})")
        out.setdefault("moe_route_slots", {
            "ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": b_ms, "bound_by": b_by})
    return out


def ssd_inputs(gen, b, s, h, n, p, chunk, dev):
    """ssd_chunk's arguments as ``models.ssm.ssd_scan`` hands them to the
    kernel (``ssm.ssd_chunk_inputs``: x a [G, H, T, P] view of the
    [G, T, H, P] chunks), from the model's decay range: A_log = log(1..H),
    so A reaches -H, and dt = softplus of a unit normal (dt_bias 0), so
    acum falls by up to ~33 a step on the last head at H = 48."""
    from repro_torch.models import ssm
    x = torch.randn(b, s, h, p, generator=gen, device=dev)
    dt = torch.nn.functional.softplus(torch.randn(b, s, h, generator=gen,
                                                  device=dev))
    A = torch.log(torch.arange(1, h + 1, dtype=torch.float32, device=dev))
    B = torch.randn(b, s, n, generator=gen, device=dev)
    C = torch.randn(b, s, n, generator=gen, device=dev)
    args, _ = ssm.ssd_chunk_inputs(x, dt, A, B, C, chunk)
    return args


def ssd_bound(g, h, t, n, p):
    """(bound_ms, bound_by, cuda_core_ms) of the SSD intra-chunk term for a
    kernel on the tensor cores: C, B, acum, dt, x read and y written once
    (fp32) over the memory rate, against the operations: the products (2N
    flops per causal (q, k) pair for the scores, 2P per pair and head for
    w . x), three TF32 products each in 3xTF32, at the TF32 tensor-core
    rate, and the exponent and the two scalings (4 per pair and head) at
    the fp32 CUDA-core rate; the two pipes run side by side, so the larger
    of the two. ``cuda_core_ms`` is the earlier yardstick, every operation
    (2N per pair, 2P + 4 per pair and head) at the fp32 CUDA-core rate,
    which the SIMT kernel cannot beat but a tensor-core kernel can."""
    pairs = t * (t + 1) // 2
    nbytes = 4 * (2 * g * t * n + 2 * g * h * t + 2 * g * h * t * p)
    products = g * pairs * (2 * n + 2 * p * h)
    scalar = g * pairs * h * 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(3 * products / TF32_FLOPS, scalar / FP32_FLOPS)
    cuda_core = max(t_bytes, (products + scalar) / FP32_FLOPS)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops \
        else "operations", cuda_core * 1e3


# (tag, batch, seq, heads, d_state, head_dim, chunk); G = batch * seq / chunk
SSD_MAIN = ("mamba2-780m B=4 S=2048", 4, 2048, 48, 128, 64, 256)
SSD_CASES = (SSD_MAIN,
             ("mamba2-780m B=1 S=16384", 1, 16384, 48, 128, 64, 256),
             ("ragged T=200", 2, 200, 48, 128, 64, 200),
             ("jamba", 1, 1024, 128, 16, 64, 256),
             ("reduced", 2, 64, 16, 16, 32, 32),
             ("H=12 P=16 N=32 T=100", 2, 100, 12, 32, 16, 100))
# the timed shapes: Mamba2-780M's two prefill shapes, Jamba's at S = 4096
SSD_TIMED = (SSD_MAIN, SSD_CASES[1],
             ("jamba B=1 S=4096", 1, 4096, 128, 16, 64, 256))


def simt_ssd(C, B, acum, dt, x):
    """The SIMT ssd_chunk kernel through its C entry, on any shape it takes;
    bypasses ``ops`` and its launch counter, so it checks and times the
    SIMT kernel on shapes the wrapper sends to the tensor cores."""
    from repro_torch.kernels import build
    g, h, t, p = x.shape
    y = torch.empty_like(x)
    rc = build.load("ssd_chunk")(
        C.data_ptr(), B.data_ptr(), acum.data_ptr(), dt.data_ptr(),
        x.data_ptr(), y.data_ptr(), g, h, t, C.shape[-1], p, *x.stride()[:3],
        *y.stride()[:3], torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        fail(f"SIMT ssd_chunk launch failed (cudaError {rc})")
    return y


def check_ssd(dev):
    """ssd_chunk against its plain version at the main path's shapes and
    layout (Mamba2-780M at B=4/S=2048 and B=1/S=16384), a ragged T = 200,
    the Jamba shape, a reduced shape and a last head group of 4 at P = 16,
    all in the main path's layout, plus the main shape with x contiguous.
    Each case runs through ``ops.ssd_chunk``, which must launch the kernel
    ``ops.ssd_kernel`` picks once, and through the SIMT kernel's C entry.
    Limit for both: 1e-5 * max|y| of the call (the SIMT kernel sums in
    fp32; the tensor-core kernel in 3xTF32, ~2^-21 relative per product;
    both take the exponent of the same fp32 difference). Returns the worst
    max |error| of each kernel."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    worst = {"ssd_chunk": 0.0, "ssd_chunk_tc": 0.0}
    worst_ratio = dict(worst)
    for tag, b, s, h, n, p, chunk in SSD_CASES + (
            ("main contiguous x",) + SSD_MAIN[1:],):
        args = ssd_inputs(gen, b, s, h, n, p, chunk, dev)
        if tag == "main contiguous x":
            args = args[:4] + (args[4].contiguous(),)
        name = ops.ssd_kernel(n, p)
        before = dict(ops.LAUNCHES)
        got = ops.ssd_chunk(*args)
        launched = {k: ops.LAUNCHES[k] - before[k] for k in worst}
        simt = simt_ssd(*args)
        want = ref.ssd_chunk_ref(*args)
        torch.cuda.synchronize()
        if launched != {k: int(k == name) for k in worst}:
            fail(f"ssd_chunk {tag}: launches {launched}, expected one of "
                 f"{name}")
        lim = 1e-5 * float(want.abs().max())
        shape = [args[4].shape[0], h, args[4].shape[2], n, p]
        for kname, out in ((name, got), ("ssd_chunk", simt)):
            err = float((out - want).abs().max())
            print(f"  check {kname:12s} {tag:24s} [G,H,T,N,P]={shape} "
                  f"max|y|={float(want.abs().max()):.3e} max_abs_err="
                  f"{err:.3e} err/limit={err / lim:.3f} "
                  f"min(acum)={float(args[2].min()):.1f}"
                  + (" (C entry)" if out is simt else ""))
            if out.shape != want.shape or out.dtype != torch.float32 \
                    or not bool(torch.isfinite(out).all()) or not err <= lim:
                fail(f"{kname} {tag} disagrees with its plain version")
            worst[kname] = max(worst[kname], err)
            worst_ratio[kname] = max(worst_ratio[kname], err / lim)
    print(f"  ssd worst err/limit {worst_ratio}")
    return worst


def time_ssd(dev):
    """The tensor-core ssd_chunk (through ``ops``, timed first and last),
    the SIMT kernel (its C entry) and the plain version, with the bound, at
    ``SSD_TIMED``'s shapes in the main path's layout; no single PyTorch
    call computes this function. Returns the rows of the main shape."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    out = {}
    for tag, b, s, h, n, p, chunk in SSD_TIMED:
        args = ssd_inputs(gen, b, s, h, n, p, chunk, dev)
        g, t = args[4].shape[0], args[4].shape[2]
        if ops.ssd_kernel(n, p) != "ssd_chunk_tc":
            fail(f"ssd_chunk {tag}: not the tensor-core kernel")
        ms = device_ms(lambda: ops.ssd_chunk(*args), 20)
        simt_ms = device_ms(lambda: simt_ssd(*args), 20)
        plain_ms = device_ms(lambda: ref.ssd_chunk_ref(*args), 5)
        ms_again = device_ms(lambda: ops.ssd_chunk(*args), 20)
        b_ms, b_by, cc_ms = ssd_bound(g, h, t, n, p)
        print(f"  time ssd_chunk_tc [{g},{h},{t},{n},{p}] f32 main-path "
              f"layout ({tag}) kernel={ms * 1e3:.2f}us (again "
              f"{ms_again * 1e3:.2f}us) simt={simt_ms * 1e3:.2f}us "
              f"plain={plain_ms * 1e3:.2f}us library=- bound="
              f"{b_ms * 1e3:.2f}us ({b_by}; fp32 CUDA-core figure "
              f"{cc_ms * 1e3:.2f}us) simt/tc={simt_ms / ms:.2f} "
              f"tc/bound={ms / b_ms:.2f}")
        row = {"plain_ms": plain_ms, "library_ms": None, "bound_ms": b_ms,
               "bound_by": b_by}
        out.setdefault("ssd_chunk_tc", dict(row, ms=ms))
        out.setdefault("ssd_chunk", dict(row, ms=simt_ms))
    return out


# ---------------------------------------------------------------------------
# Phase 4: DeFTA end to end
# ---------------------------------------------------------------------------

class MovedDraws:
    """CPU-generated draws handed to a run on any device, so a card run and
    a CPU run consume the same random numbers. ``provider`` is one of
    ``repro_torch.rng``'s default providers (``TorchDraws`` by default);
    its result, a tensor or a dataclass of tensors and dicts of them, is
    moved whole."""

    def __init__(self, seed, dev, provider=None):
        from repro_torch.rng import TorchDraws
        gen = torch.Generator()
        gen.manual_seed(seed)
        self.inner, self.dev = (provider or TorchDraws)(gen), dev

    def move(self, v):
        if isinstance(v, dict):
            return {k: self.move(x) for k, x in v.items()}
        return v.to(self.dev) if isinstance(v, torch.Tensor) else v

    def __call__(self, *args, **kw):
        d = self.inner(*args, **kw)
        if isinstance(d, torch.Tensor):
            return d.to(self.dev)
        for f in dataclasses.fields(d):
            setattr(d, f.name, self.move(getattr(d, f.name)))
        return d


def states_agree(a: dict, b: dict, wire: str) -> bool:
    """A card run's DeFTA state fields against the CPU run's: fp32 at
    rtol 1e-3 (summation order; SGD's drift over 4 rounds), params
    included; int8 at rtol 2e-2 (a flipped round-half tie moves a loss
    further), losses and conf only."""
    rtol = 1e-3 if wire == "float32" else 2e-2
    ok = np.allclose(a["last_loss"], b["last_loss"], rtol=rtol) \
        and np.allclose(a["conf"], b["conf"], rtol=rtol, atol=1e-4)
    if wire == "float32":
        ok = ok and all(np.allclose(a["params"][k], b["params"][k],
                                    rtol=rtol, atol=1e-4)
                        for k in a["params"])
    return ok


def card_vs_cpu():
    """A small world run on the card (kernels) and on the CPU (plain
    versions) from one initial state and one draw stream."""
    from repro_torch.config import DeFTAConfig, TrainConfig
    from repro_torch.convert import state_from_jax, state_to_numpy
    from repro_torch.core.defta import run_defta
    from repro_torch.core.engine import init_state
    from repro_torch.core.tasks import mlp_task
    from repro_torch.data import federated_dataset
    data = federated_dataset("vector", 12, np.random.default_rng(1),
                             n_per_worker=48)
    task = mlp_task(32, 10)
    train = TrainConfig(learning_rate=0.05, batch_size=32)
    for wire, backend, kernel in (("float32", "auto", "gossip_mix_sparse"),
                                  ("int8", "auto", "gossip_mix_quant"),
                                  ("float32", "pallas", "gossip_mix")):
        cfg = DeFTAConfig(num_workers=12, avg_peers=2, num_sampled=1,
                          local_epochs=2, gossip_dtype=wire)
        gen = torch.Generator()
        gen.manual_seed(0)
        init = state_to_numpy(init_state(gen, task, 13,
                                         wire_error=wire == "int8"))
        res = {}
        for dev in ("cuda", "cpu"):
            st, *_ = run_defta(0, task, cfg, train, data, epochs=4,
                               num_malicious=1, gossip_backend=backend,
                               device=dev, init=state_from_jax(init, dev),
                               draws=MovedDraws(5, dev))
            res[dev] = state_to_numpy(st)
        a, b = res["cuda"], res["cpu"]
        loss_err = float(np.abs(a["last_loss"] - b["last_loss"]).max())
        ok = states_agree(a, b, wire)
        print(f"  card-vs-cpu {kernel:18s} wire={wire:7s} "
              f"max|last_loss diff|={loss_err:.3e} agree={ok}")
        if not ok:
            fail(f"card run of {kernel} disagrees with the CPU run")
    card_vs_cpu_fedavg(data, task, train)
    card_vs_cpu_async(data, task, train)


def card_vs_cpu_fedavg(data, task, train):
    """FedAdam on a CFL-S cohort of 2 with one attacker, 4 epochs, on the
    card and on the CPU from one server and one draw stream."""
    from repro_torch.config import DeFTAConfig
    from repro_torch.convert import (fedavg_state_from_jax,
                                     fedavg_state_to_numpy)
    from repro_torch.core.fedavg import init_state, run_fedavg
    from repro_torch.rng import TorchFedAvgDraws
    cfg = DeFTAConfig(num_workers=12, local_epochs=2)
    gen = torch.Generator()
    gen.manual_seed(0)
    init = fedavg_state_to_numpy(init_state(gen, task, "fedadam"))
    res = {}
    for dev in ("cuda", "cpu"):
        st, _ = run_fedavg(0, task, cfg, train, data, epochs=4,
                           num_malicious=1, sample_workers=2,
                           server_opt="fedadam", device=dev,
                           init=fedavg_state_from_jax(init, dev),
                           draws=MovedDraws(5, dev, TorchFedAvgDraws))
        res[dev] = fedavg_state_to_numpy(st)
    a, b = res["cuda"], res["cpu"]
    trees = [(a["server"], b["server"]), (a["opt"]["m"], b["opt"]["m"]),
             (a["opt"]["v"], b["opt"]["v"])]
    err = max(float(np.abs(x[k] - y[k]).max()) for x, y in trees for k in x)
    ok = all(np.allclose(x[k], y[k], rtol=1e-3, atol=1e-4)
             for x, y in trees for k in x)
    print(f"  card-vs-cpu fedavg (fedadam, cfl-s 2, 1 attacker) "
          f"max|server, m, v diff|={err:.3e} agree={ok}")
    if not ok:
        fail("card run of FedAdam disagrees with the CPU run")


def card_vs_cpu_async(data, task, train):
    """AsyncDeFTA on each gossip kernel, 6 ticks, on the card and on the
    CPU from one initial state, one round draw stream and one tick draw
    stream: the same workers fire, so the epoch counters must be equal."""
    from repro_torch.config import DeFTAConfig
    from repro_torch.convert import state_from_jax, state_to_numpy
    from repro_torch.core.async_defta import run_async_defta
    from repro_torch.core.engine import init_state
    from repro_torch.rng import TorchTickDraws
    for wire, backend, kernel in (("float32", "auto", "gossip_mix_sparse"),
                                  ("int8", "auto", "gossip_mix_quant"),
                                  ("float32", "pallas", "gossip_mix")):
        cfg = DeFTAConfig(num_workers=12, avg_peers=2, num_sampled=1,
                          local_epochs=2, gossip_dtype=wire)
        gen = torch.Generator()
        gen.manual_seed(0)
        init = state_to_numpy(init_state(gen, task, 13,
                                         wire_error=wire == "int8"))
        res = {}
        for dev in ("cuda", "cpu"):
            st, *_ = run_async_defta(
                0, task, cfg, train, data, ticks=6, num_malicious=1,
                gossip_backend=backend, device=dev,
                init=state_from_jax(init, dev), draws=MovedDraws(5, dev),
                tick_draws=MovedDraws(6, dev, TorchTickDraws))
            res[dev] = state_to_numpy(st)
        a, b = res["cuda"], res["cpu"]
        loss_err = float(np.abs(a["last_loss"] - b["last_loss"]).max())
        same_epochs = np.array_equal(a["epoch"], b["epoch"])
        ok = same_epochs and states_agree(a, b, wire)
        print(f"  card-vs-cpu async {kernel:18s} wire={wire:7s} "
              f"epochs={a['epoch'].tolist()} "
              f"max|last_loss diff|={loss_err:.3e} agree={ok}")
        if not ok:
            fail(f"async card run of {kernel} disagrees with the CPU run "
                 f"(epochs equal: {same_epochs})")


def table2_world(kind="vector", wire="float32"):
    """The Table 2 world (``benchmarks/common.make_setup``: 20 vanilla
    workers, MLP on vectors or CNN on images; the runs append 2 noise
    attackers)."""
    from repro_torch.config import DeFTAConfig, TrainConfig
    from repro_torch.core.tasks import cnn_task, mlp_task
    from repro_torch.data import federated_dataset
    rng = np.random.default_rng(0)
    if kind == "image":
        data = federated_dataset("image", 20, rng, hw=10, n_per_worker=100)
        task = cnn_task(10, 1, 10, width=8)
    else:
        data = federated_dataset("vector", 20, rng, n_per_worker=150)
        task = mlp_task(32, 10)
    cfg = DeFTAConfig(num_workers=20, avg_peers=4, num_sampled=2,
                      local_epochs=5, seed=0, gossip_dtype=wire)
    return data, task, cfg, TrainConfig(learning_rate=0.05, batch_size=32)


def end_to_end():
    from repro_torch.core.defta import run_defta
    from repro_torch.kernels import ops
    from repro_torch.telemetry import RunLedger

    epochs = 20
    runs = (
        ("mlp fp32 auto", "vector", "float32", "auto", "gossip_mix_sparse"),
        ("mlp int8+ef auto", "vector", "int8", "auto", "gossip_mix_quant"),
        ("mlp fp32 pallas", "vector", "float32", "pallas", "gossip_mix"),
        ("cnn fp32 auto", "image", "float32", "auto", "gossip_mix_sparse"),
    )
    launches = {}
    for label, kind, wire, backend, kernel in runs:
        data, task, cfg, train = table2_world(kind, wire)
        led = RunLedger()
        ops.reset_launches()
        t0 = time.perf_counter()
        st, _, _, hist = run_defta(0, task, cfg, train, data, epochs=epochs,
                                   num_malicious=2, gossip_backend=backend,
                                   eval_every=5, test_x=data["test_x"],
                                   test_y=data["test_y"], ledger=led)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(ops.LAUNCHES)
        leaves = len(st.params)
        acc = hist[-1][1]
        per_epoch = [1e3 * s / 5 for s in led.superstep_s]  # 5-epoch chunks
        print(f"  e2e {label:17s} epochs={epochs} wall={wall:.2f}s "
              f"per_epoch_ms={[round(x, 2) for x in per_epoch]} "
              f"vanilla_acc={[round(h[1], 4) for h in hist]} "
              f"launches={counts}")
        if not bool(torch.isfinite(st.last_loss).all()):
            fail(f"{label}: non-finite loss")
        want = {k: leaves * epochs if k == kernel else 0 for k in counts}
        if counts != want:
            fail(f"{label}: launch counts {counts}, expected {want}")
        if label == "mlp fp32 auto" and not acc > 0.3:
            fail(f"{label}: vanilla accuracy {acc} <= 0.3")
        launches.setdefault(kernel, counts[kernel])
    return launches


def fedavg_end_to_end():
    """CFL-F, CFL-S and FedAdam on the card, 20 epochs each: no kernel may
    launch (FedAvg's aggregate is a plain product, as in the reference)."""
    from repro_torch.core.fedavg import run_fedavg
    from repro_torch.kernels import ops
    from repro_torch.telemetry import RunLedger

    epochs = 20
    data, task, cfg, train = table2_world()
    for label, kw in (("cfl-f", {}), ("cfl-s", {"sample_workers": 2}),
                      ("fedadam", {"server_opt": "fedadam"})):
        led = RunLedger()
        ops.reset_launches()
        st, hist = run_fedavg(0, task, cfg, train, data, epochs=epochs,
                              num_malicious=2, eval_every=5,
                              test_x=data["test_x"], test_y=data["test_y"],
                              ledger=led, **kw)
        torch.cuda.synchronize()
        counts = dict(ops.LAUNCHES)
        dev = st.server["w1"].device
        x = torch.as_tensor(data["test_x"]).to(dev)[None]
        y = torch.as_tensor(data["test_y"]).to(dev)[None]
        with torch.no_grad():
            loss = float(task.loss({k: v[None] for k, v in
                                    st.server.items()}, x, y,
                                   torch.ones(1, x.shape[1], device=dev))[0])
        per_epoch = [1e3 * s / 5 for s in led.superstep_s]  # 5-epoch chunks
        print(f"  fedavg {label:8s} epochs={epochs} per_epoch_ms="
              f"{[round(v, 2) for v in per_epoch]} server_acc="
              f"{[round(h[1], 4) for h in hist]} server_test_loss="
              f"{loss:.4f} launches={counts}")
        if any(counts.values()):
            fail(f"fedavg {label}: launch counts {counts}, expected none")
        if not np.isfinite(loss):
            fail(f"fedavg {label}: non-finite server loss {loss}")
    # the attackers' noise (scale 200) drags the undefended server down
    # (paper Table 3), so accuracy is checked without them
    led = RunLedger()
    st, hist = run_fedavg(0, task, cfg, train, data, epochs=epochs,
                          eval_every=epochs, test_x=data["test_x"],
                          test_y=data["test_y"], ledger=led)
    print(f"  fedavg cfl-f, no attacker: per_epoch_ms="
          f"{1e3 * led.wall_s / epochs:.2f} server_acc={hist[-1][1]:.4f}")
    if not hist[-1][1] > 0.3:
        fail(f"fedavg cfl-f: server accuracy {hist[-1][1]} <= 0.3")


def async_end_to_end(launches):
    """AsyncDeFTA on the card: 20 ticks on each gossip wire, then one
    targeted run that stops early. Each run must launch its wire's kernel
    exactly leaves x ticks run times (the round runs on every tick, fired
    or not) and no other kernel; the async launches are added to
    ``launches``."""
    from repro_torch.core.async_defta import run_async_defta
    from repro_torch.core.defta import evaluate
    from repro_torch.kernels import ops
    from repro_torch.telemetry import RunLedger

    runs = (("fp32 auto", "float32", "auto", "gossip_mix_sparse", {}),
            ("int8+ef auto", "int8", "auto", "gossip_mix_quant", {}),
            ("fp32 pallas", "float32", "pallas", "gossip_mix", {}),
            ("fp32 auto target 3", "float32", "auto", "gossip_mix_sparse",
             {"ticks": 40, "target_epochs": 3, "check_every": 4}))
    for label, wire, backend, kernel, kw in runs:
        data, task, cfg, train = table2_world("vector", wire)
        kw = {"ticks": 20, **kw}
        led = RunLedger()
        ops.reset_launches()
        st, _, mal, _ = run_async_defta(0, task, cfg, train, data,
                                        num_malicious=2,
                                        gossip_backend=backend, ledger=led,
                                        **kw)
        torch.cuda.synchronize()
        counts = dict(ops.LAUNCHES)
        ran = led.rounds_done
        leaves = len(st.params)
        eps = st.epoch.cpu().numpy()[~mal]
        acc, _, _ = evaluate(task, st, data["test_x"], data["test_y"], mal)
        print(f"  async {label:18s} ticks_run={ran}/{kw['ticks']} "
              f"per_tick_ms={1e3 * led.wall_s / ran:.2f} "
              f"epochs={eps.min()}-{eps.max()} vanilla_acc={acc:.4f} "
              f"launches={counts}")
        want = {k: leaves * ran if k == kernel else 0 for k in counts}
        if counts != want:
            fail(f"async {label}: launch counts {counts}, expected {want}")
        if not eps.max() > eps.min():
            fail(f"async {label}: no spread in worker epochs {eps}")
        if not bool(torch.isfinite(st.last_loss).all()):
            fail(f"async {label}: non-finite loss")
        if "target_epochs" in kw and not (
                ran < kw["ticks"] and (eps >= kw["target_epochs"]).all()):
            fail(f"async {label}: ran {ran} ticks, epochs {eps}: expected "
                 f"an early exit at the target")
        launches[kernel] += counts[kernel]


# ---------------------------------------------------------------------------
# Phase 4s: scenarios end to end
# ---------------------------------------------------------------------------

# vanilla accuracy after 20 epochs of the Table 3 world under
# paper_noise@40 must pass this guard; the reference reaches 0.629 in that
# world (benchmarks/table3_robustness.py, run(epochs=20, ks=(40,)), its
# k = 40 row, JAX on the CPU)
TABLE3_ACC_GUARD = 0.3


def run_counted(label, kernel, runs, fn, want_regime=None):
    """Run ``fn()`` (a run_defta or run_async_defta call returning its state
    first and a ledger last) with the counters at 0; check that ``kernel``
    (None: no kernel) launched leaves x ``runs(out)`` times and nothing
    else, and, with ``want_regime``, only in that regime. Returns (out,
    counts)."""
    from repro_torch.kernels import ops
    ops.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    counts, regimes = dict(ops.LAUNCHES), dict(ops.REGIMES)
    st, led = out[0], out[-1]
    n = len(st.params) * runs(led)
    want = {k: n if k == kernel else 0 for k in counts}
    if counts != want:
        fail(f"{label}: launch counts {counts}, expected {want}")
    if want_regime is not None and regimes != {want_regime: n}:
        fail(f"{label}: regimes {regimes}, expected {{{want_regime}: {n}}}")
    if not bool(torch.isfinite(st.last_loss).all()):
        fail(f"{label}: non-finite loss")
    return out, counts


def scenario_end_to_end(launches):
    """Phase 4s on the card; the phase's launches are added to
    ``launches``."""
    from repro_torch.core.async_defta import run_async_defta
    from repro_torch.core.defta import evaluate, run_defta
    from repro_torch.core.gossip import SPARSE_DENSITY_THRESHOLD
    from repro_torch.scenarios import (AttackSpec, ScenarioSpec,
                                       TopologySpec, compile_scenario)
    from repro_torch.telemetry import RunLedger

    data, task, cfg, train = table2_world()
    tx, ty = data["test_x"], data["test_y"]

    def defta(label, kernel, epochs, regime=None, c=cfg, **kw):
        def go():
            led = RunLedger()
            st, _, mal, hist = run_defta(0, task, c, train, data,
                                         epochs=epochs, eval_every=epochs,
                                         test_x=tx, test_y=ty, ledger=led,
                                         **kw)
            return st, mal, hist, led
        (st, mal, hist, led), counts = run_counted(
            label, kernel, lambda led: led.rounds_done, go, regime)
        ms = 1e3 * led.wall_s / epochs
        print(f"  4s {label:28s} W={st.conf.shape[0]} epochs={epochs} "
              f"per_epoch_ms={ms:.2f} vanilla_acc={hist[-1][1]:.4f} "
              f"launches={ {k: v for k, v in counts.items() if v} }",
              flush=True)
        for k, v in counts.items():
            if v:
                launches[k] += v
        return st, hist[-1][1], ms

    # the Table 3 world, scenario and legacy paths, on auto
    for label, kw in (("table3 paper_noise@40 auto",
                       {"scenario": "paper_noise@40"}),
                      ("table3 num_malicious=40 auto",
                       {"num_malicious": 40})):
        _, acc, _ = defta(label, "gossip_mix_sparse", 20,
                          "gossip_mix_sparse/slices", **kw)
        if not acc > TABLE3_ACC_GUARD:
            fail(f"{label}: vanilla accuracy {acc} <= {TABLE3_ACC_GUARD}")
    # W = 60 > GOSSIP_STREAM_MAX_W: the dense mix's tile regime
    defta("table3 paper_noise@40 pallas", "gossip_mix", 10,
          "gossip_mix/tile", scenario="paper_noise@40",
          gossip_backend="pallas")
    # storm on the three wires
    stoch = dataclasses.replace(cfg, gossip_dtype="int8",
                                gossip_wire_round="stochastic")
    for label, kernel, c, be in (
            ("storm fp32 auto", "gossip_mix_sparse", cfg, "auto"),
            ("storm int8+ef stochastic auto", "gossip_mix_quant", stoch,
             "auto"),
            ("storm fp32 pallas", "gossip_mix", cfg, "pallas")):
        st, _, _ = defta(label, kernel, 12, c=c, scenario="storm",
                         gossip_backend=be)
        eps = st.epoch.cpu().numpy()
        if not eps.min() < 12 == eps.max():
            fail(f"{label}: epochs {eps}: the churned worker and the "
                 f"straggler must fall behind")
    # time-varying topologies at W = 60: auto picks by the union's density
    # (two segments stay sparse, five go dense)
    for every in (5, 2):
        spec = ScenarioSpec(attacks=tuple(AttackSpec("noise")
                                          for _ in range(40)),
                            topology=TopologySpec("random_kout", 4,
                                                  every=every))
        sc = compile_scenario(spec, 20, 10)
        union = sc.adj_union | np.eye(sc.num_workers, dtype=bool)
        density = float(union.mean())
        pick, regime = ("gossip_mix_sparse", "slices") \
            if density <= SPARSE_DENSITY_THRESHOLD else ("gossip_mix", "tile")
        print(f"  4s topology every={every}: {sc.num_segments} segments, "
              f"union density {density:.4f} -> auto picks {pick}")
        defta(f"topology every={every} auto", pick, 10,
              f"{pick}/{regime}", scenario=sc)
    # the robust rules: no mix launches
    for rule in ("trimmed_mean", "median", "krum"):
        c = dataclasses.replace(cfg, aggregation=rule, use_dts=False,
                                time_machine=False)
        defta(f"robust {rule}", None, 10, c=c, scenario="paper_noise@40")
    # AsyncDeFTA under storm, with a target that stops it early

    def go():
        led = RunLedger()
        st, _, mal, _ = run_async_defta(0, task, cfg, train, data, ticks=40,
                                        target_epochs=4, check_every=4,
                                        scenario="storm", ledger=led)
        return st, mal, led
    (st, mal, led), counts = run_counted(
        "async storm target 4", "gossip_mix_sparse",
        lambda led: led.rounds_done, go)
    ran = led.rounds_done
    eps = st.epoch.cpu().numpy()[~mal]
    acc, _, _ = evaluate(task, st, tx, ty, mal)
    print(f"  4s async storm target 4       ticks_run={ran}/40 per_tick_ms="
          f"{1e3 * led.wall_s / ran:.2f} epochs={eps.tolist()} "
          f"vanilla_acc={acc:.4f} launches="
          f"{ {k: v for k, v in counts.items() if v} }")
    if not ran < 40:
        fail(f"async storm: ran {ran} ticks, expected an early exit")
    launches["gossip_mix_sparse"] += counts["gossip_mix_sparse"]
    scenario_card_vs_cpu()


def scenario_card_vs_cpu():
    """A reduced storm world (10 vanilla workers, W = 13) on each gossip
    kernel, a krum world (3 noise attackers), and the Table 3 world
    (paper_noise@40, W = 60) on ``pallas``, whose card run must launch the
    dense mix's tile regime only, on the card and on the CPU from one
    initial state and one draw stream."""
    from repro_torch.config import DeFTAConfig, TrainConfig
    from repro_torch.convert import state_from_jax, state_to_numpy
    from repro_torch.core.defta import run_defta
    from repro_torch.core.engine import init_state
    from repro_torch.core.tasks import mlp_task
    from repro_torch.data import federated_dataset
    from repro_torch.kernels import ops
    from repro_torch.scenarios import robust_agg
    task = mlp_task(32, 10)
    train = TrainConfig(learning_rate=0.05, batch_size=16)
    # (scenario, vanilla workers, kernel, config change, backend)
    worlds = (
        ("storm", 10, "gossip_mix_sparse", dict(), "auto"),
        ("storm", 10, "gossip_mix_quant",
         dict(gossip_dtype="int8", gossip_wire_round="stochastic"), "auto"),
        ("storm", 10, "gossip_mix", dict(), "pallas"),
        ("paper_noise@3", 10, "krum", dict(aggregation="krum",
                                           use_dts=False,
                                           time_machine=False), "auto"),
        ("paper_noise@40", 20, "gossip_mix", dict(), "pallas"))
    picks = []
    select = robust_agg.krum_select

    def recording(mask, stacked, trim):
        sel = select(mask, stacked, trim)
        picks[-1].append(sel.cpu().numpy())
        return sel
    robust_agg.krum_select = recording
    try:
        for sc, nv, kernel, change, backend in worlds:
            data = federated_dataset("vector", nv, np.random.default_rng(1),
                                     n_per_worker=48)
            cfg = DeFTAConfig(num_workers=nv, avg_peers=2, num_sampled=1,
                              local_epochs=2, **change)
            w = nv + int(sc.split("@")[1]) if "@" in sc else 13
            gen = torch.Generator()
            gen.manual_seed(0)
            init = state_to_numpy(init_state(
                gen, task, w, wire_error=cfg.gossip_dtype == "int8"))
            res = {}
            for dev in ("cuda", "cpu"):
                picks.append([])
                regimes = dict(ops.REGIMES)
                st, *_ = run_defta(0, task, cfg, train, data, epochs=6,
                                   scenario=sc, gossip_backend=backend,
                                   device=dev, init=state_from_jax(init, dev),
                                   draws=MovedDraws(5, dev))
                res[dev] = state_to_numpy(st)
                if dev == "cuda":
                    ran = {k: v - regimes.get(k, 0)
                           for k, v in ops.REGIMES.items()
                           if v != regimes.get(k, 0)}
            if w > ops.GOSSIP_STREAM_MAX_W and (
                    set(ran) != {"gossip_mix/tile"}):
                fail(f"scenario card run ({sc}, {kernel}, W = {w}): "
                     f"regimes {ran}, expected the dense tile regime only")
            a, b = res["cuda"], res["cpu"]
            wire = "int8" if cfg.gossip_dtype == "int8" else "float32"
            loss_err = float(np.abs(a["last_loss"] - b["last_loss"]).max())
            same_epochs = np.array_equal(a["epoch"], b["epoch"])
            ok = same_epochs and states_agree(a, b, wire)
            if kernel == "krum":
                card_picks, cpu_picks = picks[-2], picks[-1]
                ok = ok and len(card_picks) == 6 and all(
                    np.array_equal(x, y)
                    for x, y in zip(card_picks, cpu_picks))
            print(f"  4s card-vs-cpu {sc:14s} W={w:2d} {kernel:18s} "
                  f"wire={wire:7s} epochs={a['epoch'].tolist()} "
                  f"max|last_loss diff|={loss_err:.3e} agree={ok}")
            if not ok:
                fail(f"scenario card run ({sc}, {kernel}) disagrees with "
                     f"the CPU run (epochs equal: {same_epochs})")
    finally:
        robust_agg.krum_select = select


# ---------------------------------------------------------------------------
# Phase 4t: DTS v2 and v3 trust channels end to end
# ---------------------------------------------------------------------------

TRUST_SIGNALS = ("loss", "geom", "both", "corr", "all")


def filled_slots(sketch) -> np.ndarray:
    """Per worker, the ring-buffer slots that hold a sketch."""
    return (sketch.abs().amax(dim=2) > 0).sum(dim=1).cpu().numpy()


def trust_end_to_end(launches):
    """Phase 4t on the card; the phase's launches are added to
    ``launches``."""
    from repro_torch.config import DeFTAConfig
    from repro_torch.core.async_defta import run_async_defta
    from repro_torch.core.defta import evaluate, run_defta
    from repro_torch.data import federated_dataset
    from repro_torch.scenarios import AttackSpec, ScenarioSpec
    from repro_torch.telemetry import RunLedger

    def defta(label, kernel, regime, epochs, cfg, data, task, train, spec,
              **kw):
        def go():
            led = RunLedger()
            st, adj, mal, hist = run_defta(
                0, task, cfg, train, data, epochs=epochs, scenario=spec,
                eval_every=epochs, test_x=data["test_x"],
                test_y=data["test_y"], ledger=led, **kw)
            return st, adj, mal, hist, led
        (st, adj, mal, hist, led), counts = run_counted(
            label, kernel, lambda led: led.rounds_done, go, regime)
        if not bool(torch.isfinite(st.conf).all()):
            fail(f"{label}: non-finite conf")
        corr = cfg.dts_signal in ("corr", "all")
        if corr != (st.sketch is not None):
            fail(f"{label}: sketch {st.sketch is not None}, expected {corr}")
        if corr:
            want = np.minimum(st.epoch.cpu().numpy(), cfg.dts_sketch_rounds)
            if not np.array_equal(filled_slots(st.sketch), want):
                fail(f"{label}: ring-buffer slots filled "
                     f"{filled_slots(st.sketch)}, expected {want}")
        n = sum(counts.values())
        print(f"  4t {label:28s} W={st.conf.shape[0]} epochs={epochs} "
              f"per_epoch_ms={1e3 * led.wall_s / epochs:.2f} "
              f"launches_per_epoch={n / epochs:g} "
              f"vanilla_acc={hist[-1][1]:.4f} attacker_theta="
              f"{theta_share(st, adj, mal):.3f}", flush=True)
        for k, v in counts.items():
            if v:
                launches[k] += v
        return st

    # the trust grid's world (table_trust.py: k = 8 on 20 vanilla workers)
    from repro_torch.config import TrainConfig
    from repro_torch.core.tasks import mlp_task
    task = mlp_task(32, 10)
    train = TrainConfig(learning_rate=0.05, batch_size=32)
    data = federated_dataset("vector", 20, np.random.default_rng(0),
                             n_per_worker=120, alpha=0.5)
    for attack in ("alie", "label_flip"):
        spec = ScenarioSpec(attacks=tuple(AttackSpec(attack)
                                          for _ in range(8)))
        for signal in TRUST_SIGNALS:
            cfg = DeFTAConfig(num_workers=20, avg_peers=4, num_sampled=2,
                              local_epochs=3, dts_signal=signal, seed=0)
            defta(f"grid {attack} {signal}", "gossip_mix_sparse",
                  "gossip_mix_sparse/slices", 10, cfg, data, task, train,
                  spec)
    # the Table 3 world at full width under alie colluders (loss beside
    # all, in one call, for the trust stage's cost)
    t3_data, t3_task, t3_cfg, t3_train = table2_world()
    t3_cfg = dataclasses.replace(t3_cfg, dts_signal="all")
    spec = ScenarioSpec(attacks=tuple(AttackSpec("alie") for _ in range(40)))
    for label, kernel, regime, backend, signal in (
            ("table3 alie@40 loss auto", "gossip_mix_sparse",
             "gossip_mix_sparse/slices", "auto", "loss"),
            ("table3 alie@40 all auto", "gossip_mix_sparse",
             "gossip_mix_sparse/slices", "auto", "all"),
            ("table3 alie@40 all pallas", "gossip_mix", "gossip_mix/tile",
             "pallas", "all")):
        defta(label, kernel, regime, 10,
              dataclasses.replace(t3_cfg, dts_signal=signal), t3_data,
              t3_task, t3_train, spec, gossip_backend=backend)

    # async storm: a ring buffer deeper than the run, so a worker's filled
    # slots must equal the rounds it completed

    def go():
        led = RunLedger()
        st, _, mal, _ = run_async_defta(
            0, t3_task, dataclasses.replace(t3_cfg, dts_sketch_rounds=24),
            t3_train, t3_data, ticks=20, scenario="storm", ledger=led)
        return st, mal, led
    (st, mal, led), counts = run_counted(
        "async storm all", "gossip_mix_sparse", lambda led: led.rounds_done,
        go)
    eps = st.epoch.cpu().numpy()
    filled = filled_slots(st.sketch)
    acc, _, _ = evaluate(t3_task, st, t3_data["test_x"], t3_data["test_y"],
                         mal)
    print(f"  4t async storm all            ticks_run={led.rounds_done}/20 "
          f"per_tick_ms={1e3 * led.wall_s / led.rounds_done:.2f} "
          f"epochs={eps.tolist()} filled={filled.tolist()} "
          f"vanilla_acc={acc:.4f}", flush=True)
    if not np.array_equal(filled, eps) or not eps.min() < eps.max():
        fail(f"async storm all: ring-buffer slots {filled.tolist()} must "
             f"equal the epochs {eps.tolist()}, which must spread")
    launches["gossip_mix_sparse"] += counts["gossip_mix_sparse"]
    trust_card_vs_cpu()
    trust_stage_no_sync()


def trust_stage_no_sync():
    """The trust functions at the Table 3 world's shapes (W = 60, D =
    2,762, R = 8, S = 64) make no host synchronisation (a later CUDA
    graph of the round needs none): one warm call, then one under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    from repro_torch.core import dts
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    w, d = 60, 2762
    deltas = torch.randn(w, d, device="cuda", generator=gen)
    mask = torch.rand(w, w, device="cuda", generator=gen) < 0.1
    theta = dts.sample_weights(torch.zeros(w, w, device="cuda"), mask)
    hist = torch.zeros(w, 8, 64, device="cuda")
    conf = torch.zeros(w, w, device="cuda")
    damaged = torch.zeros(w, dtype=torch.bool, device="cuda")

    def stage():
        sk = dts.update_sketch(hist, deltas)
        return dts.geom_confidence_update(
            "all", 1.0, conf, mask, theta, conf[0], damaged, deltas, mask,
            theta, sketch=sk, lam_corr=4.0), sk
    stage()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, sk = stage()
    except RuntimeError as e:
        fail(f"the trust stage synchronises with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out).all()) or not bool(sk[:, -1].any()):
        fail("the trust stage's check gave a non-finite conf or no sketch")
    print("  4t trust stage (all, W=60, D=2762): no host synchronisation",
          flush=True)


def theta_share(st, adj, malicious) -> float:
    """Mean sampling-weight mass the honest workers place on attackers."""
    from repro_torch.core import dts
    theta = dts.sample_weights(
        st.conf, torch.as_tensor(adj).to(st.conf.device)).cpu().numpy()
    return float(theta[~malicious][:, malicious].sum(axis=1).mean())


def trust_card_vs_cpu():
    """``port_robustness_demo``'s world with ``all``, 6 epochs, on the card
    and on the CPU from one initial state and one draw stream. The CPU
    run's sketch projections are recorded to count the buckets whose sign
    may differ (|projection| < 1e-5 of its row's norm)."""
    from repro_torch.config import DeFTAConfig, TrainConfig
    from repro_torch.convert import state_from_jax, state_to_numpy
    from repro_torch.core import dts
    from repro_torch.core.defta import run_defta
    from repro_torch.core.engine import init_state, sketch_shape
    from repro_torch.core.tasks import mlp_task
    from repro_torch.data import federated_dataset
    from repro_torch.scenarios import (AttackSpec, ScenarioSpec,
                                       StragglerSpec)
    spec = ScenarioSpec(attacks=tuple(AttackSpec("alie") for _ in range(4)),
                        stragglers=(StragglerSpec(worker=5, speed=0.5),))
    data = federated_dataset("vector", 12, np.random.default_rng(0),
                             n_per_worker=120, alpha=0.5)
    task = mlp_task(32, 10)
    cfg = DeFTAConfig(num_workers=12, avg_peers=4, num_sampled=2,
                      local_epochs=3, dts_signal="all")
    train = TrainConfig(learning_rate=0.05, batch_size=32)
    gen = torch.Generator()
    gen.manual_seed(0)
    init = state_to_numpy(init_state(gen, task, 16,
                                     sketch=sketch_shape(cfg)))
    near_zero = {"cuda": 0, "cpu": 0}
    sketch_deltas = dts.sketch_deltas

    def recording(deltas, sketch_dim, *, seed=0):
        m = dts._sketch_matrix(seed, deltas.shape[1], sketch_dim,
                               deltas.device)
        proj = deltas @ m
        near = proj.abs() < 1e-5 * deltas.norm(dim=1, keepdim=True)
        near_zero[deltas.device.type] += int(near.sum())
        return sketch_deltas(deltas, sketch_dim, seed=seed)
    dts.sketch_deltas = recording
    res = {}
    try:
        for dev in ("cuda", "cpu"):
            st, *_ = run_defta(0, task, cfg, train, data, epochs=6,
                               scenario=spec, device=dev,
                               init=state_from_jax(init, dev),
                               draws=MovedDraws(5, dev))
            res[dev] = state_to_numpy(st)
    finally:
        dts.sketch_deltas = sketch_deltas
    a, b = res["cuda"], res["cpu"]
    errs = {f: float(np.abs(a[f] - b[f]).max())
            for f in ("conf", "last_loss", "best_loss")}
    errs["params"] = max(float(np.abs(a["params"][k] - b["params"][k]).max())
                         for k in a["params"])
    differ = int((a["sketch"] != b["sketch"]).sum())
    same_epochs = np.array_equal(a["epoch"], b["epoch"])
    ok = same_epochs and max(errs["conf"], errs["last_loss"],
                             errs["best_loss"]) <= 1e-4 \
        and differ <= max(near_zero.values())
    print(f"  4t card-vs-cpu demo world all W=16 epochs="
          f"{a['epoch'].tolist()} max|diff| "
          + " ".join(f"{k}={v:.3e}" for k, v in errs.items())
          + f" sketch entries differing={differ} (near-zero buckets: card "
          f"{near_zero['cuda']}, cpu {near_zero['cpu']}) agree={ok}",
          flush=True)
    if not ok:
        fail(f"trust card run disagrees with the CPU run (epochs equal: "
             f"{same_epochs}, errors {errs}, sketch entries differing "
             f"{differ})")


# ---------------------------------------------------------------------------
# Phase 5: serving end to end
# ---------------------------------------------------------------------------

def n_params(tree) -> int:
    return sum(n_params(v) if isinstance(v, dict) else v.numel()
               for v in tree.values())


def to_device(tree, dev):
    return {k: to_device(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


def wall_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def prefill_launches(prefill, params, batch, vocab, want_counts, calls):
    """``calls`` prefill calls, each checked for exactly ``want_counts``
    kernel launches (0 for the others) and finite logits of shape
    batch + (vocab,); returns the wall ms of each."""
    from repro_torch.kernels import ops
    times = []
    bs = tuple(batch["tokens"].shape)
    for _ in range(calls):
        before = dict(ops.LAUNCHES)
        logits, ms = wall_ms(lambda: prefill(params, batch))
        times.append(ms)
        delta = {k: ops.LAUNCHES[k] - before[k] for k in ops.LAUNCHES}
        want = {k: want_counts.get(k, 0) for k in ops.LAUNCHES}
        if delta != want:
            fail(f"prefill {bs}: launches {delta}, expected {want}")
        if tuple(logits.shape) != bs + (vocab,) \
                or not bool(torch.isfinite(logits).all()):
            fail(f"prefill {bs}: logits {tuple(logits.shape)} not finite or "
                 f"of the wrong shape")
        del logits
    return times


def serve_full(dev):
    """DeepSeekMoE-16B at full width and depth: init, two prefill shapes,
    the serve loop; returns the serving kernels' launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models import model

    cfg = get_config("deepseek-moe-16b")
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params, init_ms = wall_ms(lambda: model.init_params(gen, cfg))
    n = n_params(params)
    print(f"  deepseek-moe-16b: {n} parameters ({cfg.dtype}), init "
          f"{init_ms / 1e3:.2f}s, peak memory after init "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    if n != n_params(model.abstract_params(cfg)):
        fail(f"parameter count {n}")
    prefill = build_prefill_step(cfg)
    shapes = ((4, 512), (1, 4096))
    batches = {bs: {"tokens": torch.randint(0, cfg.vocab_size, bs,
                                            generator=gen, device=dev)}
               for bs in shapes}
    prompts = torch.randint(0, cfg.vocab_size, (4, 32), generator=gen,
                            device=dev)
    for bs in shapes:                                # warm-up, not counted
        prefill(params, batches[bs])
    serve.generate(params, cfg, prompts[:, :2], 2)

    ops.reset_launches()
    for bs in shapes:
        times = prefill_launches(prefill, params, batches[bs],
                                 cfg.vocab_size, {"flash_attention_tc": 28,
                                                  "moe_route_slots": 27}, 3)
        print(f"  prefill B={bs[0]} S={bs[1]}: wall_ms="
              f"{[round(x, 2) for x in times]} launches per call: 28 "
              f"tensor-core flash, 0 SIMT flash, 27 route-and-slot, 0 "
              f"router")
    before = dict(ops.LAUNCHES)
    tokens, st = serve.generate(params, cfg, prompts, 32)
    delta = {k: ops.LAUNCHES[k] - before[k] for k in ops.LAUNCHES}
    steps = 32 + 32                  # prompt steps + new tokens
    want = {k: 0 for k in ops.LAUNCHES}
    want["moe_router"] = 27 * steps
    if delta != want:
        fail(f"serve loop: launches {delta}, expected {want}")
    if tuple(tokens.shape) != (4, 32) or int(tokens.min()) < 0 \
            or int(tokens.max()) >= cfg.vocab_size:
        fail("serve loop: bad tokens")
    print(f"  serve batch=4 prompt=32 new=32 greedy: prefill "
          f"{st['prefill_s']:.3f}s, decode {st['decode_s']:.3f}s, "
          f"{st['tok_per_s']:.1f} tok/s, {st['decode_s'] / 32 * 1e3:.2f} "
          f"ms/step; launches {delta}")
    print(f"  peak memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    counts = {k: ops.LAUNCHES[k] for k in SERVING}
    del params
    torch.cuda.empty_cache()
    return counts


def serve_reduced_card_vs_cpu(dev, arch, seq, attention):
    """A reduced ``arch`` (f32) from one set of parameters on the card
    (kernels) and on the CPU (plain versions): prefill logits of 3 x
    ``seq`` tokens within 1e-4 (summation order: cuBLAS vs CPU GEMMs, the
    kernels vs their plain versions), equal greedy tokens, and on the card
    teacher-forced decode equal to the prefill within 2e-3
    (tests/test_arch_smoke.py's bound). Returns the kernel launches of
    these runs (counts set to 0 just before them): with ``attention``,
    SIMT flash launches (f32 attention runs the SIMT kernel), and never a
    tensor-core flash launch."""
    from repro_torch.kernels import ops
    from repro_torch.config import reduced
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.launch.steps import build_decode_step, \
        build_prefill_step
    from repro_torch.models import model

    cfg = reduced(get_config(arch))
    gen = torch.Generator()
    gen.manual_seed(1)
    ops.reset_launches()
    cpu_params = model.init_params(gen, cfg)
    card_params = to_device(cpu_params, dev)
    tokens = torch.randint(0, cfg.vocab_size, (3, seq), generator=gen)
    prefill = build_prefill_step(cfg)
    a = prefill(card_params, {"tokens": tokens.to(dev)}).cpu()
    b = prefill(cpu_params, {"tokens": tokens})
    err = float((a - b).abs().max())
    ga, _ = serve.generate(card_params, cfg, tokens[:, :8].to(dev), 12)
    gb, _ = serve.generate(cpu_params, cfg, tokens[:, :8], 12)
    same = bool(torch.equal(ga.cpu(), gb))
    full = build_prefill_step(cfg, moe_strategy="dense")(
        card_params, {"tokens": tokens.to(dev)})
    decode = build_decode_step(cfg)
    cache = model.init_cache(cfg, 3, seq, device=dev)
    tf_err = 0.0
    for t in range(seq):
        lg, cache = decode(card_params, tokens[:, t:t + 1].to(dev), cache, t)
        tf_err = max(tf_err, float((lg[:, 0] - full[:, t]).abs().max()))
    print(f"  reduced {arch} f32 S={seq} card-vs-cpu: max|logit diff|="
          f"{err:.3e} (tol 1e-4), greedy tokens equal={same}; teacher-forced "
          f"decode vs prefill on the card max diff={tf_err:.3e} (tol 2e-3)")
    if not (err <= 1e-4 and same and tf_err < 2e-3):
        fail(f"reduced {arch}: card and CPU disagree")
    counts = dict(ops.LAUNCHES)
    print(f"  reduced {arch} card launches: {counts}")
    if counts["flash_attention_tc"] or bool(counts["flash_attention"]) \
            != attention:
        fail(f"reduced {arch} (f32): flash launches {counts}, expected SIMT "
             f"launches only")
    return counts


# ---------------------------------------------------------------------------
# Phases 6 and 7: the ssm and hybrid families
# ---------------------------------------------------------------------------

def serve_mamba2(dev):
    """Mamba2-780M at full width and depth (48 layers, bf16, random
    weights from seed 0): init on the card, prefill at B=4/S=2048 (G = 32)
    and B=1/S=16384 (G = 64), 3 calls each after a warm-up with 48
    ssd_chunk_tc launches per call and nothing else (no SIMT ssd_chunk),
    then the serve loop at its defaults, which launches no kernel (decode
    is the plain recurrence). Returns both SSD kernels' launches of the
    prefill calls."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models import model

    cfg = get_config("mamba2-780m")
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params, init_ms = wall_ms(lambda: model.init_params(gen, cfg))
    n = n_params(params)
    print(f"  mamba2-780m: {n} parameters ({cfg.dtype}), init "
          f"{init_ms / 1e3:.2f}s, peak memory after init "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    if n != MAMBA2_PARAMS or n != n_params(model.abstract_params(cfg)):
        fail(f"mamba2-780m parameter count {n}, expected {MAMBA2_PARAMS}")
    prefill = build_prefill_step(cfg)
    shapes = ((4, 2048), (1, 16384))
    batches = {bs: {"tokens": torch.randint(0, cfg.vocab_size, bs,
                                            generator=gen, device=dev)}
               for bs in shapes}
    prompts = torch.randint(0, cfg.vocab_size, (4, 32), generator=gen,
                            device=dev)
    for bs in shapes:                                # warm-up, not counted
        prefill(params, batches[bs])
    serve.generate(params, cfg, prompts[:, :2], 2)

    ops.reset_launches()
    for bs in shapes:
        times = prefill_launches(prefill, params, batches[bs],
                                 cfg.vocab_size, {"ssd_chunk_tc": 48}, 3)
        print(f"  prefill B={bs[0]} S={bs[1]}: wall_ms="
              f"{[round(x, 2) for x in times]} launches per call: 48 "
              f"ssd_chunk_tc, 0 SIMT ssd_chunk")
    counts = {k: ops.LAUNCHES[k] for k in ("ssd_chunk", "ssd_chunk_tc")}
    before = dict(ops.LAUNCHES)
    tokens, st = serve.generate(params, cfg, prompts, 32)
    delta = {k: ops.LAUNCHES[k] - before[k] for k in ops.LAUNCHES}
    if any(delta.values()):
        fail(f"mamba2 serve loop: launches {delta}, expected none")
    if tuple(tokens.shape) != (4, 32) or int(tokens.min()) < 0 \
            or int(tokens.max()) >= cfg.vocab_size:
        fail("mamba2 serve loop: bad tokens")
    print(f"  serve batch=4 prompt=32 new=32 greedy: prefill "
          f"{st['prefill_s']:.3f}s, decode {st['decode_s']:.3f}s, "
          f"{st['tok_per_s']:.1f} tok/s, {st['decode_s'] / 32 * 1e3:.2f} "
          f"ms/step; launches {delta}")
    print(f"  peak memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    del params
    torch.cuda.empty_cache()
    return counts


def prefill_jamba_period(dev):
    """Jamba at full width cut to one 8-layer period (mamba, mamba_moe,
    mamba, mamba_moe, attn_dense, mamba_moe, mamba, mamba_moe; 13.3B
    parameters, bf16: the whole 32 layers, ~104 GB, do not fit one card):
    two prefill calls at B=1, S=4096, each with 7 ssd_chunk_tc (0 SIMT
    ssd_chunk), 1 flash and 4 route-and-slot launches (0 router)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models import model

    cfg = dataclasses.replace(get_config("jamba-v0.1-52b"), num_layers=8)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params, init_ms = wall_ms(lambda: model.init_params(gen, cfg))
    n = n_params(params)
    print(f"  jamba-v0.1-52b, one period: {n} parameters ({cfg.dtype}), "
          f"schedule {cfg.block_schedule()}, init {init_ms / 1e3:.2f}s")
    if n != JAMBA_PERIOD_PARAMS:
        fail(f"jamba period parameter count {n}, expected "
             f"{JAMBA_PERIOD_PARAMS}")
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, 4096),
                                     generator=gen, device=dev)}
    times = prefill_launches(build_prefill_step(cfg), params, batch,
                             cfg.vocab_size, {"ssd_chunk_tc": 7,
                                              "flash_attention_tc": 1,
                                              "moe_route_slots": 4}, 2)
    print(f"  prefill B=1 S=4096: wall_ms={[round(x, 2) for x in times]} "
          f"(the first is a cold call) launches per call: 7 ssd_chunk_tc, 1 "
          f"tensor-core flash, 4 route-and-slot; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    del params
    torch.cuda.empty_cache()


def spills(log: str) -> dict:
    """{entry function: spilled bytes (stores + loads)} from ptxas -v."""
    out, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            entry = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and entry is not None:
            out[entry] = int(m.group(1)) + int(m.group(2))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build

    dev = resolve_device(None)
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}",
          flush=True)

    t0 = time.perf_counter()
    report = build.build()
    print(f"[1] build: {time.perf_counter() - t0:.1f}s wall "
          + ", ".join(f"{k} {v['seconds']:.1f}s" for k, v in report.items()))
    for name, r in report.items():
        for line in r["log"].splitlines():
            if any(w in line.lower() for w in ("registers", "spill",
                                                "warning")):
                print(f"  ptxas {name}: {line.strip()}")
        for entry, spilled in spills(r["log"]).items():
            if spilled and (name == "ssd_chunk_tc" or (
                    name == "gossip_mix" and "tile_mix_kernel" in entry)):
                fail(f"{name} spills registers in {entry}")

    print("[2] kernels vs plain versions", flush=True)
    max_err = check_kernels(dev)
    check_sparse_nonfinite(dev)
    max_err.update(check_flash(dev))
    max_err["moe_router"] = check_router(dev)
    max_err["moe_route_slots"] = check_route_slots(dev)
    check_grouped_capture(dev)
    max_err.update(check_ssd(dev))

    print("[3] timings", flush=True)
    main_t = time_kernels(dev, "main", 22, 4, 2048)
    time_kernels(dev, "T3", 60, 4, 2048)    # the dense mix's tile regime
    time_kernels(dev, "w500", 500, 24, 4096)
    main_t.update(time_serving_kernels(dev))
    main_t.update(time_route_slots(dev))
    main_t.update(time_ssd(dev))

    print("[4] DeFTA, FedAvg and AsyncDeFTA end to end", flush=True)
    card_vs_cpu()
    launches = end_to_end()
    fedavg_end_to_end()
    async_end_to_end(launches)

    print("[4s] scenarios end to end", flush=True)
    scenario_end_to_end(launches)

    print("[4t] DTS v2 and v3 trust channels end to end", flush=True)
    trust_end_to_end(launches)

    print("[5] serving end to end", flush=True)
    launches.update(serve_full(dev))
    # f32 attention keeps the SIMT flash kernel: its path is the reduced
    # f32 model served on the card
    launches["flash_attention"] = serve_reduced_card_vs_cpu(
        dev, "deepseek-moe-16b", 24, attention=True)["flash_attention"]

    print("[6] serving mamba2-780m end to end", flush=True)
    launches.update(serve_mamba2(dev))
    reduced = serve_reduced_card_vs_cpu(dev, "mamba2-780m", 40,
                                        attention=False)
    if not reduced["ssd_chunk_tc"] or reduced["ssd_chunk"]:
        fail(f"reduced mamba2 (N = 16, P = 32): SSD launches {reduced}, "
             f"expected ssd_chunk_tc only")

    print("[7] jamba, one period at full width", flush=True)
    prefill_jamba_period(dev)

    kernels = [dict(name=k, route="cuda", source=SOURCES[k],
                    replaces=REPLACES[k], launches=launches[k],
                    max_abs_err=max_err[k], **main_t[k]) for k in REPLACES]
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
