"""The kernel bench on the PyTorch port: the port's version of
``benchmarks/kernel_bench.py``.

    PYTHONPATH=src python benchmarks/port_kernel_bench.py [--out PATH]
    PYTHONPATH=src python benchmarks/port_kernel_bench.py --device cpu --fast

``run()`` times four kernel rows (the reference's ``run``): the dense mix
at [20, 20] x [20, 65536] (its stream regime), flash attention at f32 [1,
4, 512, 64] (the SIMT kernel), the router at T = 2048, E = 64, k = 6 (f32)
and ``ssd_chunk`` at [G, H, T, N, P] = [4, 4, 128, 64, 64]
(``ssd_chunk_tc``): kernel us, plain us and, where one PyTorch call
computes the same function, that call's us (``torch.matmul``,
``scaled_dot_product_attention``), each beside its bound.

``bench_gossip`` times the dense, sparse and int8 mixes and
``torch.matmul`` (the reference's einsum) over W in {20, 100, 500} x
density in {0.05, 0.3, 1.0} at F = 4096 on the reference's numpy-seeded
adjacency, with the wire bytes of each exchange
(``roofline.gossip_wire_bytes``), then runs the contract benches and
assembles the reference's payload: ``superstep``, ``quant_convergence``,
``scenario_overhead``, ``fedavg_dispatch``, ``geom_trust``,
``corr_trust``, ``telemetry`` (this file), ``trust_grid``
(``port_table_trust.sweep``), ``cross_device`` (``port_cross_device``),
``w_scaling`` (``port_shard_scaling``) and ``privacy``
(``port_secagg``), each called at its defaults, plus ``card`` (the
card's name and power limit). It writes ``BENCH_port_gossip.json`` at the
repo's root (``--out``), which ``port_bench_guard.py`` reads.

The reference's "dispatches" are the port's host chunks
(``RunLedger.dispatches``, ``core.engine.drive_epochs``), and its
dispatch-parity contract is two checks here: equal chunk counts, and
equal kernel launches a round across the variants (on the card
``kernels.ops.LAUNCHES``; on the CPU the wrappers' calls, as the counting
pass ``repro_torch.counting`` records them).

Times on the card are device times: back-to-back calls captured in one
CUDA graph, replayed between CUDA events (the median of the replays).
``--device cpu`` runs the kernels' plain versions and times them by the
reference's estimator (best of wall-clock runs); ``--fast`` cuts every
epoch count for a rehearsal. Imports nothing of JAX or of the ``repro``
package.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "benchmarks"))

from port_table2 import card_line  # noqa: E402
from repro_torch import counting, sharding  # noqa: E402
from repro_torch.config import DeFTAConfig, TrainConfig  # noqa: E402
from repro_torch.core.defta import (attacker_world, initial_state,  # noqa
                                    run_defta, scenario_world,
                                    to_device_data)
from repro_torch.core.engine import build_defta_round, drive_epochs  # noqa
from repro_torch.core.fedavg import evaluate_server, run_fedavg  # noqa
from repro_torch.core.gossip import quantize_rows_int8, sparse_weights  # noqa
from repro_torch.core.tasks import mlp_task  # noqa: E402
from repro_torch.core.topology import make_topology  # noqa: E402
from repro_torch.data import federated_dataset  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.rng import TorchDraws  # noqa: E402
from repro_torch.scenarios import (AttackSpec, ChurnSpec,  # noqa: E402
                                   ScenarioSpec, StragglerSpec,
                                   compile_scenario)
from repro_torch.telemetry import RunLedger, Telemetry  # noqa: E402
from repro_torch.telemetry.spec import defta_specs, frame_bytes  # noqa

OUT = ROOT / "BENCH_port_gossip.json"
GRAPH_CALLS = 20            # back-to-back calls in one timed CUDA graph


# ---------------------------------------------------------------------------
# Timing and counting
# ---------------------------------------------------------------------------

def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_us(fn, dev, iters: int = 9) -> float:
    """Microseconds per call of ``fn``. On the card: ``GRAPH_CALLS``
    back-to-back calls captured in one CUDA graph after a warm-up, the
    median over ``iters`` replays timed by CUDA events. On the CPU: the
    best of ``iters`` wall-clock runs after one warm-up (the reference's
    estimator)."""
    if dev.type != "cuda":
        fn()
        best = float("inf")
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        return best * 1e6
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(GRAPH_CALLS):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) * 1e3 / GRAPH_CALLS)
    return statistics.median(times)


def counted(fn, dev):
    """``fn()``'s result and its kernel calls by name: on the card the
    launches (``ops.LAUNCHES``), on the CPU the wrappers' calls as the
    counting pass records them."""
    if dev.type == "cuda":
        before = dict(ops.LAUNCHES)
        out = fn()
        torch.cuda.synchronize(dev)
        return out, {k: v - before[k] for k, v in ops.LAUNCHES.items()
                     if v != before[k]}
    with counting.Counter() as c:
        out = fn()
    return out, dict(c.calls)


def per_round(calls: dict, rounds: int) -> dict:
    return {k: v / rounds for k, v in sorted(calls.items())}


def interleaved_best(runners, iters: int = 3):
    """Best-of-``iters`` seconds for each runner, the timed runs
    interleaved round-robin (a, b, a, b, ...), as the reference's
    ``_interleaved_best``: the ratios between runners then sample the
    same machine states."""
    best = [float("inf")] * len(runners)
    for _ in range(iters):
        for i, run in enumerate(runners):
            t0 = time.perf_counter()
            run()
            best[i] = min(best[i], time.perf_counter() - t0)
    return best


# ---------------------------------------------------------------------------
# The gossip sweep
# ---------------------------------------------------------------------------

def reference_adjacency(w: int, density: float) -> np.ndarray:
    """The reference bench's topology at (W, density): ``k_peers`` =
    max(1, round(density W) - 1) out-peers a worker drawn without
    replacement from ``default_rng(W)``, no self-loops."""
    rng = np.random.default_rng(w)
    k_peers = max(1, round(density * w) - 1)
    adj = np.zeros((w, w), bool)
    for i in range(w):
        peers = rng.choice([j for j in range(w) if j != i],
                           size=min(k_peers, w - 1), replace=False)
        adj[i, peers] = True
    return adj


def gossip_cell(w: int, density: float, f: int, dev, *, timed=True,
                iters: int = 9):
    """One cell of the sweep: the three mixes and ``torch.matmul`` on the
    reference's adjacency with self-loops and a uniform row-stochastic P,
    a [W, F] f32 stack from a generator seeded W (its int8 rows for the
    quantized mix). Errors: the sparse and dense mixes against the plain
    dense product, the int8 mix against its plain version
    (``quant_kernel_err``, beside ``quant_step``, its coarsest row's
    quantization step) and against the fp32 product (the wire's error)."""
    adj = reference_adjacency(w, density)
    P = (adj | np.eye(w, dtype=bool)).astype(np.float32)
    P /= P.sum(1, keepdims=True)
    P = torch.tensor(P, device=dev)
    idx, val = sparse_weights(P, adj)
    val = val.contiguous()
    gen = torch.Generator(device=dev)
    gen.manual_seed(w)
    stack = torch.randn(w, f, generator=gen, device=dev)
    q, scale = quantize_rows_int8(stack)
    calls = {
        "dense": lambda: ops.gossip_mix(P, stack),
        "sparse": lambda: ops.gossip_mix_sparse(idx, val, stack),
        "quant": lambda: ops.gossip_mix_quant(idx, val, scale, q),
    }
    outs, launches = {}, {}
    for name, fn in calls.items():
        outs[name], launches[name] = counted(fn, dev)
    want = ref.gossip_mix_ref(P, stack)
    want_q = ref.gossip_mix_quant_ref(idx, val, scale, q)
    k = int(idx.shape[1])
    nnz = int(adj.sum())
    wire_mb = {fmt or "fp32": nnz * roofline.gossip_wire_bytes(
        f, fmt, rows=1) / 1e6 for fmt in (None, "bf16", "int8")}
    wire_mb["dense_fp32"] = w * (w - 1) * roofline.gossip_wire_bytes(f) / 1e6
    row = dict(
        W=w, density=density, K=k, nnz=nnz,
        max_err=float((outs["sparse"] - want).abs().max()),
        dense_err=float((outs["dense"] - want).abs().max()),
        quant_kernel_err=float((outs["quant"] - want_q).abs().max()),
        quant_wire_err=float((outs["quant"] - want).abs().max()),
        quant_step=float(scale.max()),
        wire_mb=wire_mb,
        int8_fp32_byte_ratio=wire_mb["int8"] / wire_mb["fp32"],
        launches={n: dict(v) for n, v in launches.items()})
    if not timed:
        return row
    csr = torch.sparse_coo_tensor(
        torch.stack([torch.arange(w, device=dev).repeat_interleave(k),
                     idx.reshape(-1).long()]), val.reshape(-1),
        (w, w)).coalesce().to_sparse_csr()
    regime = ops.gossip_mix_plan(w, f, stack.dtype)[0]
    nnz_slots = int((val != 0).sum())
    row.update(
        dense_us=device_us(calls["dense"], dev, iters),
        sparse_us=device_us(calls["sparse"], dev, iters),
        quant_us=device_us(calls["quant"], dev, iters),
        einsum_us=device_us(lambda: torch.matmul(P, stack), dev, iters),
        sparse_library_us=device_us(lambda: torch.sparse.mm(csr, stack),
                                    dev, iters),
        dense_regime=regime,
        bound_us={
            "dense": 1e3 * roofline.bound("gossip_mix", w, None, None, f,
                                          4, regime == "tile")[0],
            "sparse": 1e3 * roofline.bound("gossip_mix_sparse", w,
                                           nnz_slots, k, f, 4)[0],
            "quant": 1e3 * roofline.bound("gossip_mix_quant", w,
                                          nnz_slots, k, f, 1)[0]})
    return row


def gossip_rows(f: int = 4096, device="cuda", *, widths=(20, 100, 500),
                densities=(0.05, 0.3, 1.0), timed=True):
    """The sweep's rows (``gossip_cell``); the W = 500 / density 0.05 cell
    (the guard's headline) takes 15 timed replays, the others 9."""
    dev = resolve_device(device)
    rows = []
    for w in widths:
        for density in densities:
            row = gossip_cell(w, density, f, dev, timed=timed,
                              iters=15 if (w, density) == (500, 0.05)
                              else 9)
            rows.append(row)
            times = "" if not timed else (
                f" dense={row['dense_us']:9.2f}us sparse="
                f"{row['sparse_us']:9.2f}us quant={row['quant_us']:9.2f}us"
                f" einsum={row['einsum_us']:9.2f}us")
            print(f"gossip W={w:4d} density={density:.2f} K={row['K']:3d}"
                  f"{times} err={row['max_err']:.2e} int8_bytes="
                  f"{row['wire_mb']['int8']:.1f}MB "
                  f"({row['int8_fp32_byte_ratio']:.2f}x fp32)", flush=True)
    return rows


# ---------------------------------------------------------------------------
# The contract benches (the reference's worlds)
# ---------------------------------------------------------------------------

def small_world(w: int, avg_peers: int = 2, num_sampled: int = 1,
                local_epochs: int = 1, **cfg_kw):
    """The reference benches' world: MLP 32 -> 10, non-iid (α = 0.5)
    shards of 64 examples from seed 0, lr 0.05, batch 32."""
    data = federated_dataset("vector", w, np.random.default_rng(0),
                             n_per_worker=64, alpha=0.5)
    cfg = DeFTAConfig(num_workers=w, avg_peers=avg_peers,
                      num_sampled=num_sampled, local_epochs=local_epochs,
                      **cfg_kw)
    return data, mlp_task(32, 10), cfg, TrainConfig(learning_rate=0.05,
                                                    batch_size=32)


def _no_hooks(kind):
    return {}


def bench_superstep(epochs: int = 200, eval_every: int = 50, device="cuda",
                    hooks=_no_hooks):
    """The chunked driver's contract: an ``epochs`` run evaluated every
    ``eval_every`` epochs is at most ceil(epochs / eval_every) host chunks,
    and its losses equal a one-epoch-a-chunk run's (max delta < 1e-4).
    ``hooks(kind)`` gives extra ``run_defta`` keywords for each run (the
    tests' ``init`` and ``draws``)."""
    dev = resolve_device(device)
    data, task, cfg, train = small_world(4)
    runs = {}
    for name, every in (("fused", eval_every), ("per_epoch", 1)):
        led = RunLedger()
        t0 = time.perf_counter()
        st, *_ = run_defta(0, task, cfg, train, data, epochs=epochs,
                           eval_every=every, test_x=data["test_x"],
                           test_y=data["test_y"], ledger=led, probes=False,
                           device=dev, **hooks("defta"))
        _sync(dev)
        runs[name] = (st, led, time.perf_counter() - t0)
    st_f, led_f, fused_s = runs["fused"]
    st_l, led_l, loop_s = runs["per_epoch"]
    delta = float((st_f.last_loss - st_l.last_loss).abs().max())
    budget = -(-epochs // eval_every)
    print(f"superstep {epochs} epochs: {led_f.dispatches} chunks (budget "
          f"{budget}), {fused_s:.1f}s chunked vs {loop_s:.1f}s per-epoch "
          f"({led_l.dispatches} chunks), max loss delta {delta:.2e}",
          flush=True)
    assert led_f.dispatches <= budget, (led_f.dispatches, budget)
    assert delta < 1e-4, delta
    return dict(epochs=epochs, eval_every=eval_every,
                dispatches=led_f.dispatches, dispatch_budget=budget,
                dispatches_per_epoch=led_l.dispatches, fused_s=fused_s,
                per_epoch_s=loop_s, max_loss_delta=delta,
                final_loss=st_f.last_loss.tolist())


def bench_quant_convergence(epochs: int = 200, tolerance: float = 0.02,
                            device="cuda"):
    """The int8 wire with EF21 lands within ``tolerance`` (relative) of the
    fp32 run's final mean loss (``gossip_backend="einsum"``); the int8
    wire without error feedback beside them."""
    dev = resolve_device(device)
    data, task, cfg, train = small_world(4)

    def final_loss(c, backend):
        (st, *_), calls = counted(lambda: run_defta(
            0, task, c, train, data, epochs=epochs, gossip_backend=backend,
            device=dev), dev)
        return float(st.last_loss.mean()), calls

    loss_fp32, _ = final_loss(cfg, "einsum")
    loss_int8, calls = final_loss(
        dataclasses.replace(cfg, gossip_dtype="int8"), "auto")
    loss_noef, _ = final_loss(dataclasses.replace(
        cfg, gossip_dtype="int8", gossip_error_feedback=False), "auto")
    rel = abs(loss_int8 - loss_fp32) / abs(loss_fp32)
    print(f"quant convergence {epochs} epochs: fp32={loss_fp32:.4f} "
          f"int8+EF={loss_int8:.4f} (rel {rel:.3%}) "
          f"int8/no-EF={loss_noef:.4f}; int8 kernel calls {calls}",
          flush=True)
    assert rel < tolerance, (loss_fp32, loss_int8, rel)
    return dict(epochs=epochs, loss_fp32=loss_fp32, loss_int8_ef=loss_int8,
                loss_int8_no_ef=loss_noef, rel_delta=rel,
                tolerance=tolerance, int8_calls=calls)


def bench_fedavg_dispatch(epochs: int = 120, device="cuda",
                          hooks=_no_hooks):
    """FedAvg and DeFTA on the same chunked driver: a run with nothing to
    evaluate is one chunk for both; the chunked FedAvg server's accuracy
    beside a one-epoch-a-chunk run's. No assert (the guard reports a
    parity break)."""
    dev = resolve_device(device)
    data, task, cfg, train = small_world(4)
    led_f, led_d, led_r = RunLedger(), RunLedger(), RunLedger()
    st_f, _ = run_fedavg(0, task, cfg, train, data, epochs=epochs,
                         ledger=led_f, probes=False, device=dev,
                         **hooks("fedavg"))
    run_defta(0, task, cfg, train, data, epochs=epochs, ledger=led_d,
              probes=False, device=dev, **hooks("defta"))
    st_r, _ = run_fedavg(0, task, cfg, train, data, epochs=epochs,
                         eval_every=1, test_x=data["test_x"],
                         test_y=data["test_y"], ledger=led_r, probes=False,
                         device=dev, **hooks("fedavg"))
    acc_fused = evaluate_server(task, st_f, data["test_x"], data["test_y"])
    acc_ref = evaluate_server(task, st_r, data["test_x"], data["test_y"])
    print(f"fedavg dispatch parity {epochs} epochs: fedavg "
          f"{led_f.dispatches} vs defta {led_d.dispatches} chunks "
          f"({led_f.wall_s:.1f}s vs {led_d.wall_s:.1f}s); chunked acc "
          f"{acc_fused:.3f} vs per-epoch {acc_ref:.3f}", flush=True)
    return dict(epochs=epochs, dispatches_fedavg=led_f.dispatches,
                dispatches_defta=led_d.dispatches,
                wall_fedavg_s=led_f.wall_s, wall_defta_s=led_d.wall_s,
                acc_fused=acc_fused, acc_per_epoch=acc_ref,
                server={k: v.tolist() for k, v in st_f.server.items()})


def bench_scenario_overhead(epochs: int = 60, device="cuda"):
    """The static topology against a churn + sign_flip + straggler
    scenario, each run end to end best of 2 (the scenario compiled once,
    as the reference does): equal chunk counts and equal kernel launches
    a round; the wall ratio."""
    dev = resolve_device(device)
    data, task, cfg, train = small_world(6, avg_peers=3, num_sampled=2)
    spec = ScenarioSpec(
        name="bench", attacks=(AttackSpec("sign_flip"),),
        churn=(ChurnSpec(worker=0, leave=epochs // 2),),
        stragglers=(StragglerSpec(worker=1, speed=0.5),))
    t0 = time.perf_counter()
    compiled = compile_scenario(spec, cfg.num_workers, epochs, dev)
    compile_s = time.perf_counter() - t0

    def once(scenario):
        led = RunLedger()
        t0 = time.perf_counter()
        _, calls = counted(lambda: run_defta(
            0, task, cfg, train, data, epochs=epochs, scenario=scenario,
            ledger=led, probes=False, device=dev), dev)
        return time.perf_counter() - t0, led.dispatches, calls

    static = [once(None) for _ in range(2)]
    scn = [once(compiled) for _ in range(2)]
    static_s, scn_s = min(s[0] for s in static), min(s[0] for s in scn)
    ratio = scn_s / static_s
    d_static, d_scn = static[0][1], scn[0][1]
    l_static, l_scn = (per_round(static[0][2], epochs),
                       per_round(scn[0][2], epochs))
    print(f"scenario overhead {epochs} epochs: static {static_s:.2f}s vs "
          f"scenario {scn_s:.2f}s ({ratio:.2f}x, compile_scenario "
          f"{compile_s * 1e3:.1f}ms, chunks {d_static} vs {d_scn}, kernel "
          f"calls a round {l_static} vs {l_scn})", flush=True)
    assert d_scn == d_static, (d_scn, d_static)
    return dict(epochs=epochs, static_s=static_s, scenario_s=scn_s,
                ratio=ratio, compile_scenario_s=compile_s,
                dispatches_static=d_static, dispatches_scenario=d_scn,
                launches_per_round_static=l_static,
                launches_per_round_scenario=l_scn)


def _trust_world(attack: str, k: int):
    data = federated_dataset("vector", 8, np.random.default_rng(0),
                             n_per_worker=64, alpha=0.5)
    spec = ScenarioSpec(name=f"{attack}_bench",
                        attacks=tuple(AttackSpec(attack) for _ in range(k)))
    return data, spec


def chunk_runner(spec, data, epochs: int, dev, *, signal="loss",
                 telemetry=None):
    """The reference's scanned chunk at the paper's round shape (W = 8
    plus the scenario's attackers, ``avg_peers=3``, ``num_sampled=2``,
    ``local_epochs=10``): the round built once, and a runner that drives
    ``epochs`` rounds from the same initial state (a copy of it) as one
    chunk, after one warm-up chunk (the counterpart of "compile
    excluded")."""
    task = mlp_task(32, 10)
    train = TrainConfig(learning_rate=0.05, batch_size=32)
    cfg = DeFTAConfig(num_workers=8, avg_peers=3, num_sampled=2,
                      local_epochs=10, dts_signal=signal)
    scenario, num_classes = scenario_world(spec, 0, cfg, data, epochs, dev)
    w, malicious, data_w, sizes = attacker_world(cfg, data, 0, scenario)
    adj = make_topology(cfg.topology, w, cfg.avg_peers, cfg.seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state = initial_state(gen, task, cfg, w, None)
    rnd = build_defta_round(task, cfg, train, adj, sizes, malicious,
                            draws=TorchDraws(gen), device=dev,
                            scenario=scenario, num_classes=num_classes,
                            telemetry=telemetry)
    tdata = to_device_data(data_w, dev)

    def run():
        st = sharding.tree_map(lambda t: t.clone(), state)
        drive_epochs(rnd, st, tdata, epochs)
    t0 = time.perf_counter()
    run()
    return run, time.perf_counter() - t0


def parity_runs(spec, data, variants: dict, dev, epochs: int = 6):
    """The reference's dispatch-parity runs: ``run_defta`` for ``epochs``
    epochs at ``local_epochs=1`` under each variant's config keywords
    (and ``ledger``/``probes``): {name: (chunks, kernel calls a round)}."""
    task = mlp_task(32, 10)
    train = TrainConfig(learning_rate=0.05, batch_size=32)
    base = DeFTAConfig(num_workers=8, avg_peers=3, num_sampled=2,
                       local_epochs=1)
    out = {}
    for name, (cfg_kw, run_kw) in variants.items():
        led = RunLedger()
        _, calls = counted(lambda: run_defta(
            0, task, dataclasses.replace(base, **cfg_kw), train, data,
            epochs=epochs, scenario=spec, device=dev,
            ledger=led, **run_kw), dev)
        out[name] = (led.dispatches, per_round(calls, epochs))
    return out


def bench_geom_trust(epochs: int = 20, device="cuda"):
    """The geometric trust channel's cost: ``dts_signal="geom"`` against
    loss-only at W = 8 + 4 label_flip attackers, ``local_epochs=10``,
    one ``epochs``-round chunk each, timed interleaved best of 3 after a
    warm-up chunk; equal chunks and launches a round in 6-epoch runs."""
    dev = resolve_device(device)
    data, spec = _trust_world("label_flip", 4)
    run_loss, loss_first = chunk_runner(spec, data, epochs, dev)
    run_geom, geom_first = chunk_runner(spec, data, epochs, dev,
                                        signal="geom")
    loss_s, geom_s = interleaved_best([run_loss, run_geom])
    ratio = geom_s / loss_s
    par = parity_runs(spec, data, {"loss": ({}, {"probes": False}),
                                   "geom": ({"dts_signal": "geom"},
                                            {"probes": False})}, dev)
    print(f"geom trust overhead {epochs}x10-local-epoch chunks: loss "
          f"{loss_s:.2f}s vs geom {geom_s:.2f}s ({ratio:.2f}x; first "
          f"chunk {loss_first:.1f}s vs {geom_first:.1f}s; chunks "
          f"{par['loss'][0]} vs {par['geom'][0]}; kernel calls a round "
          f"{par['loss'][1]} vs {par['geom'][1]})", flush=True)
    return dict(epochs=epochs, loss_s=loss_s, geom_s=geom_s, ratio=ratio,
                compile_loss_s=loss_first, compile_geom_s=geom_first,
                dispatches_loss=par["loss"][0],
                dispatches_geom=par["geom"][0],
                launches_per_round_loss=par["loss"][1],
                launches_per_round_geom=par["geom"][1])


def bench_corr_trust(epochs: int = 20, device="cuda"):
    """The correlation channel's cost: ``corr`` and ``all`` against
    loss-only at W = 8 + 4 alie colluders, as ``bench_geom_trust``."""
    dev = resolve_device(device)
    data, spec = _trust_world("alie", 4)
    runners = [chunk_runner(spec, data, epochs, dev, signal=s)[0]
               for s in ("loss", "corr", "all")]
    loss_s, corr_s, all_s = interleaved_best(runners)
    par = parity_runs(spec, data, {s: ({"dts_signal": s}, {"probes": False})
                                   for s in ("loss", "corr", "all")}, dev)
    print(f"corr trust overhead {epochs}x10-local-epoch chunks: loss "
          f"{loss_s:.2f}s vs corr {corr_s:.2f}s ({corr_s / loss_s:.2f}x) "
          f"vs all {all_s:.2f}s ({all_s / loss_s:.2f}x); chunks "
          f"{par['loss'][0]} / {par['corr'][0]} / {par['all'][0]}; kernel "
          f"calls a round {par['loss'][1]} / {par['corr'][1]} / "
          f"{par['all'][1]}", flush=True)
    return dict(epochs=epochs, loss_s=loss_s, corr_s=corr_s, all_s=all_s,
                ratio_corr=corr_s / loss_s, ratio_all=all_s / loss_s,
                **{f"dispatches_{s}": par[s][0]
                   for s in ("loss", "corr", "all")},
                **{f"launches_per_round_{s}": par[s][1]
                   for s in ("loss", "corr", "all")})


def bench_telemetry(epochs: int = 20, device="cuda"):
    """The telemetry plane's cost: the round built with a ``Telemetry``
    registry (its frames staged into the chunk's buffers) against one
    without, at W = 8 + 2 sign_flip attackers, as ``bench_geom_trust``;
    equal chunks and launches a round with a ledger's probes on and
    off."""
    dev = resolve_device(device)
    data, spec = _trust_world("sign_flip", 2)
    run_off, _ = chunk_runner(spec, data, epochs, dev)
    run_on, _ = chunk_runner(spec, data, epochs, dev, telemetry=Telemetry())
    off_s, on_s = interleaved_best([run_off, run_on])
    ratio = on_s / off_s
    par = parity_runs(spec, data, {"off": ({}, {"probes": False}),
                                   "on": ({}, {})}, dev)
    specs = defta_specs(10, scenario=True)
    per = frame_bytes(specs)
    print(f"telemetry overhead {epochs}x10-local-epoch chunks: off "
          f"{off_s:.2f}s vs on {on_s:.2f}s ({ratio:.2f}x; {len(specs)} "
          f"probes, {per} B/round; chunks {par['off'][0]} vs "
          f"{par['on'][0]}; kernel calls a round {par['off'][1]} vs "
          f"{par['on'][1]})", flush=True)
    return dict(epochs=epochs, off_s=off_s, on_s=on_s, ratio=ratio,
                dispatches_off=par["off"][0], dispatches_on=par["on"][0],
                launches_per_round_off=par["off"][1],
                launches_per_round_on=par["on"][1], probes=len(specs),
                bytes_per_round=float(per), buffer_bytes=float(per * epochs))


# ---------------------------------------------------------------------------
# The existing port scripts' benches, in the reference's payload keys
# ---------------------------------------------------------------------------

def bench_trust_grid(epochs: int = 40, device="cuda"):
    """``port_table_trust.sweep``'s headline cells (label_flip and alie x
    the five signals, non-iid) with both headline checks."""
    from port_table_trust import alie_headline_check, headline_check, sweep
    rows = sweep(epochs, attacks=("label_flip", "alie"),
                 partitions=("non_iid",), device=device, verbose=False)
    ok, accs = headline_check(rows, verbose=False)
    alie_ok, alie_accs = alie_headline_check(rows, verbose=False)
    print(f"trust grid {epochs} epochs: label_flip {accs} (headline "
          f"{ok}); alie {alie_accs} (headline {alie_ok})", flush=True)
    return dict(epochs=epochs, headline_ok=bool(ok), accs=accs,
                alie_headline_ok=bool(alie_ok), alie_accs=alie_accs,
                rows=rows)


def bench_cross_device(rounds: int = 120, dense_epochs: int = 40,
                       trust_epochs: int = 40, device="cuda"):
    """``port_cross_device.bench``, its chunks under the reference's
    ``dispatches`` beside its budget ceil(rounds / 30)."""
    import port_cross_device
    out = port_cross_device.bench(rounds, dense_epochs, trust_epochs,
                                  device)
    out["eval_every"] = port_cross_device.EVAL_EVERY
    out["dispatch_budget"] = -(-rounds // port_cross_device.EVAL_EVERY)
    for r in (out["clean"], *out["attacked"].values()):
        r["dispatches"] = r["chunks"]
    return out


def bench_w_scaling(device="cuda"):
    """``port_shard_scaling``'s sweep and engine chunk parity (one chunk a
    2-epoch run at every shard count: the reference's budget 1)."""
    import port_shard_scaling
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    widths = (500, 2000, 10000) if dev.type == "cuda" else (500, 2000)
    rows = port_shard_scaling.sweep(dev, widths)
    engine = port_shard_scaling.chunk_parity(dev)
    for e in engine:
        e.update(W=e["engine_W"], dispatches=e["chunks"], dispatch_budget=1)
    return dict(feature_dim=port_shard_scaling.F, avg_peers=4, rows=rows,
                engine=engine)


def bench_secagg(epochs: int = 24, eval_every: int = 6, device="cuda"):
    """``port_secagg.bench`` with the reference's keys: the clean and
    secagg accuracies, chunks as dispatches beside the budget ceil(epochs
    / eval_every)."""
    import port_secagg
    out = port_secagg.bench(epochs, eval_every, device)
    runs = out["runs"]
    out.update(clean_acc=runs["clean"]["acc"],
               secagg_acc=runs["secagg"]["acc"],
               dp_acc=runs["secagg_dp"]["acc"],
               dispatch_budget=-(-epochs // eval_every),
               dispatches=dict(clean=runs["clean"]["chunks"],
                               secagg=runs["secagg"]["chunks"],
                               dp=runs["secagg_dp"]["chunks"]))
    for r in out["attacked"].values():
        r["dispatches"] = r["chunks"]
    return out


# ---------------------------------------------------------------------------
# The payload and the kernel rows
# ---------------------------------------------------------------------------

FAST = dict(superstep=(8, 2), quant=8, fedavg=8, scenario=8, trust=4,
            grid=4, cross_device=(6, 2, 2), secagg=(4, 2))


def bench_gossip(f: int = 4096, out_path=OUT, device="cuda",
                 fast: bool = False):
    """The sweep and every contract bench (``fast``: the epoch counts of
    ``FAST``), assembled into the reference's payload with the card line;
    written to ``out_path``."""
    e = FAST if fast else {}
    rows = gossip_rows(f, device)
    payload = dict(
        feature_dim=f, rows=rows,
        superstep=bench_superstep(*e.get("superstep", (200, 50)),
                                  device=device),
        quant_convergence=bench_quant_convergence(e.get("quant", 200),
                                                  device=device),
        scenario_overhead=bench_scenario_overhead(e.get("scenario", 60),
                                                  device=device),
        fedavg_dispatch=bench_fedavg_dispatch(e.get("fedavg", 120),
                                              device=device),
        geom_trust=bench_geom_trust(e.get("trust", 20), device=device),
        corr_trust=bench_corr_trust(e.get("trust", 20), device=device),
        telemetry=bench_telemetry(e.get("trust", 20), device=device),
        trust_grid=bench_trust_grid(e.get("grid", 40), device=device),
        cross_device=bench_cross_device(*e.get("cross_device", (120, 40,
                                                                40)),
                                        device=device),
        w_scaling=bench_w_scaling(device=device),
        privacy=bench_secagg(*e.get("secagg", (24, 6)), device=device),
        card=card_line(device))
    Path(out_path).write_text(json.dumps(payload, indent=2))
    print(f"wrote {Path(out_path).resolve()}", flush=True)
    return payload


def kernel_rows(device="cuda"):
    """The reference's ``run`` rows: (name, kernel call, plain call,
    library call or None, its inputs' error check, bound (ms, by))."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    P = torch.softmax(torch.randn(20, 20, generator=gen, device=dev), -1)
    w = torch.randn(20, 1 << 16, generator=gen, device=dev)
    q = torch.randn(1, 4, 512, 64, generator=gen, device=dev)
    logits = torch.randn(2048, 64, generator=gen, device=dev)
    g, h, t, n, p = 4, 4, 128, 64, 64
    C = torch.randn(g, t, n, generator=gen, device=dev)
    B = torch.randn(g, t, n, generator=gen, device=dev)
    acum = -torch.randn(g, h, t, generator=gen, device=dev).abs().cumsum(-1)
    dt = torch.nn.functional.softplus(torch.randn(g, h, t, generator=gen,
                                                  device=dev))
    x = torch.randn(g, h, t, p, generator=gen, device=dev)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return [
        ("gossip_mix_20x65k", lambda: ops.gossip_mix(P, w),
         lambda: ref.gossip_mix_ref(P, w), lambda: torch.matmul(P, w),
         roofline.bound("gossip_mix", 20, None, None, 1 << 16, 4)),
        ("flash_attention_512",
         lambda: ops.flash_attention(q, q, q),
         lambda: ref.flash_attention_ref(q, q, q),
         lambda: sdpa(q, q, q, is_causal=True),
         roofline.flash_bound(1, 4, 512, 64, 4)),
        ("moe_router_2048x64", lambda: ops.moe_router_topk(logits, 6),
         lambda: ref.moe_router_topk_ref(logits, 6), None,
         roofline.router_bound(2048, 64, 6, 4)),
        ("ssd_chunk_4x4x128", lambda: ops.ssd_chunk(C, B, acum, dt, x),
         lambda: ref.ssd_chunk_ref(C, B, acum, dt, x), None,
         roofline.ssd_bound(g, h, t, n, p)[:2]),
    ]


def _err(got, want) -> float:
    if isinstance(got, tuple):          # the router: gates, then indices
        return max(float((got[0] - want[0]).abs().max()),
                   float((got[1] != want[1]).any()))
    return float((got.float() - want.float()).abs().max())


def run(device="cuda", *, timed=True):
    """The four kernel rows: us a call of the kernel, its plain version and
    the library call, the bound, the kernel's launches and its max error
    against the plain version (the router: the gates' error, or 1 where an
    index differs)."""
    dev = resolve_device(device)
    out = []
    for name, kern, plain, lib, (b_ms, b_by) in kernel_rows(dev):
        got, launches = counted(kern, dev)
        row = dict(name=name, max_err=_err(got, plain()),
                   launches=launches, bound_us=b_ms * 1e3, bound_by=b_by)
        if timed:
            row.update(us_per_call=device_us(kern, dev),
                       ref_us=device_us(plain, dev),
                       library_us=None if lib is None
                       else device_us(lib, dev))
            lib_us = "-" if lib is None else f"{row['library_us']:.2f}us"
            print(f"kernel {name}: {row['us_per_call']:.2f}us (ref "
                  f"{row['ref_us']:.2f}us, library {lib_us}, bound "
                  f"{row['bound_us']:.2f}us {b_by}) max_err "
                  f"{row['max_err']:.2e}", flush=True)
        out.append(row)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--fast", action="store_true",
                    help="cut every epoch count (a rehearsal)")
    args = ap.parse_args(argv)
    resolve_device(args.device)            # no card: raise before any run
    print(f"card: {card_line(args.device)}; torch {torch.__version__}",
          flush=True)
    run(args.device)
    bench_gossip(out_path=args.out, device=args.device, fast=args.fast)
    return 0


if __name__ == "__main__":
    sys.exit(main())
