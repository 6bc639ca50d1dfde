"""Training launcher, simulation half (port of ``repro.launch.train``).

    python -m repro_torch.launch.train --scenario churn_signflip \
        --sim-epochs 8 --telemetry run_ledger.jsonl [--device cpu]

Two modes, each the reference's:

* scenario replay (``--scenario NAME``): run the simulation engines
  through a named adversarial scenario (churn + attack zoo + faults,
  compiled to device tensors — see ``repro_torch.scenarios``). Presets:
  ``paper_noise[@K]``, ``churn_signflip``, ``storm``. ``--async-ticks``
  routes it through ``run_async_defta`` instead of ``run_defta``;
  ``--assert-acc X`` exits 1 if the final vanilla accuracy is below X.
* cross-device (``--cross-device``): an enrolled population of
  ``--enrolled`` users, ``--sample-k`` gathered per round under
  ``--cd-availability`` with mid-round dropout (``--cd-dropout``) and
  straggler timeouts (``--cd-straggle``); ``--cd-attacks
  kind:frac[,kind:frac]`` assigns attackers as a fraction of the ENROLLED
  population.

``--telemetry PATH`` streams the JSONL run ledger (a manifest row, one
round row per epoch or per tick run, a summary row) that
``benchmarks/render_experiments.py --telemetry-panel PATH`` renders.
``--profile DIR`` writes a ``torch.profiler`` Chrome trace of the run to
``DIR/trace.json``. The last line of a run counts its gossip kernel
launches by kernel and by regime.

Both modes keep the reference's "dispatches > budget" checks (a secagg
scenario run, and every cross-device run, exit 1 past ceil(epochs /
eval_every)). The port's ledger counts host chunks of the Python-loop
driver, not XLA dispatches: a chunk ends at each eval point, so the check
holds by construction here and guards the chunking itself.

The run lands on the card (``--device cuda``, the default) and raises
without one; ``--device cpu`` runs the kernels' plain versions. The
reference's other modes are later items of the port and raise
``NotImplementedError``: ``--shard-workers`` > 1 (item 7), ``--fl`` and
the LM training path (item 11).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, queue 1a, {item})")


def make_ledger(args, cfg, mode: str):
    """``--telemetry PATH`` → (RunLedger streaming to a JSONL sink with a
    run manifest first row, sink) — or (None, None) when the flag is
    off."""
    if not args.telemetry:
        return None, None
    from repro_torch.telemetry import JsonlSink, RunLedger, run_manifest

    sink = JsonlSink(args.telemetry)
    meta = run_manifest(config={"mode": mode,
                                **dataclasses.asdict(cfg)},
                        seed=cfg.seed, argv=args.argv)
    return RunLedger(sink=sink, meta=meta), sink


def accounting(ledger):
    """The ledger the run reports its chunks to: the telemetry ledger, or
    a probe-free one when ``--telemetry`` is off. Returns (ledger,
    probes)."""
    from repro_torch.telemetry import RunLedger
    if ledger is None:
        return RunLedger(), False
    return ledger, True


def start_profile(args):
    """``--profile DIR`` → a started ``torch.profiler`` over the host and,
    on the card, the device; None when the flag is off."""
    if not args.profile:
        return None
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.device(args.device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def stop_profile(args, prof):
    if prof is None:
        return
    prof.stop()
    os.makedirs(args.profile, exist_ok=True)
    path = os.path.join(args.profile, "trace.json")
    prof.export_chrome_trace(path)
    print(f"profile trace written to {path}")


def print_launches() -> None:
    """One line of the run's kernel launches by kernel and by regime (the
    wrappers' counters: a run on the CPU launches none)."""
    from repro_torch.kernels import ops
    print("kernel launches: " + json.dumps(
        {"launches": dict(ops.LAUNCHES), "regimes": dict(ops.REGIMES)}))


def close_ledger(args, ledger, sink):
    if sink is not None:
        sink.close()
        print(f"telemetry ledger: {args.telemetry} "
              f"({ledger.rounds_done} rounds, "
              f"{len(ledger.names())} probes, "
              f"wall {ledger.wall_s:.2f}s)")


def run_scenario_sim(args) -> int:
    """--scenario: replay a named scenario through the DeFTA engines."""
    from repro_torch.config import DeFTAConfig, TrainConfig
    from repro_torch.core.async_defta import run_async_defta
    from repro_torch.core.defta import evaluate, resolve_scenario, run_defta
    from repro_torch.core.tasks import mlp_task
    from repro_torch.data.synthetic import federated_dataset
    from repro_torch.device import resolve_device

    # robust rules run PURE (no DTS, no time machine) — same contract as
    # table3_robustness.DEFENSES; crediting a classical baseline with
    # DeFTA's own rollback would inflate it
    robust = args.aggregation in ("trimmed_mean", "median", "krum")
    if args.dts_signal != "loss" and args.aggregation != "defta":
        # a non-defta aggregation never runs DTS, so the flag would be
        # silently inert — refuse rather than fake a defended run
        raise SystemExit(f"--dts-signal {args.dts_signal} needs DTS "
                         f"(--aggregation defta); aggregation="
                         f"{args.aggregation} never runs a trust update")
    dev = resolve_device(args.device)
    cfg = DeFTAConfig(num_workers=args.sim_workers, avg_peers=4,
                      num_sampled=2, local_epochs=args.sim_local_epochs,
                      aggregation=args.aggregation,
                      use_dts=args.aggregation == "defta",
                      time_machine=not robust,
                      dts_signal=args.dts_signal,
                      gossip_dtype="float32" if robust
                      else args.gossip_wire,
                      gossip_error_feedback=not args.no_gossip_ef,
                      secagg="pairwise" if args.secagg and not robust
                      else None,
                      secagg_mode=args.secagg_mode,
                      dp_sigma=args.dp_sigma,
                      dp_update_clip=args.dp_update_clip)
    if args.secagg and robust:
        # robust rules inspect plaintext models: the same purity
        # downgrade as the wire keeps robust baselines runnable in a sweep
        print(f"aggregation={args.aggregation}: secagg disabled "
              f"(robust rules need plaintext models)")
    if args.aggregation != "defta":
        print(f"aggregation={args.aggregation}: use_dts={cfg.use_dts} "
              f"time_machine={cfg.time_machine} (baseline purity)")
    train = TrainConfig(learning_rate=0.05, batch_size=32)
    data = federated_dataset("vector", cfg.num_workers,
                             np.random.default_rng(cfg.seed),
                             n_per_worker=120, alpha=0.5)
    task = mlp_task(32, 10)
    horizon = args.async_ticks or args.sim_epochs
    compiled = resolve_scenario(args.scenario, cfg, horizon, dev)
    print(f"scenario {compiled.spec.name}: {compiled.summary()}")

    ledger, sink = make_ledger(args, cfg, "async" if args.async_ticks
                               else "scenario")
    led, probes = accounting(ledger)
    prof = start_profile(args)
    t0 = time.time()
    if args.async_ticks:
        st, adj, mal, _ = run_async_defta(
            cfg.seed, task, cfg, train, data, ticks=args.async_ticks,
            scenario=compiled, target_epochs=args.sim_epochs, ledger=led,
            probes=probes, device=dev)
    else:
        st, adj, mal, hist = run_defta(
            cfg.seed, task, cfg, train, data, epochs=args.sim_epochs,
            scenario=compiled, eval_every=max(args.sim_epochs // 4, 1),
            test_x=data["test_x"], test_y=data["test_y"], ledger=led,
            probes=probes, device=dev)
        for e, m, s in hist:
            print(f"  epoch {e:4d}: vanilla acc {m:.3f} ± {s:.3f}")
    stop_profile(args, prof)
    close_ledger(args, ledger, sink)
    stats = led.as_stats()
    m, s, _ = evaluate(task, st, data["test_x"], data["test_y"], mal)
    print(f"final vanilla acc {m:.3f} ± {s:.3f} "
          f"({stats['dispatches']} dispatches, "
          f"{time.time() - t0:.1f}s, epochs={st.epoch.tolist()})")
    print_launches()
    if args.secagg and not args.async_ticks:
        budget = -(-args.sim_epochs // max(args.sim_epochs // 4, 1))
        if stats["dispatches"] > budget:
            print(f"FAIL: {stats['dispatches']} dispatches > "
                  f"ceil(epochs/eval_every) = {budget} — the secagg "
                  f"round program broke the chunking")
            return 1
    if args.assert_acc and m < args.assert_acc:
        print(f"FAIL: vanilla accuracy {m:.3f} < --assert-acc "
              f"{args.assert_acc}")
        return 1
    return 0


def parse_cd_attacks(text: str):
    """``"label_flip:0.15,alie:0.14"`` → ((kind, frac), ...)."""
    if not text:
        return ()
    out = []
    for part in text.split(","):
        kind, _, frac = part.partition(":")
        out.append((kind.strip(), float(frac)))
    return tuple(out)


def run_cross_device_sim(args) -> int:
    """--cross-device: an enrolled population with k sampled per round."""
    from repro_torch.config import DeFTAConfig, TrainConfig
    from repro_torch.core.cross_device import (evaluate_probe, probe_indices,
                                               resolve_world,
                                               run_cross_device)
    from repro_torch.core.tasks import mlp_task
    from repro_torch.data.synthetic import federated_dataset
    from repro_torch.device import resolve_device
    from repro_torch.scenarios.cross_device import CrossDeviceSpec

    dev = resolve_device(args.device)
    cfg = DeFTAConfig(num_workers=args.enrolled, avg_peers=4,
                      num_sampled=2, local_epochs=args.sim_local_epochs,
                      dts_signal=args.dts_signal,
                      dts_conf_decay=args.cd_conf_decay,
                      max_staleness=args.max_staleness,
                      gossip_dtype=args.gossip_wire,
                      gossip_error_feedback=not args.no_gossip_ef,
                      secagg="pairwise" if args.secagg else None,
                      secagg_mode=args.secagg_mode,
                      dp_sigma=args.dp_sigma,
                      dp_update_clip=args.dp_update_clip)
    train = TrainConfig(learning_rate=0.05, batch_size=32)
    data = federated_dataset("vector", args.enrolled,
                             np.random.default_rng(cfg.seed),
                             n_per_worker=args.cd_shard_size, alpha=0.5)
    task = mlp_task(32, 10)
    spec = CrossDeviceSpec(
        enrolled=args.enrolled, sample_k=args.sample_k,
        availability=args.cd_availability, dropout=args.cd_dropout,
        straggle=args.cd_straggle,
        attacks=parse_cd_attacks(args.cd_attacks), seed=cfg.seed)
    world = resolve_world(spec, args.sim_epochs)
    print(f"cross-device world: {world.summary()}")

    eval_every = max(args.sim_epochs // 4, 1)
    budget = -(-args.sim_epochs // eval_every)
    ledger, sink = make_ledger(args, cfg, "cross_device")
    led, probes = accounting(ledger)
    prof = start_profile(args)
    t0 = time.time()
    state, hist = run_cross_device(
        cfg.seed, task, cfg, train, data, world=world,
        epochs=args.sim_epochs, eval_every=eval_every,
        test_x=data["test_x"], test_y=data["test_y"], ledger=led,
        probes=probes, device=dev)
    stop_profile(args, prof)
    close_ledger(args, ledger, sink)
    stats = led.as_stats()
    for e, m, s in hist:
        print(f"  round {e:4d}: honest probe acc {m:.3f} ± {s:.3f}")
    pix = probe_indices(world, 32, seed=cfg.seed)
    m, s = evaluate_probe(task, state, data["test_x"], data["test_y"], pix)
    mean_part = float(state.obs.cpu().numpy().mean())
    print(f"final honest probe acc {m:.3f} ± {s:.3f} "
          f"({stats['dispatches']} dispatches, budget {budget}, "
          f"{time.time() - t0:.1f}s, mean participations/user "
          f"{mean_part:.1f})")
    print_launches()
    if stats["dispatches"] > budget:
        print(f"FAIL: {stats['dispatches']} dispatches > "
              f"ceil(rounds/eval_every) = {budget} — the gather/scatter "
              f"round is no longer chunked by eval points")
        return 1
    if args.assert_acc and m < args.assert_acc:
        print(f"FAIL: honest probe accuracy {m:.3f} < --assert-acc "
              f"{args.assert_acc}")
        return 1
    return 0


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="DeFTA simulation launcher (the PyTorch port)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--scenario", default="",
                    help="replay a named adversarial scenario through the "
                         "simulation engines (paper_noise[@K], "
                         "churn_signflip, storm)")
    ap.add_argument("--sim-epochs", type=int, default=12)
    ap.add_argument("--sim-workers", type=int, default=8)
    ap.add_argument("--sim-local-epochs", type=int, default=3)
    ap.add_argument("--aggregation", default="defta",
                    choices=["defta", "defl", "uniform", "trimmed_mean",
                             "median", "krum"],
                    help="aggregation rule for --scenario runs (robust "
                         "rules are the Byzantine baselines)")
    ap.add_argument("--async-ticks", type=int, default=0,
                    help="route --scenario through run_async_defta for "
                         "this many ticks")
    ap.add_argument("--assert-acc", type=float, default=0.0,
                    help="exit 1 if the final vanilla (or honest probe) "
                         "accuracy is below this")
    ap.add_argument("--gossip-wire", default="fp32",
                    choices=["fp32", "bf16", "int8"],
                    help="gossip payload precision")
    ap.add_argument("--no-gossip-ef", action="store_true",
                    help="disable EF21 error feedback on lossy wires")
    ap.add_argument("--dts-signal", default="loss",
                    choices=["loss", "geom", "both", "corr", "all"],
                    help="DTS trust signal: the paper's loss delta, the "
                         "update-geometry scores, the cross-round "
                         "correlation scores, or their fusions (both = "
                         "loss+geom, all = loss+geom+corr)")
    ap.add_argument("--cross-device", action="store_true",
                    help="participation sim: sample --sample-k of "
                         "--enrolled users per round")
    ap.add_argument("--enrolled", type=int, default=10_000,
                    help="--cross-device enrolled population size")
    ap.add_argument("--sample-k", type=int, default=64,
                    help="--cross-device per-round cohort size")
    ap.add_argument("--cd-availability", type=float, default=0.7,
                    help="P(user reachable at round start)")
    ap.add_argument("--cd-dropout", type=float, default=0.05,
                    help="P(mid-round departure | selected)")
    ap.add_argument("--cd-straggle", type=float, default=0.10,
                    help="P(straggler timeout | survived)")
    ap.add_argument("--cd-attacks", default="",
                    help="attack assignment over the ENROLLED population: "
                         "kind:frac[,kind:frac], e.g. "
                         "label_flip:0.15,alie:0.14")
    ap.add_argument("--cd-shard-size", type=int, default=48,
                    help="training examples per enrolled user")
    ap.add_argument("--cd-conf-decay", type=float, default=0.98,
                    help="per-round decay of an absent user's trust-"
                         "confidence row (1.0 = off)")
    ap.add_argument("--telemetry", nargs="?", const="run_ledger.jsonl",
                    default="", metavar="PATH",
                    help="stream a per-round JSONL run ledger (default "
                         "path: run_ledger.jsonl)")
    ap.add_argument("--profile", nargs="?", const="profile_trace",
                    default="", metavar="DIR",
                    help="write a torch.profiler Chrome trace of the run "
                         "to DIR/trace.json (every engine stage is a "
                         "named range)")
    ap.add_argument("--secagg", action="store_true",
                    help="pairwise secure-aggregation wire")
    ap.add_argument("--secagg-mode", default="edge",
                    choices=["edge", "masked_geom"],
                    help="secagg trust fidelity")
    ap.add_argument("--dp-sigma", type=float, default=0.0,
                    help="DP noise multiplier on the per-round local-update "
                         "delta (0 = off)")
    ap.add_argument("--dp-update-clip", type=float, default=1.0,
                    help="L2 clip norm for the --dp-sigma update delta")
    ap.add_argument("--max-staleness", type=int, default=0,
                    help="drop a peer's contribution when its model is "
                         "more than this many rounds stale (0 = off)")
    ap.add_argument("--shard-workers", type=int, default=0,
                    help="shard the worker axis over this many devices "
                         "(item 7; not ported)")
    lm = ap.add_argument_group(
        "LM training and --fl (the reference's; item 11, not ported)")
    lm.add_argument("--fl", action="store_true")
    for flag, kw in (("--arch", dict(default="paper-small")),
                     ("--steps", dict(type=int, default=20)),
                     ("--batch", dict(type=int, default=8)),
                     ("--seq", dict(type=int, default=128)),
                     ("--lr", dict(type=float, default=1e-3)),
                     ("--optimizer", dict(default="adam")),
                     ("--pods", dict(type=int, default=2)),
                     ("--gossip-every", dict(type=int, default=4)),
                     ("--gossip-wire-round", dict(default="nearest")),
                     ("--transport", dict(default="in_jit")),
                     ("--checkpoint-dir", dict(default=""))):
        lm.add_argument(flag, **kw)
    for flag in ("--pod-dts", "--pod-time-machine", "--debug-mesh",
                 "--smoke"):
        lm.add_argument(flag, action="store_true")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    args.argv = list(sys.argv) if argv is None else [sys.argv[0], *argv]
    if args.shard_workers > 1:
        _not_ported("--shard-workers (sharded workers)",
                    "item 7: multi-device transports")
    if args.fl:
        _not_ported("--fl (DeFTA across pods)", "item 11: training")
    if args.cross_device:
        return run_cross_device_sim(args)
    if args.scenario:
        return run_scenario_sim(args)
    _not_ported("LM training (no --scenario or --cross-device)",
                "item 11: training")


if __name__ == "__main__":
    sys.exit(main())
