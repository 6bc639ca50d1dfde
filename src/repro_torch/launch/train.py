"""Training launcher (port of ``repro.launch.train``).

    python -m repro_torch.launch.train --scenario churn_signflip \
        --sim-epochs 8 --telemetry run_ledger.jsonl [--device cpu]
    python -m repro_torch.launch.train --fl --pods 4 --smoke [--device cpu]

Four modes, each the reference's:

* single-pod: LM training of one model (``--arch``, ``--steps``,
  ``--batch``, ``--seq``, ``--optimizer``, ``--lr``; ``--smoke`` for the
  reduced config) on ``TokenBatcher``'s synthetic streams.
* multi-pod (``--fl``): DeFTA across pods. Each pod is a federated worker
  with its own model replica and data stream; every ``--gossip-every``
  steps the pods run one gossip round of the engine's pod pipeline
  (``core.engine.build_pod_round``): scenario replay (``--scenario``,
  over the gossip-round axis) -> DTS peer sampling (``--pod-dts``, signal
  ``--dts-signal``) -> the wire stack (``--gossip-wire`` fp32 / bf16 /
  int8 + EF21, ``--secagg``, ``--dp-sigma``) over ``--transport``
  (``in_jit``: the in-process backends; ``ppermute``: the cross-pod ring
  between the pods' devices) -> the pod time machine
  (``--pod-time-machine``) -> attack injection -> trust update. The pods
  are ``--pods`` x ``--device`` (one card holds them all);
  ``--checkpoint-dir`` saves the reference's layout.
* scenario replay (``--scenario NAME`` without ``--fl``): run the
  simulation engines through a named adversarial scenario (churn + attack
  zoo + faults, compiled to device tensors — see
  ``repro_torch.scenarios``). Presets: ``paper_noise[@K]``,
  ``churn_signflip``, ``storm``. ``--async-ticks`` routes it through
  ``run_async_defta`` instead of ``run_defta``; ``--assert-acc X`` exits 1
  if the final vanilla accuracy is below X.
* cross-device (``--cross-device``): an enrolled population of
  ``--enrolled`` users, ``--sample-k`` gathered per round under
  ``--cd-availability`` with mid-round dropout (``--cd-dropout``) and
  straggler timeouts (``--cd-straggle``); ``--cd-attacks
  kind:frac[,kind:frac]`` assigns attackers as a fraction of the ENROLLED
  population.

``--telemetry PATH`` streams the JSONL run ledger of the simulation modes
(a manifest row, one round row per epoch or per tick run, a summary row)
that ``benchmarks/render_experiments.py --telemetry-panel PATH`` renders.
``--profile DIR`` writes a ``torch.profiler`` Chrome trace of a simulation
run to ``DIR/trace.json``. The last line of a run counts its kernel
launches by kernel and by regime.

The simulation modes keep the reference's "dispatches > budget" checks (a
secagg or sharded scenario run, and every cross-device run, exit 1 past
ceil(epochs / eval_every)). The port's ledger counts host chunks of the
Python-loop driver, not XLA dispatches: a chunk ends at each eval point,
so the check holds by construction here and guards the chunking itself.

The run lands on the card (``--device cuda``, the default) and raises
without one; ``--device cpu`` runs the kernels' plain versions.
``--shard-workers S`` shards the worker (or enrolled) axis of the
simulation modes over S devices (``repro_torch.sharding``): the first S
cards, or S CPU shards with ``--device cpu``. ``--debug-mesh`` (the
reference's tensor-parallel mesh inside a pod) raises
``NotImplementedError`` (ROADMAP.md queue 1a, item 12).
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

    shards = args.shard_workers if args.shard_workers > 1 else None
    if shards:
        print(f"worker axis sharded over {shards} devices ({dev.type})")
    ledger, sink = make_ledger(args, cfg, "async" if args.async_ticks
                               else "scenario")
    led, probes = accounting(ledger)
    prof = start_profile(args)
    t0 = time.time()
    if args.async_ticks:
        st, adj, mal, _ = run_async_defta(
            cfg.seed, task, cfg, train, data, ticks=args.async_ticks,
            scenario=compiled, target_epochs=args.sim_epochs, ledger=led,
            probes=probes, device=dev, shards=shards)
    else:
        st, adj, mal, hist = run_defta(
            cfg.seed, task, cfg, train, data, epochs=args.sim_epochs,
            scenario=compiled, eval_every=max(args.sim_epochs // 4, 1),
            test_x=data["test_x"], test_y=data["test_y"], ledger=led,
            probes=probes, device=dev, shards=shards)
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
    if (shards or args.secagg) and not args.async_ticks:
        budget = -(-args.sim_epochs // max(args.sim_epochs // 4, 1))
        if stats["dispatches"] > budget:
            print(f"FAIL: {stats['dispatches']} dispatches > "
                  f"ceil(epochs/eval_every) = {budget} — the "
                  f"{'sharded ' if shards else 'secagg '}round program "
                  f"broke the chunking")
            return 1
    if args.assert_acc and m < args.assert_acc:
        print(f"FAIL: vanilla accuracy {m:.3f} < --assert-acc "
              f"{args.assert_acc}")
        return 1
    return 0


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _stack_pods(trees):
    """Per-pod trees -> one tree of [npods, ...] tensors (the reference's
    stacked layout, for its checkpoint files)."""
    from repro_torch.core import pods as pods_mod
    flats = [pods_mod.flatten(t) for t in trees]
    if not flats[0]:                      # a state without leaves (SGD)
        return trees[0]
    dev = next(iter(flats[0].values())).device
    return pods_mod.rebuild(trees[0], pods_mod.stack(flats, dev))


def train_lm(args, *, params=None, draws=None) -> dict:
    """LM training: one model (single-pod), or ``--fl``, DeFTA across
    pods (the reference's ``main`` after its simulation modes). Each pod
    is a federated worker with its own model replica and data stream on
    its own device (``--pods`` x ``--device``: one card holds every pod);
    every ``--gossip-every`` steps the pods run one gossip round of the
    engine's pod pipeline (``core.engine.build_pod_round``: scenario
    replay, DTS peer sampling with ``--pod-dts``, the wire stack over
    ``--transport``, the pod time machine with ``--pod-time-machine``,
    attack injection, the trust update).

    ``params`` (the initial model tree; default: drawn from a generator
    seeded 0 on the device) and ``draws`` (the pod round's ``rng.Draws``
    provider; default: a generator seeded 101) let a caller replay the
    reference's. Returns {"losses": one [npods] list (or loss) a step,
    "step_s": wall s a step (host-synchronised), "gossip_s": wall s a
    gossip round, "params", "opt", "pstate", "transport"}."""
    from repro_torch.config import reduced
    from repro_torch.configs import get_config
    from repro_torch.core import pods as pods_mod
    from repro_torch.core.topology import make_topology
    from repro_torch.data.loader import TokenBatcher
    from repro_torch.device import resolve_device
    from repro_torch.launch.steps import (build_fl_train_step,
                                          build_train_step)
    from repro_torch.models import model as model_mod
    from repro_torch.optim import make_optimizer

    if args.debug_mesh:
        _not_ported("--debug-mesh (tensor parallelism inside a pod)",
                    "item 12: launch costing")
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    opt = make_optimizer(args.optimizer, args.lr)
    pods = args.pods if args.fl else 0
    batcher = TokenBatcher(cfg.vocab_size, args.seq, args.batch)
    if params is None:
        params = model_mod.init_params(
            torch.Generator(device=dev).manual_seed(0), cfg)
    step = 0
    out = {"losses": [], "step_s": [], "gossip_s": [], "transport": None,
           "pstate": None}

    if args.fl:
        from repro_torch.config import DeFTAConfig
        from repro_torch.core.engine import (init_pod_state,
                                             resolve_dts_signal,
                                             sketch_shape)
        from repro_torch.core.gossip import uses_error_feedback
        from repro_torch.launch.steps import build_pod_gossip_step
        from repro_torch.rng import TorchDraws
        from repro_torch.scenarios import compile_scenario, get_scenario
        from repro_torch.scenarios.robust_agg import ROBUST_RULES

        devices = [dev] * pods
        pod_params = pods_mod.replicate(params, devices)
        pod_opt = [opt.init(p) for p in pod_params]
        fl_step = build_fl_train_step(cfg, opt)
        adj = make_topology("dense", pods, pods - 1)
        sizes = np.full(pods, args.batch)

        robust = args.aggregation in ROBUST_RULES
        if args.dts_signal != "loss" and not (args.pod_dts
                                              and not robust):
            raise SystemExit(f"--dts-signal {args.dts_signal} needs "
                             f"--pod-dts (and a non-robust "
                             f"--aggregation): without DTS no trust "
                             f"update runs, the flag would be "
                             f"silently inert")
        dcfg = DeFTAConfig(
            num_workers=pods, avg_peers=pods - 1,
            num_sampled=min(2, pods - 1), topology="dense",
            aggregation=args.aggregation,
            use_dts=args.pod_dts and not robust,
            dts_signal=args.dts_signal,
            time_machine=args.pod_time_machine and not robust,
            gossip_dtype="float32" if robust else args.gossip_wire,
            gossip_error_feedback=not args.no_gossip_ef,
            gossip_wire_round=args.gossip_wire_round,
            secagg="pairwise" if args.secagg and not robust else None,
            secagg_mode=args.secagg_mode,
            dp_sigma=args.dp_sigma,
            dp_update_clip=args.dp_update_clip)

        # the scenario's epoch axis is the gossip round index
        rounds = max(args.steps // args.gossip_every, 1)
        scenario = None
        if args.scenario:
            n_app = get_scenario(args.scenario, pods) \
                .num_appended_attackers()
            vanilla = pods - n_app
            if vanilla <= 0:
                raise SystemExit(
                    f"scenario {args.scenario} appends {n_app} "
                    f"attackers but the mesh only has {pods} pods — "
                    f"attackers occupy pod slots; use more --pods")
            scenario = compile_scenario(
                get_scenario(args.scenario, vanilla), vanilla, rounds,
                device=dev)
            assert scenario.num_workers == pods
            print(f"--fl scenario {scenario.spec.name}: "
                  f"{scenario.summary(adj)}")

        self_eval = None
        if dcfg.time_machine:
            # the held-out self-eval batch: an index the training loop
            # never reaches, a per-pod-sized share, the same for every pod
            hb = batcher.batch_at(args.steps + 1)
            hbatch = {k: torch.as_tensor(v)[:args.batch // pods]
                      for k, v in hb.items()}

            @torch.no_grad()
            def self_eval(pod_trees):
                return torch.stack([model_mod.loss_fn(
                    p, cfg, {k: v.to(d) for k, v in hbatch.items()})[0]
                    .to(dev) for p, d in zip(pod_trees, devices)])

        if draws is None:
            draws = TorchDraws(torch.Generator(device=dev).manual_seed(101))
        gossip_rnd, pod_tr = build_pod_gossip_step(
            cfg, dcfg, pods, sizes, adjacency=adj, draws=draws,
            transport=args.transport, pods=devices, scenario=scenario,
            self_eval=self_eval, device=dev)
        pstate = init_pod_state(
            pods, pod_params,
            wire_error=uses_error_feedback(dcfg) and not robust,
            time_machine=dcfg.time_machine, sketch=sketch_shape(dcfg),
            device=dev)
        print(f"--fl pod pipeline: transport={pod_tr.kind} "
              f"wire={pod_tr.wire or 'fp32'} ef={pod_tr.use_ef} "
              f"aggregation={args.aggregation} dts={dcfg.use_dts} "
              f"signal={dcfg.dts_signal} tm={dcfg.time_machine}")

        # the geometry and correlation signals score true local-train
        # deltas: keep what the pods depart from each gossip interval
        track_start = bool(resolve_dts_signal(dcfg))
        gossip_start = [pods_mod.copy_to(p) for p in pod_params] \
            if track_start else None
        for i in range(args.steps):
            b = batcher.batch_at(i)
            batch = {k: torch.as_tensor(v).reshape(
                pods, args.batch // pods, -1) for k, v in b.items()}
            t0 = time.time()
            pod_params, pod_opt, step, losses = fl_step(
                pod_params, pod_opt, step, batch)
            gossip = (i + 1) % args.gossip_every == 0
            if gossip:
                _sync(dev)
                g0 = time.time()
                pstate, pod_params = gossip_rnd(pstate, pod_params, losses,
                                                gossip_start)
                _sync(dev)
                out["gossip_s"].append(time.time() - g0)
                if track_start:
                    gossip_start = [pods_mod.copy_to(p) for p in pod_params]
            row = losses.tolist()
            out["step_s"].append(time.time() - t0)
            out["losses"].append(row)
            print(f"step {i:4d} losses={[round(x, 4) for x in row]} "
                  f"({out['step_s'][-1]:.2f}s)"
                  + ("  [gossip]" if gossip else ""))
        params, opt_state = pod_params, pod_opt
        out.update(pstate=pstate, transport=pod_tr)
        saved = {"params": _stack_pods(pod_params),
                 "opt": _stack_pods(pod_opt)}
    else:
        opt_state = opt.init(params)
        tstep = build_train_step(cfg, opt)
        for i in range(args.steps):
            b = batcher.batch_at(i)
            batch = {k: torch.as_tensor(v).to(dev) for k, v in b.items()}
            t0 = time.time()
            params, opt_state, step, loss = tstep(params, opt_state, step,
                                                  batch)
            out["losses"].append(float(loss))
            out["step_s"].append(time.time() - t0)
            print(f"step {i:4d} loss={out['losses'][-1]:.4f} "
                  f"({out['step_s'][-1]:.2f}s)")
        saved = {"params": params, "opt": opt_state}
    print_launches()
    if args.checkpoint_dir:
        from repro_torch.checkpoint import save_checkpoint
        path = save_checkpoint(args.checkpoint_dir, saved, int(step))
        print("checkpoint saved:", path)
    out.update(params=params, opt=opt_state)
    return out


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
    shards = args.shard_workers if args.shard_workers > 1 else None
    if shards:
        print(f"enrolled axis sharded over {shards} devices ({dev.type})")
    ledger, sink = make_ledger(args, cfg, "cross_device")
    led, probes = accounting(ledger)
    prof = start_profile(args)
    t0 = time.time()
    state, hist = run_cross_device(
        cfg.seed, task, cfg, train, data, world=world,
        epochs=args.sim_epochs, eval_every=eval_every,
        test_x=data["test_x"], test_y=data["test_y"], ledger=led,
        probes=probes, device=dev, shards=shards)
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
        description="DeFTA launcher (the PyTorch port)")
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
                    help="shard the worker/enrolled axis of the "
                         "simulation engines over this many devices (the "
                         "first N cards, or N CPU shards with --device "
                         "cpu); scenario runs exit 1 on a chunk-count "
                         "violation")
    lm = ap.add_argument_group("LM training and --fl (DeFTA across pods)")
    lm.add_argument("--arch", default="paper-small")
    lm.add_argument("--steps", type=int, default=20)
    lm.add_argument("--batch", type=int, default=8)
    lm.add_argument("--seq", type=int, default=128)
    lm.add_argument("--lr", type=float, default=1e-3)
    lm.add_argument("--optimizer", default="adam")
    lm.add_argument("--fl", action="store_true",
                    help="DeFTA-across-pods mode")
    lm.add_argument("--pods", type=int, default=2,
                    help="--fl: pods, one model replica each, all on "
                         "--device")
    lm.add_argument("--gossip-every", type=int, default=4)
    lm.add_argument("--gossip-wire-round", default="nearest",
                    choices=["nearest", "stochastic"],
                    help="int8 wire rounding (stochastic: in_jit only)")
    lm.add_argument("--transport", default="in_jit",
                    choices=["in_jit", "ppermute"],
                    help="--fl gossip transport: the in-process "
                         "mix_pytree backends, or the cross-pod ring "
                         "between the pods' devices")
    lm.add_argument("--pod-dts", action="store_true",
                    help="--fl: DTS peer sampling and trust reweighting "
                         "across pods (default: listen to all live peers)")
    lm.add_argument("--pod-time-machine", action="store_true",
                    help="--fl: held-out self-eval between gossip rounds; "
                         "a pod whose candidate aggregate explodes "
                         "restores its best-eval backup")
    lm.add_argument("--debug-mesh", action="store_true",
                    help="the reference's tensor-parallel mesh inside a "
                         "pod (not ported: queue 1a item 12)")
    lm.add_argument("--checkpoint-dir", default="")
    lm.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    args.argv = list(sys.argv) if argv is None else [sys.argv[0], *argv]
    if args.cross_device:
        return run_cross_device_sim(args)
    if args.scenario and not args.fl:
        return run_scenario_sim(args)
    train_lm(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
