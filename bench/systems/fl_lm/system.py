"""The system under test: DeFTA as a drop-in for FedAvg in LM training, the
port's ``--fl`` path (``repro_torch.launch.train.train_lm``). Each pod is a
federated worker with its own model replica and token stream, all on one
card; every ``gossip_every`` steps the engine's pod round runs (DTS peer
sampling, the mix, the trust update).

``System`` builds the same objects ``train_lm`` builds, from the
benchmark's own weights, batches and Gumbel draws, and drives them as its
loop does: the FL step (``launch.steps.build_fl_train_step``), then, every
``gossip_every`` steps, a synchronize, the pod round
(``launch.steps.build_pod_gossip_step``) and a synchronize. It also reads
what the correctness check compares in the first round: each pod's losses,
its first gradients (from Adam's first moment after one step), its
parameters' change after ``check_steps`` steps, and a sample of every leaf
before and after the round with the round's trust state.

``fault`` plants one fault in the timed path (for the check's tests and
its upper readings): "state_unchanged" (a step, and the round, return
their state as they got it), "half_batch" (each pod trains on the first
half of its rows, or of its one row's positions), "no_mix" (the round
hands back the parameters unmixed), "loss_altered" (pod 0's loss is scaled
by 1.01 where the step returns it).
"""
from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np
import torch

from bench import weights as W
from bench.flops import train_flops
from bench.systems.fl_lm import check
from bench.systems.fl_lm.check import reference_module

FAULTS = ("state_unchanged", "half_batch", "no_mix", "loss_altered")
MIX_SAMPLE = 65536       # values a leaf, at most, sampled for the round check


def model_config(cfg: dict):
    """The port's ``ModelConfig`` of a configuration file."""
    from repro_torch.config import MoEConfig, ModelConfig, SSMConfig
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: v for k, v in cfg.items() if k in fields}
    if cfg.get("ssm"):
        kw["ssm"] = SSMConfig(**cfg["ssm"])
    if cfg.get("moe"):
        kw["moe"] = MoEConfig(**cfg["moe"])
    return ModelConfig(**kw)


def _run_delay():
    """Seconds this process's main thread has waited for a core, or None
    where the kernel does not say."""
    try:
        with open("/proc/self/schedstat") as fh:
            return int(fh.read().split()[1]) / 1e9
    except (OSError, IndexError, ValueError):
        return None


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class System:
    """A unit of work is a round (``gossip_every`` FL steps and the pod
    round); a sample is one trained token position, B x S a pod a step."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, *,
                 fault=None, mix_sample: int = MIX_SAMPLE):
        from repro_torch.config import DeFTAConfig
        from repro_torch.core import pods as pods_mod
        from repro_torch.core.engine import (init_pod_state,
                                             resolve_dts_signal,
                                             sketch_shape)
        from repro_torch.core.gossip import uses_error_feedback
        from repro_torch.core.topology import make_topology
        from repro_torch.launch.steps import (build_fl_train_step,
                                              build_pod_gossip_step)
        from repro_torch.models import model as model_mod
        from repro_torch.optim import make_optimizer
        from repro_torch.rng import RoundDraws

        if fault is not None and fault not in FAULTS:
            raise ValueError(f"fault {fault!r} not in {FAULTS}")
        self.fault, self.seed = fault, seed
        self.dev = torch.device(device)
        self.cfg, self.traffic = cfg, traffic
        self.pods_mod = pods_mod
        self.mcfg = model_config(cfg)
        t = traffic
        self.npods, self.batch, self.seq = t["pods"], t["batch_per_pod"], \
            t["seq_len"]
        self.gossip_every = t["gossip_every"]
        if t["optimizer"] != "adam":
            raise ValueError("the check reads Adam's first moment")

        # the weights: the benchmark's, in the layout the program serves
        lay = reference_module(cfg).layout(cfg)
        abstract = model_mod.abstract_params(self.mcfg)
        have = {k: tuple(v.shape) for k, v in
                pods_mod.flatten(abstract).items()}
        want = {k: tuple(s) for k, (s, _) in lay.items()}
        if have != want:
            odd = sorted(k for k in set(have) | set(want)
                         if have.get(k) != want.get(k))
            raise ValueError("the program's parameter layout differs from "
                             f"the configuration's at {odd}")
        dtype = getattr(torch, cfg["dtype"])
        flat = W.make_weights(lay, seed, self.dev, dtype)
        params = pods_mod.rebuild(abstract, flat)
        self.start = flat                     # dropped after the check steps

        opt = make_optimizer(t["optimizer"], t["lr"])
        self.b1 = t["adam_b1"]
        devices = [self.dev] * self.npods
        self.params = pods_mod.replicate(params, devices)
        del params
        self.opt = [opt.init(p) for p in self.params]
        self.fl_step = build_fl_train_step(self.mcfg, opt)
        adj = make_topology(t["topology"], self.npods, self.npods - 1)
        self.adj = np.asarray(adj, bool)
        # as train_lm: every pod's data size is the global batch
        self.sizes = np.full(self.npods, self.batch * self.npods)
        self.dcfg = DeFTAConfig(
            num_workers=self.npods, avg_peers=self.npods - 1,
            num_sampled=min(2, self.npods - 1), topology=t["topology"],
            aggregation=t["aggregation"],
            use_dts=t["pod_dts"],
            dts_signal=t["dts_signal"], time_machine=False,
            gossip_dtype=t["gossip_wire"], gossip_error_feedback=True)
        self.draws = W.GumbelDraws(seed, self.dev, RoundDraws)
        self.gossip, _ = build_pod_gossip_step(
            self.mcfg, self.dcfg, self.npods, self.sizes, adjacency=adj,
            draws=self.draws, transport=t["transport"], pods=devices,
            device=self.dev)
        self.pstate = init_pod_state(
            self.npods, self.params, wire_error=uses_error_feedback(self.dcfg),
            time_machine=False, sketch=sketch_shape(self.dcfg),
            device=self.dev)
        self.track_start = bool(resolve_dts_signal(self.dcfg))
        self.round_start = [pods_mod.copy_to(p) for p in self.params] \
            if self.track_start else None
        self.tokens = W.token_batches(seed, self.mcfg.vocab_size,
                                      (self.npods, self.batch, self.seq),
                                      self.dev)
        self.step = 0
        self.losses = None
        self.wait_s = 0.0            # host time spent in the losses' reads
        self.sample_gen = W.generator(seed, "sample", self.dev)
        self.mix_sample = mix_sample
        self.check = {}

    # -- the loop ------------------------------------------------------
    def train_step(self):
        """One FL step; returns the pods' losses as floats (a host read,
        as ``train_lm``'s ``losses.tolist()``)."""
        with torch.profiler.record_function("bench.feed"):
            tok = next(self.tokens)
            if self.fault == "half_batch":      # rows, or positions of one
                tok = tok[:, : self.batch // 2] if self.batch > 1 else \
                    tok[..., : self.seq // 2]
            batch = {"tokens": tok, "labels": tok}
        with torch.profiler.record_function("bench.train_step"):
            p, o, step, losses = self.fl_step(self.params, self.opt,
                                              self.step, batch)
            if self.fault == "loss_altered":
                losses = losses * torch.tensor(
                    [1.01] + [1.0] * (self.npods - 1), device=losses.device)
            if self.fault != "state_unchanged":
                self.params, self.opt = p, o
            self.step = step
            self.losses = losses
            w0 = time.perf_counter()
            row = losses.tolist()
            self.wait_s += time.perf_counter() - w0
            return row

    def pod_round(self):
        _sync(self.dev)
        with torch.profiler.record_function("bench.pod_round"):
            pstate, params = self.gossip(self.pstate, self.params,
                                         self.losses, self.round_start)
            if self.fault != "state_unchanged":
                self.pstate = pstate
            if self.fault not in ("no_mix", "state_unchanged"):
                self.params = params
            if self.track_start:
                self.round_start = [self.pods_mod.copy_to(p)
                                    for p in self.params]
        _sync(self.dev)

    # -- the first round, read for the check -----------------------------
    def _flat(self, tree):
        return self.pods_mod.flatten(tree)

    def _sample_ix(self):
        ix = {}
        for k, v in self._flat(self.params[0]).items():
            n = v.numel()
            ix[k] = None if n <= self.mix_sample else torch.randint(
                0, n, (self.mix_sample,), generator=self.sample_gen,
                device=self.dev)
        return ix

    def _sample(self, ix):
        out = {}
        for k, i in ix.items():
            rows = [self._flat(p)[k].reshape(-1) for p in self.params]
            out[k] = torch.stack([r if i is None else r[i] for r in rows])
        return out

    def checked_round(self, check_steps: int):
        """The first round, as any other, reading what the check compares.
        Returns the failed steps' count."""
        losses, failed = [], 0
        for i in range(self.gossip_every):
            row = self.train_step()
            failed += not all(np.isfinite(row))
            losses.append(row)
            if i == 0:
                self.check["grad_norm"] = [
                    {k: float(m.norm()) / (1.0 - self.b1)
                     for k, m in self._flat(o["m"]).items()}
                    for o in self.opt]
            if i + 1 == check_steps:
                self.check["change_norm"] = [
                    {k: float((v.float() - self.start[k].float()).norm())
                     for k, v in self._flat(p).items()}
                    for p in self.params]
                self.start = None
        ix = self._sample_ix()
        self.check["pre"] = self._sample(ix)
        self.check["round_losses"] = self.losses.detach().clone()
        self.check["conf0"] = self.pstate.conf.clone()
        self.check["last_loss0"] = self.pstate.last_loss.clone()
        self.pod_round()
        self.check["post"] = self._sample(ix)
        self.check["conf"] = self.pstate.conf.clone()
        self.check["last_loss"] = self.pstate.last_loss.clone()
        self.check["loss"] = losses[:check_steps]
        self.check["gumbel"] = self.draws.first
        return failed

    def free(self):
        """Drop the program's state (the reference runs after it)."""
        self.params = self.opt = self.pstate = self.round_start = None
        self.fl_step = self.gossip = self.losses = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def setup(self):
        """The first round, read for the check; warms every shape."""
        return self.gossip_every, self.checked_round(
            self.traffic["check_steps"])

    def window(self, seconds: float):
        """Whole rounds (``gossip_every`` steps and the pod round) until
        ``seconds`` have passed, at least one: {"wall_s", "samples",
        "model_flops", "attempted", "failed", "steps", "rounds", "step_s":
        [...], "round_s": [...]} and "error" where a step or round
        raised. "host" says what held the host: its CPU time, its time
        waiting for a core (``/proc/self/schedstat``, where there is one),
        the garbage collector's time, and the time spent waiting for the
        device in the losses' reads."""
        out = {"step_s": [], "round_s": [], "failed": 0, "steps": 0,
               "rounds": 0}
        gc_s = [0.0, 0.0]

        def on_gc(phase, _info):
            if phase == "start":
                gc_s[1] = time.perf_counter()
            else:
                gc_s[0] += time.perf_counter() - gc_s[1]
        _sync(self.dev)
        gc.callbacks.append(on_gc)
        self.wait_s, cpu0, delay0 = 0.0, time.process_time(), _run_delay()
        t0 = time.perf_counter()
        while True:
            try:
                for _ in range(self.gossip_every):
                    s0 = time.perf_counter()
                    out["steps"] += 1
                    row = self.train_step()
                    out["step_s"].append(time.perf_counter() - s0)
                    out["failed"] += not all(np.isfinite(row))
                g0 = time.perf_counter()
                self.pod_round()
                out["round_s"].append(time.perf_counter() - g0)
            except Exception as exc:               # noqa: BLE001
                out["failed"] += 1
                out["error"] = repr(exc)
                break
            out["rounds"] += 1
            if time.perf_counter() - t0 >= seconds:
                break
        out["wall_s"] = time.perf_counter() - t0
        gc.callbacks.remove(on_gc)
        delay1 = _run_delay()
        out["host"] = {
            "cpu_s": time.process_time() - cpu0, "gc_s": gc_s[0],
            "wait_s": self.wait_s,
            "run_delay_s": None if delay0 is None or delay1 is None
            else delay1 - delay0}
        out["attempted"] = out["steps"]
        out["samples"] = out["steps"] * self.npods * self.batch * self.seq
        out["model_flops"] = out["steps"] * train_flops(
            self.cfg, self.npods * self.batch, self.seq)
        return out

    def compare(self, ref=None):
        """(numbers, worst) of the first round against the reference's
        steps (``check.reference_steps``, computed here unless given) and
        its round."""
        pods = list(range(self.npods))
        if ref is None:
            ref = check.reference_steps(self.cfg, self.traffic, self.seed,
                                        self.dev, pods)
        numbers, worst = check.step_numbers(self.check, ref, pods)
        numbers.update(check.round_numbers(self))
        return numbers, worst
