"""The comparison that decides ``correct``: the program's first steps and
first round against the plain reference (``bench/reference``), on the
same weights, batches and Gumbel draws, made again from the seed.

The numbers compared, each with a limit of its own (the cell's file under
``bench/workloads``):

* ``loss1_gap``: the largest |loss - reference loss| of the first step
  over the pods: both sides start from the same weights, so it reads the
  forward's rounding alone, steady from seed to seed.
* ``loss_gap``: the same over every checked step.
* ``grad_norm_gap``: the median leaf's gap between the norms of the first
  gradient (the program's worked out from Adam's first moment after one
  step, m / (1 - b1)) and the reference's, each leaf's gap over the larger
  of its reference norm and the median leaf's; the worst pod. (The worst
  leaf's gap is reported beside it, under ``worst``: it is always one small
  leaf's, Mamba2's D, whose gradient sums terms that cancel, and swings
  from seed to seed.)
* ``change_norm_gap``: the same of the parameters' change after the
  checked steps; leaves whose reference gradient is under a thousandth of
  the median leaf's are left out. (The worst leaf is Mamba2's A_log,
  which moves in one head a layer in bf16, by Adam steps that follow the
  ratios of small gradients.)
* ``mix_gap``: the worst leaf's |mixed - reference mixed| / |reference
  mixed| over a sample of each leaf drawn from the seed, the reference
  mixing the program's own round input.
* ``trust_gap``: the largest difference of the round's confidences and
  last losses.
"""
from __future__ import annotations

import importlib
import statistics

import torch

from bench import weights as W
from bench.reference import lm, pod_round

EXCLUDE_GRAD = 1e-3          # of the median leaf's reference gradient norm
NUMBERS = ("loss1_gap", "loss_gap", "grad_norm_gap", "change_norm_gap",
           "mix_gap", "trust_gap")


def reference_module(cfg: dict):
    """The configuration's plain reference, ``bench/reference/<name>.py``."""
    return importlib.import_module(f"bench.reference.{cfg['reference']}")


def leaf_gaps_of(prog: dict, ref: dict, keep=None) -> dict:
    """{leaf: |prog - ref| / max(ref, median ref)}."""
    names = [k for k in ref if keep is None or k in keep]
    med = statistics.median(ref[k] for k in names)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
            for k in names}


def reference_steps(cfg, traffic, seed, device, pods, *, precision="fp32"):
    """The reference's first ``check_steps`` steps of the given pods:
    [{"loss", "grad_norm", "change_norm"}] a pod."""
    model = reference_module(cfg).Model(cfg, precision)
    lay = reference_module(cfg).layout(cfg)
    dtype = getattr(torch, cfg["dtype"])
    opt = lm.Adam(traffic["lr"], traffic["adam_b1"], traffic["adam_b2"],
                  traffic["adam_eps"], store_dtype=dtype)
    shape = (traffic["pods"], traffic["batch_per_pod"], traffic["seq_len"])
    gen = W.token_batches(seed, cfg["vocab_size"], shape, device)
    steps = [next(gen) for _ in range(traffic["check_steps"])]
    out = []
    with lm.fp32_matmul():
        for p in pods:
            params = {k: v.float() for k, v in
                      W.make_weights(lay, seed, device, dtype).items()}
            out.append(lm.train_pod(model, params, [s[p] for s in steps],
                                    opt))
            del params
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()
    return out


def step_numbers(prog_check: dict, ref: list, pods):
    """({loss_gap, grad_norm_gap, change_norm_gap}, the worst readings:
    {name: "value at pod p, step t or leaf"})."""
    loss = max((abs(prog_check["loss"][t][p] - r["loss"][t]),
                f"pod {p} step {t + 1}")
               for p, r in zip(pods, ref) for t in range(len(r["loss"])))
    loss1 = max((abs(prog_check["loss"][0][p] - r["loss"][0]), f"pod {p}")
                for p, r in zip(pods, ref))
    numbers = {"loss1_gap": loss1[0], "loss_gap": loss[0],
               "grad_norm_gap": 0.0, "change_norm_gap": 0.0}
    worst = {"loss1_gap": f"{loss1[0]:.6g} at {loss1[1]}",
             "loss_gap": f"{loss[0]:.6g} at {loss[1]}"}
    for key, name, gaps in _leaf_readings(prog_check, ref, pods):
        for p, g in gaps:
            numbers[name] = max(numbers[name], statistics.median(g.values()))
            k = max(g, key=g.get)
            if g[k] >= worst.get(key, (0.0, ""))[0]:
                worst[key] = (g[k], f"pod {p} {k}")
    for key in ("grad_norm_worst_leaf", "change_norm_worst_leaf"):
        v, where = worst[key]
        worst[key] = f"{v:.6g} at {where}"
    return numbers, worst


def _leaf_readings(prog_check: dict, ref: list, pods):
    """(worst key, number, [(pod, {leaf: gap})]) of the gradient and the
    change; the change leaves out leaves whose reference gradient is under
    ``EXCLUDE_GRAD`` of the median leaf's."""
    grads, changes = [], []
    for p, r in zip(pods, ref):
        g = r["grad_norm"]
        med = statistics.median(g.values())
        keep = {k for k, v in g.items() if v >= EXCLUDE_GRAD * med}
        grads.append((p, leaf_gaps_of(prog_check["grad_norm"][p], g)))
        changes.append((p, leaf_gaps_of(prog_check["change_norm"][p],
                                        r["change_norm"], keep)))
    return (("grad_norm_worst_leaf", "grad_norm_gap", grads),
            ("change_norm_worst_leaf", "change_norm_gap", changes))


def leaf_gaps(prog_check: dict, ref: list, pods) -> dict:
    """Every reading behind the step numbers, for the look at their cause:
    {"loss": [worst pod's gap a step], "grad": {leaf: worst pod's gap},
    "change": {leaf: worst pod's gap}}."""
    out = {"loss": [max(abs(prog_check["loss"][t][p] - r["loss"][t])
                        for p, r in zip(pods, ref))
                    for t in range(len(ref[0]["loss"]))]}
    for _, name, gaps in _leaf_readings(prog_check, ref, pods):
        key = name.split("_")[0]
        out[key] = {}
        for _, g in gaps:
            for k, v in g.items():
                out[key][k] = max(out[key].get(k, 0.0), v)
    return out


def round_numbers(system) -> dict:
    """The round's numbers: the reference mixes the program's round input
    (its sampled leaves) with its own P from the same draws and state."""
    c = system.check
    dev = c["conf"].device
    mixed, conf, last = pod_round.round_(
        c["pre"], c["conf0"].float(), c["last_loss0"].float(),
        c["round_losses"].float(), torch.as_tensor(system.adj, device=dev),
        c["gumbel"], torch.as_tensor(system.sizes, dtype=torch.float32,
                                     device=dev),
        system.dcfg.num_sampled, system.dcfg.crelu_slope)
    mix = max(float((c["post"][k].float() - v.float()).norm())
              / max(float(v.float().norm()), 1e-30)
              for k, v in mixed.items())
    trust = max(float((c["conf"] - conf).abs().max()),
                float((c["last_loss"] - last).abs().max()))
    return {"mix_gap": mix, "trust_gap": trust}
