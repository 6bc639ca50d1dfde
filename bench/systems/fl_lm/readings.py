"""The readings a cell's limits are set from, on one seed
(``bench/readings.py`` runs it on many, at the cell's own size).

Lower: the program's first round against the reference, as a run compares
them. Upper (``upper``): the control, the reference computed in float8
e4m3 (the precision below the configuration's bf16) put in the program's
place; and each fault of ``FAULTS``, planted in the program's timed path
(``System(fault=...)``), against the same sound reference.
"""
from __future__ import annotations

import time

import torch

from bench.systems.fl_lm import check
from bench.systems.fl_lm.system import FAULTS, System


def _as_program(ref: list, npods: int) -> dict:
    """The reference's steps in the layout the program's check has."""
    prog = {"loss": [[None] * npods for _ in ref[0]["loss"]],
            "grad_norm": [None] * npods, "change_norm": [None] * npods}
    for p, r in enumerate(ref):
        for t, v in enumerate(r["loss"]):
            prog["loss"][t][p] = v
        prog["grad_norm"][p] = r["grad_norm"]
        prog["change_norm"][p] = r["change_norm"]
    return prog


def readings(cell: dict, seed: int, upper: bool, device="cuda") -> dict:
    cfg, traffic = cell["config"], cell["traffic"]
    t0 = time.perf_counter()
    system = System(cfg, traffic, seed, device)
    system.setup()
    if system.dev.type == "cuda":
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    system.free()
    pods = list(range(system.npods))
    ref = check.reference_steps(cfg, traffic, seed, device, pods)
    t2 = time.perf_counter()
    numbers, worst = system.compare(ref)
    row = {"seed": seed, "lower": numbers, "worst": worst,
           "leaves": check.leaf_gaps(system.check, ref, pods),
           "round_s": t1 - t0, "reference_s": t2 - t1}
    if not upper:
        return row
    control = _as_program(check.reference_steps(
        cfg, traffic, seed, device, pods, precision="fp8"), system.npods)
    row["control_fp8"] = {**check.step_numbers(control, ref, pods)[0],
                          "leaves": check.leaf_gaps(control, ref, pods)}
    row["faults"] = {}
    for fault in FAULTS:
        planted = System(cfg, traffic, seed, device, fault=fault)
        planted.setup()
        planted.free()
        row["faults"][fault] = planted.compare(ref)[0]
    return row
