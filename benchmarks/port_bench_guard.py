"""The regression guard of the port's ``BENCH_port_gossip.json`` (the
port's version of ``benchmarks/bench_guard.py``).

    PYTHONPATH=src python benchmarks/port_bench_guard.py \
        --baseline BENCH_port_gossip.json --fresh fresh.json

``check`` is the reference's ``check``, its gates and constants unchanged
(``CROSS_MACHINE_WIN_FLOOR`` 1.25, ``--tolerance`` 0.25,
``TELEMETRY_OVERHEAD_GATE`` 1.10, the alie floors, the byte identities,
the chunk and accuracy margins), applied to the payload of
``benchmarks/port_kernel_bench.py``, which carries the reference's keys:
its "dispatches" are the port's host chunks (``RunLedger.dispatches``).
The port adds one gate, ``launch_parity``: the variants of the scenario,
geometry, correlation and telemetry benches launch the same kernels a
round. The reference's ``--require-history`` (its dashboard's snapshot
directory) has no port counterpart. Prints both payloads' card lines.
Exits 1 on any failed gate. Imports nothing of JAX or of the ``repro``
package.
"""
from __future__ import annotations

import argparse
import json
import sys

HEADLINE_W, HEADLINE_D = 500, 0.05

# the reference's constants (benchmarks/bench_guard.py), unchanged
CROSS_MACHINE_WIN_FLOOR = 1.25
TELEMETRY_OVERHEAD_GATE = 1.10


def headline_row(payload):
    for row in payload["rows"]:
        if row["W"] == HEADLINE_W and row["density"] == HEADLINE_D:
            return row
    raise SystemExit(
        f"no W={HEADLINE_W}/density={HEADLINE_D} row in bench payload")


def check(baseline, fresh, tolerance):
    failures = []
    base, new = headline_row(baseline), headline_row(fresh)

    base_win = base["dense_us"] / base["sparse_us"]
    new_win = new["dense_us"] / new["sparse_us"]
    gate_win = min(base_win, CROSS_MACHINE_WIN_FLOOR)
    print(f"sparse-vs-dense win @ W={HEADLINE_W}/d={HEADLINE_D}: "
          f"baseline {base_win:.2f}x (gate {gate_win:.2f}x), "
          f"fresh {new_win:.2f}x")
    if new_win < gate_win * (1 - tolerance):
        failures.append(
            f"sparse win regressed >{tolerance:.0%} below the "
            f"{gate_win:.2f}x gate: baseline {base_win:.2f}x -> "
            f"fresh {new_win:.2f}x")

    if "quant_us" in new:
        slowdown = new["quant_us"] / new["sparse_us"]
        print(f"int8 quant kernel vs fp32 sparse: {slowdown:.2f}x time")
        if slowdown > 1 + tolerance:
            failures.append(
                f"fused int8 kernel slower than fp32 sparse by "
                f"{slowdown:.2f}x (tolerance {1 + tolerance:.2f}x)")
        ratio = new["int8_fp32_byte_ratio"]
        print(f"int8 wire bytes: {ratio:.3f}x fp32")
        if ratio > 0.3:
            failures.append(f"int8 wire bytes {ratio:.3f}x fp32 (> 0.3x)")
    else:
        failures.append("fresh bench has no quant sweep (quant_us missing)")

    conv = fresh.get("quant_convergence")
    if not conv:
        failures.append("fresh bench has no quant_convergence entry")
    elif conv["rel_delta"] >= conv["tolerance"]:
        failures.append(
            f"quantized run diverged: rel_delta={conv['rel_delta']:.3%} "
            f">= {conv['tolerance']:.0%}")
    else:
        print(f"quant convergence: int8+EF within "
              f"{conv['rel_delta']:.3%} of fp32 final loss")

    fd = fresh.get("fedavg_dispatch")
    if not fd:
        failures.append("fresh bench has no fedavg_dispatch entry")
    else:
        print(f"fedavg dispatch parity: fedavg {fd['dispatches_fedavg']} "
              f"vs defta {fd['dispatches_defta']} dispatches "
              f"@ {fd['epochs']} epochs")
        if fd["dispatches_fedavg"] != fd["dispatches_defta"]:
            failures.append(
                f"FedAvg left the unified superstep driver: "
                f"{fd['dispatches_fedavg']} dispatches vs DeFTA's "
                f"{fd['dispatches_defta']} for the same run shape")

    scn = fresh.get("scenario_overhead")
    if not scn:
        failures.append("fresh bench has no scenario_overhead entry")
    else:
        print(f"scenario superstep overhead: {scn['ratio']:.2f}x static "
              f"(compile_scenario {scn['compile_scenario_s'] * 1e3:.0f}ms, "
              f"dispatches {scn['dispatches_scenario']} vs "
              f"{scn['dispatches_static']})")
        if scn["dispatches_scenario"] != scn["dispatches_static"]:
            failures.append(
                f"scenario run changed the dispatch count: "
                f"{scn['dispatches_scenario']} vs "
                f"{scn['dispatches_static']} — scenarios must stay data, "
                f"not control flow")
        if scn["ratio"] > 1 + tolerance:
            failures.append(
                f"scenario-compiled superstep {scn['ratio']:.2f}x slower "
                f"than static (gate {1 + tolerance:.2f}x)")

    gt = fresh.get("geom_trust")
    if not gt:
        failures.append("fresh bench has no geom_trust entry")
    else:
        print(f"geom trust_update: {gt['ratio']:.2f}x loss-only superstep "
              f"(dispatches {gt['dispatches_geom']} vs "
              f"{gt['dispatches_loss']})")
        if gt["dispatches_geom"] != gt["dispatches_loss"]:
            failures.append(
                f"geom trust_update changed the dispatch count: "
                f"{gt['dispatches_geom']} vs {gt['dispatches_loss']} — "
                f"the geometric signal must stay data flow inside the "
                f"scanned round body")
        if gt["ratio"] > 1 + tolerance:
            failures.append(
                f"geom trust_update superstep {gt['ratio']:.2f}x slower "
                f"than loss-only (gate {1 + tolerance:.2f}x)")

    ct = fresh.get("corr_trust")
    if not ct:
        failures.append("fresh bench has no corr_trust entry")
    else:
        print(f"corr trust_update: corr {ct['ratio_corr']:.2f}x / all "
              f"{ct['ratio_all']:.2f}x loss-only superstep (dispatches "
              f"{ct['dispatches_loss']} / {ct['dispatches_corr']} / "
              f"{ct['dispatches_all']})")
        if not (ct["dispatches_corr"] == ct["dispatches_all"]
                == ct["dispatches_loss"]):
            failures.append(
                f"corr trust_update changed the dispatch count: loss "
                f"{ct['dispatches_loss']} vs corr "
                f"{ct['dispatches_corr']} vs all {ct['dispatches_all']} "
                f"— the sketch ring buffer must stay carried scan state, "
                f"never control flow")
        worst = max(ct["ratio_corr"], ct["ratio_all"])
        if worst > 1 + tolerance:
            failures.append(
                f"corr trust_update superstep {worst:.2f}x slower than "
                f"loss-only (gate {1 + tolerance:.2f}x) — the sketch "
                f"rotation + sign-matmul overran its budget")

    tg = fresh.get("trust_grid")
    if not tg:
        failures.append("fresh bench has no trust_grid entry")
    else:
        accs = tg.get("accs", {})
        print("trust grid label_flip × non-iid: "
              + " ".join(f"{s}={a:.3f}" for s, a in accs.items()))
        if not tg.get("headline_ok"):
            failures.append(
                "DTS v2 headline regressed: geom/both no longer beat "
                "loss on label_flip × non-iid honest accuracy "
                f"(accs: {accs})")
        alie_accs = tg.get("alie_accs", {})
        if alie_accs:
            print("trust grid alie × non-iid: "
                  + " ".join(f"{s}={a:.3f}" for s, a in alie_accs.items()))
        if not tg.get("alie_headline_ok"):
            failures.append(
                "DTS v3 headline regressed: corr/all no longer beat the "
                "best of loss / geom / both by ≥0.05 on alie × non-iid "
                f"honest accuracy (accs: {alie_accs})")
        # the alie accuracy floor: best corr-family accuracy may not fall
        # more than 0.05 below the committed baseline's
        base_alie = (baseline.get("trust_grid") or {}).get("alie_accs", {})
        floor_sigs = ("corr", "all")
        base_best = max((base_alie.get(s, 0.0) for s in floor_sigs),
                        default=0.0)
        new_best = max((alie_accs.get(s, 0.0) for s in floor_sigs),
                       default=0.0)
        if base_best and new_best < base_best - 0.05:
            failures.append(
                f"alie accuracy floor broken: best corr-family honest "
                f"accuracy {new_best:.3f} vs committed {base_best:.3f} "
                f"(floor {base_best - 0.05:.3f})")

    cd = fresh.get("cross_device")
    if not cd:
        failures.append("fresh bench has no cross_device entry")
    else:
        budget = cd["dispatch_budget"]
        runs = {"clean": cd["clean"], **{f"attacked:{s}": r for s, r
                                         in cd["attacked"].items()}}
        print("cross-device dispatches: "
              + " ".join(f"{n}={r['dispatches']}" for n, r in runs.items())
              + f" (budget {budget})")
        for name, r in runs.items():
            if r["dispatches"] > budget:
                failures.append(
                    f"cross-device {name} run took {r['dispatches']} "
                    f"dispatches > budget {budget} — the gather/scatter "
                    f"participation stage must stay fused in the scanned "
                    f"superstep, never a per-round host round-trip")
        clean_gap = cd["clean_dense_acc"] - cd["clean"]["acc"]
        print(f"cross-device clean parity: sampled {cd['clean']['acc']:.3f}"
              f" vs full-participation {cd['clean_dense_acc']:.3f} "
              f"(gap {clean_gap:+.3f})")
        if clean_gap > 0.05:
            failures.append(
                f"clean cross-device accuracy {cd['clean']['acc']:.3f} "
                f"fell more than 0.05 below clean full-participation "
                f"{cd['clean_dense_acc']:.3f} — sampled-cohort training "
                f"is no longer equivalent to the dense world")
        # the sparse-observation trust headline: best corr-family probe
        # accuracy under 29%-of-enrolled label_flip+alie may not fall
        # more than 0.05 below the DENSE alie × non-iid headline cell
        dense_ref = max((cd.get("dense_alie_accs", {}).get(s, 0.0)
                         for s in ("corr", "all")), default=0.0)
        cd_best = max(r["acc"] for r in cd["attacked"].values())
        if dense_ref:
            print(f"cross-device sparse-trust headline: best attacked "
                  f"probe acc {cd_best:.3f} vs dense headline "
                  f"{dense_ref:.3f} (floor {dense_ref - 0.05:.3f})")
            if cd_best < dense_ref - 0.05:
                failures.append(
                    f"sparse-observation trust headline broken: best "
                    f"cross-device attacked accuracy {cd_best:.3f} fell "
                    f"more than 0.05 below the dense alie headline "
                    f"{dense_ref:.3f} — DTS no longer survives sparse "
                    f"observation of the colluders")
        else:
            failures.append("cross_device entry has no dense_alie_accs "
                            "reference to gate the sparse-trust headline")

    ws = fresh.get("w_scaling")
    if not ws:
        failures.append("fresh bench has no w_scaling entry")
    else:
        for row in ws.get("rows", []):
            if not row.get("ring_bytes_ok"):
                failures.append(
                    f"w_scaling W={row['W']} shards={row['shards']}: "
                    f"transport ring bytes diverged from the roofline "
                    f"contract (WorkerShardPlan.ring_bytes != "
                    f"sharded_ring_bytes)")
        print("w_scaling engine dispatches: "
              + " ".join(f"shards={e['shards']}:{e['dispatches']}"
                         for e in ws.get("engine", []))
              + " (budget "
              + ",".join(str(e["dispatch_budget"])
                         for e in ws.get("engine", [])) + ")")
        for e in ws.get("engine", []):
            if e["dispatches"] > e["dispatch_budget"]:
                failures.append(
                    f"w_scaling engine W={e['W']} shards={e['shards']} "
                    f"took {e['dispatches']} dispatches > budget "
                    f"{e['dispatch_budget']} — the sharded round program "
                    f"must keep ceil(epochs/eval_every) superstep "
                    f"dispatches, layout is not allowed to break fusion")
        if not ws.get("rows"):
            failures.append("w_scaling entry has no rows")

    pv = fresh.get("privacy")
    if not pv:
        failures.append("fresh bench has no privacy entry")
    else:
        print(f"secagg clean parity: unmasked {pv['clean_acc']:.3f} vs "
              f"masked {pv['secagg_acc']:.3f} "
              f"(delta {pv['clean_delta']:.4f})")
        if pv["clean_delta"] > 0.01:
            failures.append(
                f"secagg clean accuracy delta {pv['clean_delta']:.4f} > "
                f"0.01 — the masked wire must decode bit for bit, so a "
                f"clean secagg run may not drift from the unmasked run")
        if not pv.get("mask_bytes_ok"):
            failures.append(
                f"secagg mask-byte accounting diverged from the roofline "
                f"contract (core.secagg.secagg_mask_bytes != "
                f"roofline.secagg_pad_bytes): {pv.get('mask_bytes')}")
        for fmt, row in pv.get("mask_bytes", {}).items():
            if row.get("wire_overhead_bytes", 0) != 0:
                failures.append(
                    f"secagg {fmt} wire overhead "
                    f"{row['wire_overhead_bytes']} B != 0 — the OTP must "
                    f"mask in place in the wire format's integer ring, "
                    f"never widen the payload")
        budget = pv["dispatch_budget"]
        disp = {**pv.get("dispatches", {}),
                **{f"attacked:{m}": r["dispatches"]
                   for m, r in pv.get("attacked", {}).items()}}
        print("secagg dispatches: "
              + " ".join(f"{n}={d}" for n, d in disp.items())
              + f" (budget {budget})")
        for name, d in disp.items():
            if d > budget:
                failures.append(
                    f"secagg {name} run took {d} dispatches > budget "
                    f"{budget} — pad derivation must stay traced data "
                    f"flow inside the scanned superstep, never a "
                    f"per-round host round-trip")
        att = pv.get("attacked", {})
        if "edge" in att and "masked_geom" in att:
            print(f"secagg masked_geom row family: edge "
                  f"{att['edge']['acc']:.3f} vs masked_geom "
                  f"{att['masked_geom']['acc']:.3f} "
                  f"(delta {pv['masked_geom_delta']:+.3f})")
        else:
            failures.append("privacy entry has no edge/masked_geom "
                            "attacked row family")

    tm = fresh.get("telemetry")
    if not tm:
        failures.append("fresh bench has no telemetry entry")
    else:
        print(f"telemetry superstep overhead: {tm['ratio']:.2f}x "
              f"probe-less ({tm['probes']} probes, "
              f"{tm['bytes_per_round']:.0f} B/round; dispatches "
              f"{tm['dispatches_on']} vs {tm['dispatches_off']})")
        if tm["dispatches_on"] != tm["dispatches_off"]:
            failures.append(
                f"telemetry changed the dispatch count: "
                f"{tm['dispatches_on']} vs {tm['dispatches_off']} — "
                f"probes must ride the scanned superstep as stacked ys, "
                f"never extra dispatches")
        # hard gate, NOT --tolerance: the telemetry plane's contract is a
        # fixed ≤1.10× budget at the paper round shape
        if tm["ratio"] > TELEMETRY_OVERHEAD_GATE:
            failures.append(
                f"telemetry-on superstep {tm['ratio']:.2f}x slower than "
                f"telemetry-off (hard gate {TELEMETRY_OVERHEAD_GATE:.2f}x)"
                f" — the probe emissions overran their budget")
    failures += launch_parity(fresh)
    return failures


# the contract benches whose variants must launch the same kernels a
# round (the port's reading of the reference's dispatch parity)
LAUNCH_PARITY = {
    "scenario_overhead": ("static", "scenario"),
    "geom_trust": ("loss", "geom"),
    "corr_trust": ("loss", "corr", "all"),
    "telemetry": ("off", "on"),
}


def launch_parity(fresh, entries=None):
    """Each contract bench's variants (``entries``, default
    ``LAUNCH_PARITY``) launch the same kernels a round
    (``launches_per_round_<variant>``: on the card the launches, on the
    CPU the wrappers' calls)."""
    failures = []
    for entry, variants in (entries or LAUNCH_PARITY).items():
        e = fresh.get(entry) or {}
        got = {v: e.get(f"launches_per_round_{v}") for v in variants}
        if any(g is None for g in got.values()):
            failures.append(f"{entry} has no kernel launches a round for "
                            f"{variants}")
            continue
        print(f"{entry} kernel launches a round: " + " / ".join(
            f"{v} {g}" for v, g in got.items()))
        if len({json.dumps(g, sort_keys=True) for g in got.values()}) > 1:
            failures.append(
                f"{entry} variants launch different kernels a round: "
                f"{got} — the variant must stay data flow on the same "
                f"round, never extra kernel work")
    return failures


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", required=True)
    ap.add_argument("--fresh", required=True)
    ap.add_argument("--tolerance", type=float, default=0.25)
    args = ap.parse_args(argv)

    with open(args.baseline) as fh:
        baseline = json.load(fh)
    with open(args.fresh) as fh:
        fresh = json.load(fh)
    print(f"baseline card: {baseline.get('card')}; fresh card: "
          f"{fresh.get('card')}")
    failures = check(baseline, fresh, args.tolerance)
    if failures:
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        return 1
    print("bench guard: ok")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
