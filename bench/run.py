#!/usr/bin/env python3
"""The port's benchmark: one run of one cell.

    python3 bench/run.py --workload NAME --seed N --seconds S --trace 0|1

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``bench/configs/<config>.json``), a traffic mix
(``bench/traffic/<traffic>.json``) and its check's limits
(``bench/workloads/<name>.json``). The mix names its kind, the system
under test and its check (``bench/systems/<kind>``); every metric, end to
end or per layer, is read by ``bench/metrics/<metric>.py``. All are found
by name, so a new cell, mix, kind or metric is new files.

A run: set-up (inputs from the seed, the program's objects, and the kind's
first unit of work, read for the check, which also warms every shape the
window uses), then whole units of work for ``--seconds`` (the window),
then, with the program's state freed, the plain reference and the
comparison. ``--trace 1`` profiles further units after the window and
reports the per-layer metrics instead of the end-to-end ones. The last
line of standard output is one JSON object; the numbers compared, each
beside its limit, are the last lines of standard error and the last key of
that object.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse                                     # noqa: E402
import importlib.util                               # noqa: E402
import json                                         # noqa: E402
import os                                           # noqa: E402
import subprocess                                   # noqa: E402
import sys                                          # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = ("jax", "jaxlib", "flax", "repro")         # top-level names


def _paths():
    for p in (os.path.join(ROOT, "src"), ROOT):
        if p not in sys.path:
            sys.path.insert(0, p)
    # every kernel and compiler cache inside the checkout, at fixed paths
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(ROOT, "build", "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(ROOT, "build", "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    # load from one process with few host threads
    os.environ.setdefault("OMP_NUM_THREADS", "1")


def load_cell(name: str, root: str = ROOT) -> dict:
    """The cell's manifest entry with its configuration, traffic and check
    files, and the end-to-end and per-layer metrics it reports."""
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        manifest = json.load(fh)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in manifest["configs"]}[cell["config"]]

    def load(*parts):
        with open(os.path.join(root, *parts)) as fh:
            return json.load(fh)
    return {
        "root": root,
        "cell": cell,
        "manifest": manifest,
        "config": load(conf["file"]),
        "traffic": load("bench", "traffic", cell["traffic"] + ".json"),
        "limits": load("bench", "workloads", name + ".json"),
        "per_layer": [m for m in manifest["per_layer"]
                      if name in m.get("workloads", [name])],
        "end_to_end": [m for m in manifest["end_to_end"]
                       if name in m.get("workloads", [name])],
    }


def system_module(cell: dict):
    """The cell's kind of system under test, ``bench/systems/<kind>``."""
    return importlib.import_module(
        f"bench.systems.{cell['traffic']['kind']}")


def read_metric(name: str, record: dict, root: str = ROOT):
    """The value of metric ``name`` (``bench/metrics/<name>.py``'s
    ``read(record)``), or None where it finds nothing to read."""
    path = os.path.join(root, "bench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(record)


def banned_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30)
        return float(out.stdout.split()[0])
    except Exception:                               # noqa: BLE001
        return None


def profile(system, record):
    """Two more whole units of work after the window, each under the
    profiler. The first traces the device alone, which costs the host
    little: the device's busy time, its operations and every kernel's
    calls and time. The second traces the host too, whose recording slows
    it: what the host was doing in the device's idle gaps."""
    import torch
    from torch.profiler import ProfilerActivity, profile as profiler

    from bench import trace
    from repro_torch.kernels import ops
    # the profiler's first session initialises the device tracer, which
    # takes seconds: pay that outside the traced units
    prof = profiler(activities=[ProfilerActivity.CUDA])
    prof.start()
    torch.ones(1, device=system.dev).add_(1)
    torch.cuda.synchronize(system.dev)
    prof.stop()
    before = dict(ops.LAUNCHES)
    prof = profiler(activities=[ProfilerActivity.CUDA])
    prof.start()
    traced = system.window(0.0)
    prof.stop()
    dev, _, _ = trace.collect(prof)
    del prof
    ops_by_name = trace.by_name(dev)
    record.update(
        traced=traced, window_s=traced["wall_s"],
        busy_s=trace.busy_ns(dev) / 1e9,
        device_ops=[[n, s] for n, s, _ in ops_by_name[:10]],
        kernels={n: (c, s) for n, s, c in ops_by_name},
        launches={k: ops.LAUNCHES[k] - before.get(k, 0) for k in ops.LAUNCHES})
    prof = profiler(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    record["profiled"] = [traced, system.window(0.0)]
    prof.stop()
    dev, host, spans = trace.collect(prof)
    del prof
    t_start = min(e[0] for e in host + spans + dev)
    t_end = max(e[1] for e in host + spans + dev)
    record["idle_gaps"] = [[n, s] for n, s in trace.idle_gaps(
        dev, host, spans, t_start, t_end)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()
    cell = load_cell(args.workload)

    import torch
    torch.set_num_threads(1)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell["cell"]["chips"]:
        print(f"needs {cell['cell']['chips']} CUDA device(s); found {cards}",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      device="cuda")
    found = banned_modules()
    if found:
        print(f"modules of the JAX package or JAX were loaded: {found}",
              file=sys.stderr)
        return 3
    print(f"window {result['window']}", file=sys.stderr)
    for name, where in result["worst"].items():
        print(f"worst {name}: {where}", file=sys.stderr)
    for name, row in result["checks"].items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r} "
              f"{'ok' if row['value'] <= row['limit'] else 'FAIL'}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


def judge(numbers: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}) in the limits' order."""
    rows = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(r["value"] <= r["limit"] for r in rows.values())
    return ok, rows


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, *,
             device="cuda", fault=None, t_start=None) -> dict:
    """One run of a cell; the result object of the last line."""
    import torch

    t_start = T_START if t_start is None else t_start
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    system = system_module(cell).System(cell["config"], cell["traffic"],
                                        seed, dev, fault=fault)
    attempted, failed = system.setup()
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    setup_peak = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    win = system.window(seconds)
    record = {"config": cell["config"], "traffic": cell["traffic"],
              "window": win, "setup_s": setup_s, "window_peak_bytes": 0}
    peak = 0
    if on_card:
        torch.cuda.synchronize()
        record["window_peak_bytes"] = torch.cuda.max_memory_allocated()
        peak = max(record["window_peak_bytes"], setup_peak)
        if trace and "error" not in win:
            profile(system, record)
    runs = [win] + record.get("profiled", [])
    attempted += sum(w["attempted"] for w in runs)
    failed += sum(w["failed"] for w in runs)
    error = next((w["error"] for w in runs if "error" in w), None)

    # the program's state goes; then the reference
    system.free()
    numbers, worst = system.compare()
    ok, rows = judge(numbers, cell["limits"]["limits"])
    correct = ok and failed == 0 and error is None

    metrics = {}
    for m in cell["per_layer"] if trace else cell["end_to_end"]:
        v = read_metric(m["name"], record, cell["root"])
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": failed, "metrics": metrics}
    if on_card:
        out["device"] = {"platform": "gpu",
                         "kind": torch.cuda.get_device_name(dev),
                         "count": cell["cell"]["chips"],
                         "memory_peak_bytes": peak,
                         "power_limit_w": power_limit()}
    else:
        out["device"] = {"platform": "cpu", "kind": "cpu", "count": 1,
                         "memory_peak_bytes": 0}
    if trace and "busy_s" in record:
        out["device"].update(busy_s=record["busy_s"],
                             window_s=record["window_s"])
        out["breakdown"] = {"device_ops": record["device_ops"],
                            "idle_gaps": record["idle_gaps"]}
    if error is not None:
        out["error"] = error
    out["window"] = {k: win[k] for k in ("attempted", "samples", "wall_s")}
    if win.get("step_s"):
        out["window"].update(step_s_min=min(win["step_s"]),
                             step_s_max=max(win["step_s"]))
    out["window"]["host"] = win.get("host")
    if "traced" in record:
        out["window"]["traced_s"] = record["traced"]["wall_s"]
    out["worst"] = worst
    out["checks"] = rows
    return out


if __name__ == "__main__":
    sys.exit(main())
