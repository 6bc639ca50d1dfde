"""Reductions of a ``torch.profiler`` trace of whole units of work: device
busy time as the union of device-operation intervals (so overlapping
operations count once), device time and calls by name, most time first,
and the device's idle time labelled by what the host was doing.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

SHORT_GAP_NS = 20_000      # gaps below this are launch spacing, not labelled


def collect(prof):
    """(device ops, host ops, spans) of a stopped profiler: lists of
    (start_ns, end_ns, name); device ops are the kernels, copies and sets
    on the card, host ops the CPU's operations and runtime calls, spans the
    ``record_function`` ranges."""
    from torch.autograd import DeviceType
    dev, host, spans = [], [], []
    for ev in prof.profiler.kineto_results.events():
        t0 = ev.start_ns()
        row = (t0, t0 + ev.duration_ns(), ev.name())
        if ev.device_type() == DeviceType.CUDA:
            dev.append(row)
        elif ev.device_type() == DeviceType.CPU:
            (spans if ev.is_user_annotation() else host).append(row)
    # a span's mirror on the device's timeline is no device operation
    names = {e[2] for e in spans}
    dev = [e for e in dev if e[2] not in names]
    return sorted(dev), sorted(host), sorted(spans)


def merged(intervals):
    """The union of (start, end, ...) intervals as sorted disjoint pairs."""
    out = []
    for t0, t1, *_ in intervals:
        if out and t0 <= out[-1][1]:
            if t1 > out[-1][1]:
                out[-1][1] = t1
        else:
            out.append([t0, t1])
    return out


def busy_ns(dev) -> int:
    return sum(t1 - t0 for t0, t1 in merged(dev))


def by_name(dev, limit=None):
    """[(name, seconds, calls)] of device ops, most time first."""
    tot, calls = defaultdict(int), defaultdict(int)
    for t0, t1, name in dev:
        tot[name] += t1 - t0
        calls[name] += 1
    rows = sorted(((n, tot[n] / 1e9, calls[n]) for n in tot),
                  key=lambda r: -r[1])
    return rows[:limit] if limit else rows


def _label(t, spans, span_starts, ops, op_starts):
    """What the host was doing at time t: the innermost span covering it and
    the op running then (or "python" between ops)."""
    span = "-"
    i = bisect.bisect_right(span_starts, t)
    while i > 0:
        i -= 1
        if spans[i][1] >= t:
            span = spans[i][2]
            break
        if span_starts[i] < t - 60_000_000_000:
            break
    op = "python"
    j = bisect.bisect_right(op_starts, t)
    for k in range(j - 1, max(j - 64, -1), -1):
        if ops[k][1] >= t:
            op = ops[k][2]
            break
    return f"{span} | {op}"


def idle_gaps(dev, ops, spans, t_start, t_end, limit=10):
    """[(label, seconds)] of the device's idle time inside [t_start, t_end]
    (ns), summed by what the host was doing when each gap began (the
    innermost span and the innermost host op), gaps under ``SHORT_GAP_NS``
    summed as one entry; most time first."""
    span_starts = [e[0] for e in spans]
    op_starts = [e[0] for e in ops]
    tot = defaultdict(int)
    prev = t_start
    for t0, t1 in merged(dev) + [[t_end, t_end]]:
        gap = min(t0, t_end) - prev
        if gap > 0:
            if gap < SHORT_GAP_NS:
                tot["short gaps (< 20 us)"] += gap
            else:
                tot[_label(prev, spans, span_starts, ops, op_starts)] += gap
        prev = max(prev, t1)
    rows = sorted(((k, v / 1e9) for k, v in tot.items()), key=lambda r: -r[1])
    return rows[:limit]
