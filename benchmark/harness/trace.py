"""The traced window: one stretch of a cell's work under torch.profiler,
reduced to the device's busy time (the union of its operations' intervals),
its operations by name, and the longest idle gaps by what the host was
doing meanwhile. The busy-share arithmetic is that of the port's smoke run
(chip_smoke._report_profile), over the union of intervals so that
overlapping operations count once."""

from __future__ import annotations

import time
from collections import defaultdict

import numpy as np

TOP = 10
NAME_CHARS = 120


def traced(fn):
    """Run ``fn()`` under torch.profiler, synchronised at both ends;
    returns (its result, the reduced trace)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return out, reduce_events(spans(prof), wall)


def spans(prof):
    """[(name, on the device, start us, end us)] of every event of the
    profiler's run, read from its raw kineto events: building
    ``prof.events()`` takes minutes at a million events, reading these
    seconds."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        annotation = getattr(e, "is_user_annotation", None)
        if annotation is not None and annotation():
            continue
        start = e.start_ns() / 1e3
        out.append((e.name(), e.device_type() == DeviceType.CUDA, start,
                    start + e.duration_ns() / 1e3))
    return out


def union(intervals):
    """Merged [start, end] intervals, sorted."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce_events(events, wall_s):
    """{window_s, busy_s, kernels (launches), device_ops {name: seconds},
    calls {name: count}, idle_gaps [[host op, seconds]]} from the
    profiler's events, (name, on the device, start us, end us) each; times
    out in seconds."""
    dev, host = [], []
    for e in events:
        (dev if e[1] else host).append(e)
    by_name, calls = defaultdict(float), defaultdict(int)
    intervals = []
    kernels = 0
    for name, _, s, t in dev:
        if t <= s:
            continue
        intervals.append((s, t))
        by_name[name] += (t - s) * 1e-6
        calls[name] += 1
        if not name.startswith(("Memcpy", "Memset")):
            kernels += 1
    merged = union(intervals)
    busy = sum(t - s for s, t in merged) * 1e-6
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
    gaps.sort(key=lambda g: g[0] - g[1])
    h_start = np.array([e[2] for e in host], dtype=np.float64)
    h_end = np.array([e[3] for e in host], dtype=np.float64)
    idle = []
    for gs, ge in gaps[:TOP]:
        # the innermost host op under way: of those that cover at least
        # half as much of the gap as the one that covers most, the shortest
        overlap = np.minimum(ge, h_end) - np.maximum(gs, h_start)
        best = "(none)"
        if overlap.size and overlap.max() > 0:
            top = np.flatnonzero(overlap >= 0.5 * overlap.max())
            best = host[top[np.argmin((h_end - h_start)[top])]][0]
        idle.append([best[:NAME_CHARS], (ge - gs) * 1e-6])
    return {"window_s": wall_s, "busy_s": busy, "kernels": kernels,
            "device_ops": dict(by_name), "calls": dict(calls),
            "idle_gaps": idle}


def breakdown(tr):
    """The result line's ``breakdown``: the device operations that took
    most time and the longest idle gaps, at most TOP each."""
    ops = sorted(tr["device_ops"].items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[k[:NAME_CHARS], v] for k, v in ops],
            "idle_gaps": tr["idle_gaps"][:TOP]}


def named(tr, fragment):
    """(device seconds, calls) of the operations whose name holds
    ``fragment``."""
    secs = sum(v for k, v in tr["device_ops"].items() if fragment in k)
    n = sum(v for k, v in tr["calls"].items() if fragment in k)
    return secs, n
