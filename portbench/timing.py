"""Device timing and the traced steps' reading.

:func:`call_ms` times a call with CUDA events over repeated calls after a
warm-up.  :func:`traced` runs steps under ``torch.profiler`` (host and
device activity) and reads from the raw events: the union of device
activity over the traced window, the device operations that took most
time, and the idle gaps by the host span (``record_function``) they fell
in.
"""
from __future__ import annotations

import time
from collections import defaultdict

import torch

STEP = "portbench.step"


def call_ms(fn, warm: int = 2, reps: int = 5) -> float:
    """Mean milliseconds of ``fn()`` by CUDA events over ``reps`` calls,
    after ``warm`` calls; on the CPU by the host clock."""
    for _ in range(warm):
        fn()
    if not torch.cuda.is_available():
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t) * 1e3 / reps
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def traced(step, n: int, spans: tuple[str, ...]) -> dict:
    """Run ``step()`` ``n`` times under ``torch.profiler`` and read the
    window from the first step's start to the last one's end."""
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            with record_function(STEP):
                step()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    dev, host, steps = [], [], []
    for e in prof.profiler.kineto_results.events():
        a, b, name = e.start_ns(), e.end_ns(), e.name()
        if e.device_type() == cuda:
            # the spans' own ranges appear on the device too: not activity
            if name != STEP and name not in spans:
                dev.append((a, b, name))
        elif name == STEP:
            steps.append((a, b))
        elif name in spans:
            host.append((a, b, name))
    if not steps or not dev:
        return {}
    lo, hi = min(s[0] for s in steps), max(s[1] for s in steps)
    busy = _merge((max(a, lo), min(b, hi)) for a, b, _ in dev if b > lo and a < hi)
    busy_ns = sum(b - a for a, b in busy)
    by_op = defaultdict(int)
    for a, b, name in dev:
        by_op[name[:120]] += b - a
    gaps = defaultdict(int)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        label = next((s for s0, s1, s in host if s0 <= mid < s1), "other")
        gaps[label] += b - a
    top = lambda d: [[k, v / 1e9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"busy_s": busy_ns / 1e9, "window_s": (hi - lo) / 1e9,
            "device_ops": top(by_op), "idle_gaps": top(gaps)}
