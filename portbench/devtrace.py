"""The device's timeline from ``torch.profiler``, reduced to what the
per-layer metrics and the result's ``breakdown`` read.

The arithmetic of ``scripts/torch_step_profile.py`` (busy = the device's
time in its operations; idle share = 1 - busy / the host's wall time of
the profiled work, which ends in a synchronise), taken over one whole
steady episode instead of one step, with busy as the union of the device
intervals, so that operations that overlap count once.  The trace is
exported to a temporary file and read back as Chrome trace events.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict

import torch

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "cuda_runtime", "cuda_driver"}
MARK = "portbench.profiled"
NAME_CHARS = 120
SCAN = 1000


def profile(fn) -> dict:
    """Run ``fn()`` (which ends in a host read of a device result) under
    the profiler; its wall time and the trace's device and host events."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(MARK):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return reduce(events, wall)


def reduce(events: list[dict], wall: float) -> dict:
    """Device intervals, busy time, per-name device time and the host's
    work during each idle gap, from Chrome trace events (times in us)."""
    dev, host, mark = [], [], None
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        span = (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        if cat in DEVICE_CATS:
            dev.append((span, name))
        elif name == MARK and not cat.startswith("gpu"):
            mark = span
        elif cat in HOST_CATS:
            host.append((span, name))
    if mark is None:
        raise RuntimeError("the profiler's trace has no record of the profiled work")
    busy = merged(s for s, _ in dev)
    per_name = defaultdict(lambda: [0, 0.0])
    for (a, b), name in dev:
        per_name[name][0] += 1
        per_name[name][1] += (b - a) / 1e6
    return {
        "wall_s": wall,
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "device_ops": len(dev),
        "kernels": dict(per_name),
        "idle_by_host": idle_by_host(busy, host, mark),
    }


def merged(spans) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def idle_by_host(busy: list[tuple[float, float]], host, mark) -> dict:
    """Seconds of device idle time within ``mark`` by the innermost host
    event under each gap's midpoint (the host's Python between events when
    none is)."""
    edges = [mark[0]] + [x for ab in busy for x in ab] + [mark[1]]
    out: dict[str, float] = defaultdict(float)
    host = sorted(host)
    starts = [s[0] for s, _ in host]
    for a, b in zip(edges[0::2], edges[1::2]):
        a, b = max(a, mark[0]), min(b, mark[1])
        if b <= a:
            continue
        mid = (a + b) / 2
        label = "host Python, outside any op"
        # the latest-starting host event that still runs at mid, among the
        # SCAN events that started last before it
        last = bisect.bisect_right(starts, mid) - 1
        for i in range(last, max(last - SCAN, -1), -1):
            if host[i][0][1] >= mid:
                label = host[i][1]
                break
        out[label[:NAME_CHARS]] += (b - a) / 1e6
    return dict(out)


def top(pairs: dict, n: int = 10) -> list[list]:
    """The ``n`` largest of {name: seconds} as [[name, seconds], ...]."""
    return [[k[:NAME_CHARS], v] for k, v in sorted(pairs.items(), key=lambda kv: -kv[1])[:n]]
