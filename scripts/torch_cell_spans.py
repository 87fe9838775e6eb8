#!/usr/bin/env python3
"""Where a benchmark cell's step goes, by the port's own phases, on one
CUDA device.

    python3 scripts/torch_cell_spans.py --workload <cell> [--seed N] [--episodes N] [--out FILE]

Builds the cell of ``BENCHMARK.json`` as ``portbench/run.py`` does (set-up
and one warm-up episode), then:

* times what a phase costs with the inner phases off and no profiler
  (``PhaseTimers.phase`` entered and left, microseconds per call, on the
  host);
* runs ``--episodes`` episodes with tracing off, the window: milliseconds
  per step on the host clock;
* runs one episode with the phase timers on inside its steps
  (``System.spans``): every phase's milliseconds per step, the leaves'
  sum against ``total`` + ``errors`` (the share no leaf covers), and
  ``total`` + ``errors`` per step against the window's step;
* runs one episode under ``torch.profiler`` with the inner phases off:
  the device's idle share (1 - busy / wall, busy the union of the device's
  operations), the ``spirk.*`` ranges entered per step, the device's idle
  seconds by the innermost ``spirk.*`` range under each idle gap's midpoint
  (and the share outside every range), and each device operation's time
  by the innermost range around its launch.

Prints one JSON object last, and writes it to ``--out`` as well where
given.  Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from collections import Counter, defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import devtrace  # noqa: E402
from portbench import run as prun  # noqa: E402

PREFIX = "spirk."
OUTSIDE = "(outside every range)"


def off_cost_us(timers, n: int = 200_000) -> float:
    """Microseconds per entry and exit of an inner phase, inner off, no
    profiler (the least of five rounds)."""
    phase = timers.phase
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(n):
            with phase("mg_smooth"):
                pass
        best = min(best, time.perf_counter() - t0)
    return best / n * 1e6


def innermost(ranges, points):
    """For each point (sorted), the name of the innermost range (start,
    end, name) that holds it, or None; the ranges nest."""
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    out, stack, i = [], [], 0
    for x in points:
        while i < len(ranges) and ranges[i][0] <= x:
            while stack and stack[-1][1] <= ranges[i][0]:
                stack.pop()
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][1] < x:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def trace_episode(episode) -> tuple[list[dict], float]:
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(devtrace.MARK):
            t0 = time.perf_counter()
            episode()
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
    return events, wall


def by_range(events: list[dict], wall: float, steps: int) -> dict:
    dev, ranges, launches, mark = [], [], {}, None
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        a = float(e["ts"])
        b = a + float(e["dur"])
        if cat in devtrace.DEVICE_CATS:
            dev.append((a, b, name, (e.get("args") or {}).get("correlation")))
        elif cat == "user_annotation" and name == devtrace.MARK:
            mark = (a, b)
        elif cat == "user_annotation" and name.startswith(PREFIX):
            ranges.append((a, b, name[len(PREFIX):]))
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = a
    if mark is None:
        raise RuntimeError("the profiler's trace has no record of the profiled work")
    busy = devtrace.merged((a, b) for a, b, _, _ in dev)
    edges = [mark[0]] + [x for ab in busy for x in ab] + [mark[1]]
    gaps = []
    for a, b in zip(edges[0::2], edges[1::2]):
        a, b = max(a, mark[0]), min(b, mark[1])
        if b > a:
            gaps.append((a, b))
    idle = defaultdict(float)
    for (a, b), label in zip(gaps, innermost(ranges, [(a + b) / 2 for a, b in gaps])):
        idle[label or OUTSIDE] += (b - a) / 1e6
    idle_s = sum(idle.values())
    # each device operation by the innermost range around its launch
    launched = sorted((launches.get(c, a), b - a, name) for a, b, name, c in dev)
    ops = defaultdict(float)
    op_names = defaultdict(lambda: defaultdict(float))
    for (t, d, name), label in zip(launched, innermost(ranges, [t for t, _, _ in launched])):
        ops[label or OUTSIDE] += d / 1e6
        op_names[label or OUTSIDE][name[:90]] += d / 1e6
    busy_s = sum(b - a for a, b in busy) / 1e6
    return {
        "wall_s": wall,
        "busy_s": busy_s,
        "idle_share": 1.0 - busy_s / wall,
        "device_ops_per_step": len(dev) / steps,
        "ranges_per_step": len(ranges) / steps,
        "ranges_per_step_by_name": {k: v / steps for k, v in sorted(
            Counter(r[2] for r in ranges).items())},
        "idle_s": idle_s,
        "idle_s_by_range": dict(sorted(idle.items(), key=lambda kv: -kv[1])),
        "idle_outside_share": idle.get(OUTSIDE, 0.0) / idle_s if idle_s else 0.0,
        "device_s_by_range": dict(sorted(ops.items(), key=lambda kv: -kv[1])),
        "top_ops_by_range": {k: devtrace.top(v, 6) for k, v in op_names.items()},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=7_300_000_001)
    ap.add_argument("--episodes", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(4)

    cell = prun.Cell(args.workload, "cuda")
    system, steps = cell.system, cell.steps
    u0 = cell.start(args.seed)
    cell.episode(u0)  # warm-up
    timers = system.scheme.timers
    out = {"workload": args.workload, "seed": args.seed, "power": prun.power_limit(),
           "phase_off_us": off_cost_us(timers)}

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.episodes):
        cell.episode(u0)
    out["window_step_ms"] = (time.perf_counter() - t0) / (args.episodes * steps) * 1e3

    with system.spans() as spans:
        cell.episode(u0)
    torch.cuda.synchronize()
    ms = {k: (None if v is None else v / steps * 1e3) for k, v in spans.items()}
    out["spans_ms_per_step"] = ms
    whole = ms["total"] + (ms["errors"] or 0.0)
    out["spans_step_ms"] = whole
    out["spans_cost"] = whole / out["window_step_ms"] - 1.0
    out["metrics"] = {m: prun.read_metric(m, {"spans": {"steps": steps, **spans}})
                      for m in ("rhs_ms_per_step", "krylov_vectors_ms_per_step",
                                "krylov_host_ms_per_step", "mg_smooth_ms_per_step",
                                "mg_transfer_ms_per_step", "errors_ms_per_step",
                                "unspanned_share")}

    events, wall = trace_episode(lambda: cell.episode(u0))
    out["profiled"] = by_range(events, wall, steps)
    out["phase_off_ms_per_step"] = out["phase_off_us"] * out["profiled"]["ranges_per_step"] / 1e3
    out["phase_off_share"] = out["phase_off_ms_per_step"] / out["window_step_ms"]

    text = json.dumps(out)
    if args.out:
        path = Path(args.out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
