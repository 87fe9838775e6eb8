#!/usr/bin/env python3
"""The profiler records behind ``chip_smoke.py::device_ms``, on one CUDA
device.

    python3 scripts/torch_profiler_records.py [--phases N] [--out FILE]

Runs ``chip_smoke.py``'s kernel check, then its measurement phase
(``measure_kernels``) N times (default 2), keeping every profiler session
that ``device_ms`` opens (``profiler_session``).  Prints, over those
sessions:

* the kernel names each marker of ``DEVICE_NAMES`` selected (one kernel
  per marker, or the per-launch divisor mixes kernels);
* how many sessions each ``device_ms`` call needed before one was whole,
  and how many launches inside the timed span left no device record;
* at which places among the untimed primers a launch left no record (why
  the primers are there);
* the spread of a kernel's record durations around their session's
  median;
* every turn of ``measure_kernels`` whose device time read below its
  row's DRAM bound, and every turn that ``sub_bound`` dropped.

``--out FILE`` writes the sessions as JSON.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def recording(sessions: list) -> None:
    """Make ``chip_smoke``'s ``device_ms`` keep each session it opens,
    tagged with its marker and its call."""
    session, device_ms = cs.profiler_session, cs.device_ms
    call = {"n": 0, "marker": None}

    def profiler_session(fn, reps):
        out = session(fn, reps)
        sessions.append({"call": call["n"], "marker": call["marker"], **out})
        return out

    def tagged_device_ms(fn, marker, reps=20):
        call["n"] += 1
        call["marker"] = marker
        return device_ms(fn, marker, reps)

    cs.profiler_session, cs.device_ms = profiler_session, tagged_device_ms


def summarize(sessions: list, rows: list) -> dict:
    names = collections.defaultdict(set)
    tries = collections.Counter(collections.Counter(s["call"] for s in sessions).values())
    primers = collections.Counter(k for s in sessions for k in s["primers_missing"])
    lo = hi = 1.0
    for s in sessions:
        if s["marker"] is None:
            continue
        own = [us for name, us in s["records"] if any(mk in name for mk in s["marker"])]
        names[" | ".join(s["marker"])].update(
            name for name, _ in s["records"] if any(mk in name for mk in s["marker"]))
        if own:
            med = float(np.median(own))
            lo, hi = min(lo, min(own) / med), max(hi, max(own) / med)
    return {
        "sessions": len(sessions),
        "device_ms_calls_by_sessions_needed": dict(sorted(tries.items())),
        "timed_launches": sum(s["issued"] for s in sessions),
        "timed_launches_without_record": sum(s["missing"] for s in sessions),
        "primer_places_without_record": {f"{k} of {cs.PRIMERS}": v
                                         for k, v in sorted(primers.items())},
        "kernels_per_marker": {k: sorted(v) for k, v in names.items()},
        "record_over_session_median": [lo, hi],
        "turns_below_bound": [
            {"key": r["key"], "at": r["at"], "mode": mode, "turn": t + 1,
             "device_ms": turn[mode]["device_ms"], "bound_ms": r["bound_ms"]}
            for r in rows for t, turn in enumerate(r["turns"]) for mode in ("warm", "cold")
            if turn[mode]["device_ms"] is not None and turn[mode]["device_ms"] < r["bound_ms"]],
        "dropped_turns": [{"key": r["key"], "at": r["at"], "dropped": t["dropped"]}
                          for r in rows for t in r["turns"] if t["dropped"]],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device")
        return 1
    device = torch.device("cuda", 0)
    from dealii_spirk_tpu_torch.ops.cuda import build

    build.build()
    sessions: list = []
    recording(sessions)
    cs.check_kernels(device)
    rows = [r for _ in range(args.phases) for r in cs.measure_kernels(device)]
    summary = summarize(sessions, rows)
    print(json.dumps(summary, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"summary": summary, "sessions": sessions}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
