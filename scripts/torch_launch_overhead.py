#!/usr/bin/env python3
"""Host time per call of the ways a kernel wrapper of the PyTorch port can
read the current CUDA stream's handle, on one CUDA device.

    python3 scripts/torch_launch_overhead.py [--calls N]

Times, on the host clock, N calls each of ``torch.cuda.current_stream()``
``.cuda_stream`` (builds a ``torch.cuda.Stream``) and
``torch._C._cuda_getCurrentRawStream`` (the handle alone; what
``ops/cuda/stencil.py::_launch_raw`` reads, and what PyTorch's generated
kernels launch with), in turns public, raw, raw, public, three times, and
prints the microseconds per call of each and their difference: the host
work one wrapper call saves by the raw read.  Needs a CUDA device; imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import time

import torch


def _us_per_call(fn, calls: int) -> float:
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t0) / calls * 1e6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=100_000)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device")
        return 1
    dev = torch.cuda.current_device()
    ways = {
        "public": lambda: torch.cuda.current_stream().cuda_stream,
        "raw": lambda: torch._C._cuda_getCurrentRawStream(dev),
    }
    assert ways["public"]() == ways["raw"]()
    for fn in ways.values():  # warm-up
        _us_per_call(fn, 1000)
    turns = []
    for _ in range(3):
        p1, r1, r2, p2 = (_us_per_call(ways[w], args.calls)
                          for w in ("public", "raw", "raw", "public"))
        turns.append({"public_us": (p1 + p2) / 2, "raw_us": (r1 + r2) / 2})
    for t in turns:
        t["saved_us"] = t["public_us"] - t["raw_us"]
    print(json.dumps({"device": torch.cuda.get_device_name(dev), "calls": args.calls,
                      "turns": turns}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
