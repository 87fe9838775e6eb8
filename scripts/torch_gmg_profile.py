#!/usr/bin/env python3
"""Where one CG solve of the GMG microbenchmark spends its time, per mode,
on one CUDA device.

    python3 scripts/torch_gmg_profile.py [--degree 1] [--refinement 8] [--modes a,b] [--top 6]

For each mode of ``gmg_bench`` (3D, f32, the kernels, as ``chip_smoke.py``'s
P14 runs it): the preconditioner state (``prepare_mode``) and a warm-up
solve, then one solve under ``torch.profiler``: its wall time (host clock
around work that ends in a synchronise), the summed device time of its
kernels, the device's idle share, the number of device ops, and the
kernels ordered by device time.  Needs a CUDA device; imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torch_step_profile import dev_us, device_events  # noqa: E402


def main(argv=None) -> int:
    from dealii_spirk_tpu_torch import gmg_bench as gb
    from dealii_spirk_tpu_torch.fem.grid import make_space
    from dealii_spirk_tpu_torch.solvers.gmg import build_gmg_data

    ap = argparse.ArgumentParser()
    ap.add_argument("--degree", type=int, default=1)
    ap.add_argument("--refinement", type=int, default=8)
    ap.add_argument("--modes", default=",".join(gb.MODES))
    ap.add_argument("--top", type=int, default=6)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip() or torch.cuda.get_device_name(0)
    space = make_space(3, args.degree, args.refinement)
    gmg = build_gmg_data(space, dtype=torch.float32, device=device)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for label in args.modes.split(","):
        solve, _ = gb.prepare_mode(space, gmg, 3, label, torch.float32, kernels=True,
                                   device=device)
        solve()  # warm-up
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            res = solve()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = device_events(prof)
        busy = sum(dev_us(e) for e in events) / 1e6
        n_it = int(torch.as_tensor(res.n_iterations).max())
        print(f"{smi}; gmg_bench Q{args.degree} r{args.refinement} {label}: {n_it} iterations; "
              f"solve wall {wall * 1e3:.3f} ms; device busy {busy * 1e3:.3f} ms; idle share "
              f"{1 - busy / wall:.3f}; device ops {sum(e.count for e in events)}")
        for e in sorted(events, key=dev_us, reverse=True)[: args.top]:
            print(f"  {dev_us(e) / 1e3:9.3f} ms  x{e.count:5d}  {e.key[:90]}")
        del solve, res, prof
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
