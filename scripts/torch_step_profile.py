#!/usr/bin/env python3
"""Where a timestep of the PyTorch port's main path spends its time, on
one CUDA device.

    python3 scripts/torch_step_profile.py [--refinement 7] [--plain] [--trace DIR]

Runs ``irk_batched`` (3D, Q1, q=4, MatrixFree + GMG, InnerTolerance 0,
OuterTolerance 1e-4, f32, dt 0.1) for one warm-up step, then profiles the
next step with ``torch.profiler``: the step's wall time (host clock
around work that ends in a synchronise), the summed device time of its
kernels and the device's idle share, the number of kernel launches, and
the kernels ordered by device time.  ``--plain`` profiles the plain torch
arm instead of the hand-written kernels; ``--trace`` writes a Chrome
trace there.  Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--refinement", type=int, default=7)
    ap.add_argument("--plain", action="store_true")
    ap.add_argument("--trace", default=None)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")

    from dealii_spirk_tpu_torch.config import Parameters
    from dealii_spirk_tpu_torch.problem import HeatProblem
    from dealii_spirk_tpu_torch.schemes import make_scheme

    params = Parameters.from_dict(
        {
            "FEDegree": 1, "NRefinements": args.refinement,
            "TimeIntegrationScheme": "irk_batched", "IRKStages": 4,
            "TimeStepSize": 0.1, "EndTime": 0.5, "OperatorType": "MatrixFree",
            "BlockPreconditionerType": "GMG", "InnerTolerance": 0.0,
            "OuterTolerance": 1e-4, "Precision": "f32", "DoOutputParaview": False,
        },
        dim=3,
    )
    device = torch.device("cuda", 0)
    problem = HeatProblem(params, device)
    scheme = make_scheme(problem, params, kernels=not args.plain)
    tau = params.time_step_size
    u = scheme.solve_step(problem.initial_condition(), 1, tau, tau)
    u = scheme.solve_step(u, 2, 2 * tau, tau)  # second warm-up (allocator, caches)
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        u = scheme.solve_step(u, 3, 3 * tau, tau)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if args.trace:
        os.makedirs(args.trace, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.trace, "step.json"))

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # device-side events only (kernels, memcpy/memset): the host-side ATen
    # ops carry their children's device time as well and would count twice
    kernels = [
        e for e in prof.key_averages()
        if e.device_type != torch.autograd.DeviceType.CPU and dev_us(e) > 0
    ]
    busy = sum(dev_us(e) for e in kernels) / 1e6
    n_launch = sum(e.count for e in kernels)
    log = scheme.step_log[-1]
    arm = "plain torch" if args.plain else "kernels"
    print(f"{torch.cuda.get_device_name(0)}; arm: {arm}; refinement {args.refinement}; "
          f"step counts {log}")
    print(f"step wall {wall * 1e3:.3f} ms; device busy {busy * 1e3:.3f} ms; "
          f"idle share {1 - busy / wall:.3f}; device ops {n_launch}")
    for e in sorted(kernels, key=dev_us, reverse=True)[: args.top]:
        print(f"  {dev_us(e) / 1e3:9.3f} ms  x{e.count:5d}  {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
