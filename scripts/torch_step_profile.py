#!/usr/bin/env python3
"""Where a timestep of one of the PyTorch port's paths spends its time,
on one CUDA device.

    python3 scripts/torch_step_profile.py [--path P1] [--refinement N] [--plain] [--trace DIR]

Runs the path's configuration from ``chip_smoke.PATHS`` (P1: 3D
``irk_batched``, q=4; P2: 3D ``irk``, q=5; P3: 2D ``irk_batched``, q=4;
P4: 3D ``complex_irk_batched``, q=5, refinement 8; P5: 3D ``complex_irk``
(PRESB), q=5; P6: 3D ``spirk``, q=5, on a (5, 2) slot mesh; P7: 3D
``spirk``, q=2, refinement 8, on a (2, 2) slot mesh; P8: 3D
``complex_spirk_batched``, q=5, on a (3, 2) mesh; P9: 3D ``complex_spirk``
(PRESB), q=5, on a (3, 2) mesh — the slots of ``chip_smoke.SLOTS``, all on
the one card; P10: P4 with ``cheb_pair=True`` (K8 on the 255 level); P11:
3D ``ost``; P13: P1 with AMG; P15: P1 at Q2, refinement 6; P16, P17:
``irk_batched`` q=4 at Q3 and Q4, refinement 6; P18: ``spirk`` q=4 Q4,
refinement 5, on a (4, 2) mesh; P19: ``irk_batched`` q=5 Q4, refinement 6
(K1's route); P20: ``complex_irk_batched`` q=5 Q4, refinement 5; all
MatrixFree, InnerTolerance 0, OuterTolerance 1e-4, Q1 unless said, f32,
dt 0.1; P12: ``json/ost.json`` as shipped,
MatrixBased + AMG, Q4, f64, plain torch whatever ``--plain`` says)
for two warm-up steps, then profiles the next step with
``torch.profiler``: the step's wall time (host clock
around work that ends in a synchronise), the summed device time of its
kernels and the device's idle share, the number of kernel launches, and
the kernels ordered by device time.  ``--plain`` profiles the plain torch
arm instead of the hand-written kernels; ``--trace`` writes a Chrome
trace there.  Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def dev_us(e) -> float:
    """An averaged profiler event's own device time, in microseconds."""
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def device_events(prof) -> list:
    """The device-side events of a profile (kernels, memcpy/memset): the
    host-side ATen ops carry their children's device time as well and would
    count twice."""
    return [e for e in prof.key_averages()
            if e.device_type != torch.autograd.DeviceType.CPU and dev_us(e) > 0]


def main(argv=None) -> int:
    from chip_smoke import P12_JSON, PAIR_STEPPED, PATHS, SLOTS

    ap = argparse.ArgumentParser()
    ap.add_argument("--path", default="P1", choices=tuple(PATHS) + ("P12",))
    ap.add_argument("--refinement", type=int, default=None,
                    help="default: the path's own (chip_smoke.PATHS; P12: 5)")
    ap.add_argument("--plain", action="store_true")
    ap.add_argument("--trace", default=None)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")

    from dealii_spirk_tpu_torch.config import Parameters
    from dealii_spirk_tpu_torch.problem import HeatProblem
    from dealii_spirk_tpu_torch.schemes import make_scheme

    if args.path == "P12":
        with open(P12_JSON) as f:
            dim, cfg = 3, json.load(f)
    else:
        dim, cfg, _levels = PATHS[args.path]
    if args.refinement is not None:
        cfg = {**cfg, "NRefinements": args.refinement}
    params = Parameters.from_dict(cfg, dim=dim)
    device = torch.device("cuda", 0)
    problem = HeatProblem(params, device)
    mesh = None
    if args.path in SLOTS:
        from dealii_spirk_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(params.stage_axis_size, devices=[device] * SLOTS[args.path],
                         max_ranks=params.max_ranks, do_row_major=params.do_row_major,
                         padding=params.padding)
    kernels = None if args.path == "P12" else not args.plain  # MatrixBased: never
    scheme = make_scheme(problem, params, kernels=kernels, mesh=mesh,
                         cheb_pair=args.path in PAIR_STEPPED)
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

    kernels = device_events(prof)
    busy = sum(dev_us(e) for e in kernels) / 1e6
    n_launch = sum(e.count for e in kernels)
    log = scheme.step_log[-1]
    arm = "kernels" if scheme.kernels else "plain torch"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    stages = "" if params.time_integration_scheme == "ost" else f"q={params.irk_stages}, "
    print(f"{smi or torch.cuda.get_device_name(0)}; {args.path} ({params.time_integration_scheme}, "
          f"{dim}D, {stages}refinement {params.n_refinements}); arm: {arm}; "
          f"step counts {log}")
    if mesh is not None:
        print(f"slot mesh {scheme.mesh.shape}, every slot on {device}")
    print(f"step wall {wall * 1e3:.3f} ms; device busy {busy * 1e3:.3f} ms; "
          f"idle share {1 - busy / wall:.3f}; device ops {n_launch}")
    for e in sorted(kernels, key=dev_us, reverse=True)[: args.top]:
        print(f"  {dev_us(e) / 1e3:9.3f} ms  x{e.count:5d}  {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
