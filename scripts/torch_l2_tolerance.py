#!/usr/bin/env python3
"""How far a scheme's L2 error moves with the outer solve's tolerance and
with the precision, at one configuration, on one CUDA device.

    python3 scripts/torch_l2_tolerance.py [--refinement 7] [--stages 5]
        [--schemes irk,complex_irk_batched,complex_irk] [--runs f32:1e-4,f64:1e-4,...]
        [--device cuda]

Runs each scheme of ``--schemes`` once per ``precision:OuterTolerance`` pair
of ``--runs`` (3D, Q1, MatrixFree + GMG, InnerTolerance 0, dt 0.1, three
steps: the widths of ``chip_smoke.PATHS``' P2, P8 and P9 without the mesh; f32
runs through the hand-written kernels, f64 through the plain torch
operators), and prints per run the L2 error, the per-step outer counts and
the L2's relative distance to the first scheme's at the same pair and to
the first scheme's at the last pair (by default f64 at 1e-8, the converged
answer).  It separates the two causes that can move one scheme's L2 from
another's: the solve error that the outer tolerance leaves, and f32
round-off.  Runs on the CUDA device unless ``--device cpu`` is given (then
at a small refinement); imports nothing of JAX.
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

_BASE = {
    "FEDegree": 1,
    "TimeStepSize": 0.1,
    "EndTime": 0.3,
    "OperatorType": "MatrixFree",
    "BlockPreconditionerType": "GMG",
    "InnerTolerance": 0.0,
    "DoOutputParaview": False,
}


def _counts(step):
    return step.get("n_outer_pair", step.get("n_outer"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--refinement", type=int, default=7)
    ap.add_argument("--stages", type=int, default=5)
    ap.add_argument("--schemes", default="irk,complex_irk_batched,complex_irk")
    ap.add_argument("--runs", default="f32:1e-4,f64:1e-4,f32:1e-6,f64:1e-6,f64:1e-8")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")

    from dealii_spirk_tpu_torch.config import Parameters
    from dealii_spirk_tpu_torch.runner import run_config

    if args.device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        print(f"card: {smi.stdout.strip()}", flush=True)
    schemes = args.schemes.split(",")
    runs = [(prec, float(tol)) for prec, tol in (r.split(":") for r in args.runs.split(","))]
    l2 = {}
    for scheme in schemes:
        for prec, tol in runs:
            cfg = {**_BASE, "NRefinements": args.refinement, "IRKStages": args.stages,
                   "TimeIntegrationScheme": scheme, "Precision": prec, "OuterTolerance": tol}
            t0 = time.perf_counter()
            out = run_config(Parameters.from_dict(cfg, dim=3), device=args.device,
                             verbose=False)
            seconds = time.perf_counter() - t0
            l2[scheme, prec, tol] = out["error_L2"]
            print(json.dumps({"scheme": scheme, "precision": prec, "outer_tolerance": tol,
                              "error_L2": out["error_L2"], "seconds": round(seconds, 3),
                              "outer": [_counts(s) for s in out["scheme"].step_log]}),
                  flush=True)
            del out
            if args.device == "cuda":
                torch.cuda.empty_cache()
    first, last = schemes[0], runs[-1]
    print(f"relative L2 distance to {first} at the same run | to {first} at "
          f"{last[0]}:{last[1]:g}", flush=True)
    for (scheme, prec, tol), value in l2.items():
        same = value / l2[first, prec, tol] - 1
        conv = value / l2[(first, *last)] - 1
        print(f"  {scheme:22s} {prec}:{tol:g}  {value:.6e}  {same:+.4%}  {conv:+.4%}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
