#!/usr/bin/env python3
"""How far an f32 ``irk_batched`` solve can be trusted as the stage count
grows, and whether its GMRES passes the compact basis's 12 columns: the
port on the CPU, 3D, MatrixFree + GMG, InnerTolerance 0.

    python3 scripts/torch_stage_precision.py [--degree 4] [--refinements 2]
        [--stages 4,5,6,7,8] [--dts 0.1] [--tols 1e-5] [--precisions f32,f64]
        [--compact] [--jax]

Prints the condition number of each stage count's T (the Radau IIA
diagonalisation whose T^-1 and T mixes wrap the V-cycle in the
preconditioner, ``tables.irk_tables``), then for every refinement, stage
count, time step, OuterTolerance and precision one run of 3 steps: the
outer counts and restarts per step, the true relative residual
||b - A W|| / ||b|| of each step's GMRES solution in the run's precision
(the solve stops on the preconditioned residual), and the L2 error.
``--compact`` lowers the compact GMRES threshold (``COMPACT_GRID_DOFS``)
so that every grid restarts every 12 columns, as refinement 6 and up do
at Q4; ``--jax`` runs the JAX package's ``irk_batched`` on the same
configuration in a child process (stencil mode; its counts summed over
the steps after the first, as its statistics are).  Runs on one thread;
imports nothing of JAX itself.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

JAX_CHILD = """
import json, os, sys, warnings
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import dealii_spirk_tpu.schemes.irk as jirk
from dealii_spirk_tpu.config import Parameters
from dealii_spirk_tpu.runner import run_config
cfg, compact = json.loads(sys.argv[1]), sys.argv[2] == "1"
if compact:
    jirk.COMPACT_GRID_DOFS = 100
with warnings.catch_warnings():
    warnings.simplefilter("ignore")
    out = run_config(Parameters.from_dict({**cfg, "OperatorMode": "stencil"}, dim=3),
                     verbose=False)
print(json.dumps({"n_outer": float(out["n_outer"]),
                  "n_inner_stage": np.asarray(out["scheme"].n_inner_stage).tolist(),
                  "error_L2": float(out["error_L2"])}))
"""


def config(p: int, ref: int, q: int, dt: float, tol: float, precision: str) -> dict:
    return {"FEDegree": p, "NRefinements": ref, "TimeIntegrationScheme": "irk_batched",
            "IRKStages": q, "TimeStepSize": dt, "EndTime": 3 * dt,
            "OperatorType": "MatrixFree", "BlockPreconditionerType": "GMG",
            "InnerTolerance": 0.0, "OuterTolerance": tol, "Precision": precision,
            "DoOutputParaview": False}


def run_port(cfg: dict) -> dict:
    """One run with each step's true relative residual recorded."""
    from dealii_spirk_tpu_torch.config import Parameters
    from dealii_spirk_tpu_torch.ops.cuda import stencil as st
    from dealii_spirk_tpu_torch.runner import run_config
    from dealii_spirk_tpu_torch.schemes import irk

    residuals = []
    solve = irk.IRK.solve_fn

    def solve_fn(self, W_rhs, prec, tau):
        out = solve(self, W_rhs, prec, tau)
        r = W_rhs - st.ms_mix_apply_ref(self.fine, self.A_inv, tau, out[0])
        residuals.append(float(r.norm() / W_rhs.norm()))
        return out

    irk.IRK.solve_fn = solve_fn
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            out = run_config(Parameters.from_dict(cfg, dim=3), device="cpu", verbose=False,
                             kernels=False)
    finally:
        irk.IRK.solve_fn = solve
    return {"counts": [(s["n_outer"], s["n_restarts"]) for s in out["scheme"].step_log],
            "residuals": residuals, "error_L2": out["error_L2"]}


def run_jax(cfg: dict, compact: bool) -> dict:
    res = subprocess.run([sys.executable, "-c", JAX_CHILD, json.dumps(cfg), str(int(compact))],
                         capture_output=True, text=True, cwd=ROOT, check=True)
    return json.loads(res.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--degree", type=int, default=4)
    ap.add_argument("--refinements", default="2")
    ap.add_argument("--stages", default="4,5,6,7,8")
    ap.add_argument("--dts", default="0.1")
    ap.add_argument("--tols", default="1e-5")
    ap.add_argument("--precisions", default="f32,f64")
    ap.add_argument("--compact", action="store_true")
    ap.add_argument("--jax", action="store_true")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)

    import dealii_spirk_tpu_torch.schemes.base as base
    from dealii_spirk_tpu_torch.tables import irk_tables

    if args.compact:
        base.COMPACT_GRID_DOFS = 100
    stages = [int(q) for q in args.stages.split(",")]
    for q in stages:
        print(f"q={q}: cond(T) {np.linalg.cond(irk_tables(q).T):.4e}", flush=True)
    for ref in (int(r) for r in args.refinements.split(",")):
        for q in stages:
            for dt in (float(v) for v in args.dts.split(",")):
                for tol in (float(v) for v in args.tols.split(",")):
                    for prec in args.precisions.split(","):
                        cfg = config(args.degree, ref, q, dt, tol, prec)
                        out = run_port(cfg)
                        print(f"Q{args.degree} r{ref} q={q} dt={dt:g} tol={tol:g} {prec}: "
                              f"(outer, restarts) per step {out['counts']}; true relative "
                              f"residual {', '.join(f'{r:.3e}' for r in out['residuals'])}; "
                              f"L2 {out['error_L2']:.6e}", flush=True)
                        if args.jax:
                            j = run_jax(cfg, args.compact)
                            print(f"  JAX: n_outer {j['n_outer']:g} and V-cycles per stage "
                                  f"{j['n_inner_stage'][0]:g} over steps 2-3; L2 "
                                  f"{j['error_L2']:.6e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
