#!/usr/bin/env python3
"""How far a scheme's L2 error moves with the outer solve's tolerance and
with the precision, at one configuration, on one CUDA device.

    python3 scripts/torch_l2_tolerance.py [--dim 3] [--refinement 7] [--stages 5]
        [--degree 1] [--slots N] [--schemes irk,complex_irk_batched,complex_irk]
        [--runs f32:1e-4,f64:1e-4,...] [--dt 0.09] [--device cuda]
    python3 scripts/torch_l2_tolerance.py --dim 2     # P3: irk_batched, q=4, refinement 10

Runs each scheme of ``--schemes`` once per ``arm:OuterTolerance`` pair of
``--runs`` (degree ``--degree``, by default Q1; MatrixFree + GMG,
InnerTolerance 0, dt 0.1, three steps, or three of ``--dt``: another step
size gives the same path another rounding; a stage-parallel scheme on
``--slots`` slots of the device, as ``chip_smoke.SLOTS`` gives them).
An arm is a precision and the operators it runs on: ``f32`` through the
hand-written kernels, ``f32-plain`` through the plain torch operators in
f32, ``f64`` through the plain torch operators, and ``f32-but-<wrapper>``
through the kernels but one, whose wrapper (``stage_mix``,
``mass_stiffness_apply`` or ``stencil_apply``, 2D and 3D alike; in 3D also
``cheb_iter``, ``cheb_iter_dg``, ``ms_mix_apply`` or ``transfer``, K10's
two grid transfers) runs its plain version: the arm that finds a kernel
which moves the L2.  P4's arms, for
instance:

    python3 scripts/torch_l2_tolerance.py --refinement 8 --stages 5 \
        --schemes complex_irk_batched \
        --runs f32:1e-4,f32-plain:1e-4,f32-but-cheb_iter_dg:1e-4,...  The defaults are, in 3D,
the widths of ``chip_smoke.PATHS``' P2, P8 and P9 without the mesh, and in
2D (``--dim 2``) P3's: ``irk_batched``, q=4, refinement 10, both f32 arms
and f64 at 1e-4 and 1e-6 (f64 at 1e-8 last).  Prints per run the L2 error,
the per-step outer counts and the L2's relative distance to the first
scheme's at the same pair and to the first scheme's at the last pair (by
default f64 at 1e-8, the converged answer).  It separates the causes that
can move one L2 from another: the solve error that the outer tolerance
leaves, f32 round-off, and (the two f32 arms apart) the kernels' own
arithmetic.  Runs on the CUDA device unless ``--device cpu`` is given (then
at a small refinement); imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
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


# per dimension: (refinement, stages, schemes, runs)
DEFAULTS = {
    3: (7, 5, "irk,complex_irk_batched,complex_irk",
        "f32:1e-4,f64:1e-4,f32:1e-6,f64:1e-6,f64:1e-8"),
    2: (10, 4, "irk_batched",
        "f32:1e-4,f32-plain:1e-4,f64:1e-4,f32:1e-6,f32-plain:1e-6,f64:1e-8"),
}


# the wrappers an f32-but-<wrapper> arm may swap for their plain versions
SWAPPABLE = ("stage_mix", "mass_stiffness_apply", "stencil_apply", "cheb_iter", "cheb_iter_dg",
             "ms_mix_apply")
# and f32-but-transfer: both of K10's grid transfers (ops/cuda/transfer.py)
TRANSFER = "transfer"


def parse_runs(spec: str) -> list[tuple[str, float]]:
    """``"f32:1e-4,f32-plain:1e-6,..."`` -> [(arm, OuterTolerance), ...]."""
    runs = [(arm, float(tol)) for arm, tol in (r.split(":") for r in spec.split(","))]
    for arm, _tol in runs:
        if (arm not in ("f32", "f32-plain", "f64")
                and arm.removeprefix("f32-but-") not in SWAPPABLE + (TRANSFER,)):
            raise ValueError(f"unknown arm {arm!r}: f32, f32-plain, f64 or f32-but-<one of "
                             f"{', '.join(SWAPPABLE + (TRANSFER,))}>")
    return runs


@contextlib.contextmanager
def plain_wrapper(name: str | None):
    """Within the block, the kernel wrapper ``name`` of ``ops/cuda/stencil.py``
    runs its plain version (the schemes look the wrappers up at each call);
    ``transfer``: both of K10's (``ops/cuda/transfer.py``)."""
    from dealii_spirk_tpu_torch.ops.cuda import stencil as st
    from dealii_spirk_tpu_torch.ops.cuda import transfer as tr

    if name is None:
        yield
        return
    if name == TRANSFER:
        swaps = [(tr, "restrict_residual", lambda t, rl, ax: tr.restrict_residual_ref(t.P, rl, ax)),
                 (tr, "prolong_add", lambda t, x, xc: tr.prolong_add_ref(t.P, x, xc))]
    else:
        swaps = [(st, name, getattr(st, name + "_ref"))]
    kernels = [(mod, attr, getattr(mod, attr)) for mod, attr, _plain in swaps]
    for mod, attr, plain in swaps:
        setattr(mod, attr, plain)
    try:
        yield
    finally:
        for mod, attr, kernel in kernels:
            setattr(mod, attr, kernel)


def run(dim: int, refinement: int, stages: int, schemes: list[str],
        runs: list[tuple[str, float]], device: str = "cuda", degree: int = 1,
        slots: int | None = None, dt: float | None = None) -> list[dict]:
    """One ``run_config`` per scheme and (arm, OuterTolerance); a record per
    run: scheme, arm, precision, whether the kernels ran, tolerance, L2
    error, per-step outer counts, seconds."""
    from dealii_spirk_tpu_torch.config import Parameters
    from dealii_spirk_tpu_torch.runner import run_config

    records = []
    for scheme in schemes:
        for arm, tol in runs:
            prec = arm.split("-")[0]
            cfg = {**_BASE, "FEDegree": degree, "NRefinements": refinement,
                   "IRKStages": stages, "TimeIntegrationScheme": scheme, "Precision": prec,
                   "OuterTolerance": tol}
            if dt is not None:
                cfg |= {"TimeStepSize": dt, "EndTime": 3 * dt}
            options = {"kernels": False} if arm.endswith("-plain") else {}
            swapped = arm.removeprefix("f32-but-") if arm.startswith("f32-but-") else None
            t0 = time.perf_counter()
            with plain_wrapper(swapped):
                out = run_config(Parameters.from_dict(cfg, dim=dim), device=device,
                                 verbose=False, slots=slots, **options)
            seconds = time.perf_counter() - t0
            records.append({
                "scheme": scheme, "arm": arm, "precision": prec,
                "kernels": out["scheme"].kernels, "outer_tolerance": tol,
                "error_L2": out["error_L2"], "seconds": round(seconds, 3),
                "outer": [_counts(s) for s in out["scheme"].step_log],
            })
            print(json.dumps(records[-1]), flush=True)
            del out
            if device == "cuda":
                torch.cuda.empty_cache()
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dim", type=int, default=3, choices=(2, 3))
    ap.add_argument("--refinement", type=int, default=None)
    ap.add_argument("--stages", type=int, default=None)
    ap.add_argument("--degree", type=int, default=1)
    ap.add_argument("--slots", type=int, default=None)
    ap.add_argument("--schemes", default=None)
    ap.add_argument("--runs", default=None,
                    help="arm:OuterTolerance pairs; arms f32 (kernels), f32-plain, f64, "
                    "f32-but-<wrapper>")
    ap.add_argument("--dt", type=float, default=None, help="step size of the three steps")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    ref, stages, schemes, runs = DEFAULTS[args.dim]
    ref = ref if args.refinement is None else args.refinement
    stages = stages if args.stages is None else args.stages
    schemes = (schemes if args.schemes is None else args.schemes).split(",")
    runs = parse_runs(runs if args.runs is None else args.runs)

    if args.device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        print(f"card: {smi.stdout.strip()}", flush=True)
    records = run(args.dim, ref, stages, schemes, runs, args.device, args.degree, args.slots,
                  args.dt)
    l2 = {(r["scheme"], r["arm"], r["outer_tolerance"]): r["error_L2"] for r in records}
    first, last = schemes[0], runs[-1]
    print(f"relative L2 distance to {first} at the same run | to {first} at "
          f"{last[0]}:{last[1]:g}", flush=True)
    for (scheme, arm, tol), value in l2.items():
        same = value / l2[first, arm, tol] - 1
        conv = value / l2[(first, *last)] - 1
        print(f"  {scheme:22s} {arm}:{tol:g}  {value:.6e}  {same:+.4%}  {conv:+.4%}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
