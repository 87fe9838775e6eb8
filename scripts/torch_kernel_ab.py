#!/usr/bin/env python3
"""Two versions of the port's K3dg and K9d side by side on one CUDA device:
``chip_smoke.py``'s measurement phase (and, with ``--smooth``, its K3dg
smooth-field rows) run on the package of each arm, in turns.

    python3 scripts/torch_kernel_ab.py --parent DIR [--arm-tree NAME=DIR ...]
                                       [--order parent,tree,tree,parent] [--smooth] [--check]
                                       [--out FILE]

``DIR`` holds another commit's tree (for example ``git archive`` of the
parent commit unpacked into a directory that ``.gitignore`` lists); "tree"
is this checkout; ``--arm-tree`` names further trees for ``--order``.
Each arm runs in a process of its own that imports
``dealii_spirk_tpu_torch`` from its tree (so it builds and launches that
tree's kernels) and this checkout's ``chip_smoke.py``, and measures the
MEASURE_CASES of K3dg and K9d (``cheb_iter_dg``, ``cheb_iter_dg_halo``):
device time per launch from ``torch.profiler``, time per call from CUDA
events, L2-warm and L2-cold, over ``chip_smoke.TURNS`` turns, beside the
bound; ``--check`` holds each kernel to its plain version at the measured
shape first, ``--smooth`` adds K3dg's smooth-field rows.  The arms'
wrappers must take the same Python arguments.  Prints one line per arm and
case, a table, and writes every figure as JSON to ``--out``.  Needs a CUDA
device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TAG = "AB_RESULT "
KEYS = ("cheb_iter_dg", "cheb_iter_dg_halo")


def run_arm(tree: str, smooth: bool, check: bool) -> dict:
    """In this process: the measurement of KEYS on ``tree``'s package;
    ``check``: each kernel held to its plain version at the measured shape
    first (``chip_smoke.REL_TOL``)."""
    sys.path.insert(0, os.path.abspath(tree))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    import dealii_spirk_tpu_torch
    from dealii_spirk_tpu_torch.ops.cuda import build

    pkg = os.path.dirname(os.path.abspath(dealii_spirk_tpu_torch.__file__))
    if not pkg.startswith(os.path.abspath(tree)):
        raise SystemExit(f"imported the package from {pkg}, not from {tree}")
    build.build()
    device = torch.device("cuda", 0)
    cases = [c for c in cs.MEASURE_CASES if c[0] in KEYS]
    if check:
        for case in cases:
            c = cs._measure_setup(*case, device)
            inputs = c["make"]()
            cs._hold(f"{tree}: {case[0]} {c['at']}", c["kern"](*inputs), c["plain"](*inputs),
                     cs.REL_TOL)
            del c, inputs
    out = {"tree": tree, "measured": cs.measure_kernels(device, cases)}
    if smooth:
        out["smooth"] = list(cs.smooth_rows(cs.smooth_cases_3d(device)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="the other commit's tree")
    ap.add_argument("--arm-tree", action="append", default=[], metavar="NAME=DIR")
    ap.add_argument("--order", default="parent,tree,tree,parent")
    ap.add_argument("--smooth", action="store_true")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--arm", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.arm is not None:
        print(TAG + json.dumps(run_arm(args.arm, args.smooth, args.check)), flush=True)
        return 0
    if "parent" in args.order.split(",") and args.parent is None:
        ap.error("--parent is required for a 'parent' arm")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    trees = {"parent": args.parent, "tree": ROOT}
    trees |= dict(t.split("=", 1) for t in args.arm_tree)
    runs = []
    for arm in args.order.split(","):
        cmd = [sys.executable, os.path.abspath(__file__), "--arm", trees[arm]]
        flags = [f"--{f}" for f in ("smooth", "check") if getattr(args, f)]
        proc = subprocess.run(cmd + flags, capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines() if not ln.startswith(TAG)]
        print("\n".join(f"[{arm}] {ln}" for ln in lines), flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], flush=True)
            raise SystemExit(f"arm {arm} failed ({proc.returncode})")
        res = json.loads(next(ln for ln in proc.stdout.splitlines() if ln.startswith(TAG))[len(TAG):])
        runs.append({"arm": arm, **res})
    print(f"{'arm':7s} {'case':58s} {'dev warm':>9s} {'dev cold':>9s} {'call warm':>9s} "
          f"{'call cold':>9s} {'bound':>7s} {'b/t cold dev':>12s}")
    for run in runs:
        for r in run["measured"]:
            cd = r["cold_device_ms"]
            print(f"{run['arm']:7s} {r['key'] + ' ' + r['at']:58.58s} {r['device_ms'] or 0:9.4f} "
                  f"{cd or 0:9.4f} {r['ms']:9.4f} {r['cold_ms']:9.4f} {r['bound_ms']:7.4f} "
                  f"{(r['bound_ms'] / cd) if cd else 0:12.3f}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": smi, "runs": runs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
