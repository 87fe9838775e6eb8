#!/usr/bin/env python3
"""Two versions of the port's z-marching kernels side by side on one CUDA
device: ``chip_smoke.py``'s measurement phase (and, with ``--smooth``, its
3D smooth-field rows) run on the package of each arm, in turns.

    python3 scripts/torch_kernel_ab.py --parent DIR [--arm-tree NAME=DIR ...]
                                       [--order parent,tree,tree,parent] [--smooth] [--check]
                                       [--arms] [--keys K,...] [--degrees P,...] [--out FILE]

``DIR`` holds another commit's tree (for example ``git archive`` of the
parent commit unpacked into a directory that ``.gitignore`` lists); "tree"
is this checkout; ``--arm-tree`` names further trees for ``--order``.
Each arm runs in a process of its own that imports
``dealii_spirk_tpu_torch`` from its tree (so it builds and launches that
tree's kernels) and this checkout's ``chip_smoke.py``, and measures the
MEASURE_CASES of KEYS (K3, K4, K9c, K9a, K3dg, K9d, K1, K1's split route,
K5, K9b, K8, K5-2D, or those of ``--keys``, which also takes K2
(``stage_mix``), at every degree or those of ``--degrees``; a key that an
arm's package lacks is left out of that arm):
device time per launch from ``torch.profiler``, time per call from CUDA
events, L2-warm and L2-cold, over ``chip_smoke.TURNS`` turns, beside the
bound (K8 beside two K3dg launches); ``--check`` holds each kernel to its
plain version at the measured shape first (K8 to ``chip_smoke.PAIR_TOL``,
and to two K3dg launches, saying whether it equals them bit for bit) and
takes a digest of its outputs' bytes, and the arms' digests of BITWISE
(K3, K4, K9c, K9a, K3dg, K9d, K1, K1's split route, K5, K9b) must be
equal, as ``torch.equal`` would find them (but for NEW_SUMS);
``--smooth`` adds the 2D and 3D smooth-field rows (Q1, and at degrees 3
and 4); ``--arms`` the diagnostic arms (``chip_smoke.measure_arms``: K3,
K3dg, K4, K5, K1) of KEYS in each arm whose library has them.  The
arms' wrappers must take the same Python arguments.  Prints one line per
arm and case, a table, and writes every figure as JSON to ``--out``.  Needs a CUDA
device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TAG = "AB_RESULT "
KEYS = ("cheb_iter", "stencil_apply", "cheb_iter_halo", "stencil_apply_halo", "cheb_iter_dg",
        "cheb_iter_dg_halo", "ms_mix_apply", "ms_mix_apply_split", "mass_stiffness_apply",
        "mass_stiffness_apply_halo", "cheb_pair_dg", "mass_stiffness_apply_2d")
# keys that --keys takes besides KEYS (K2: beside K1's split march, its route)
EXTRA_KEYS = ("stage_mix",)
# kernels whose arithmetic every arm must keep bit for bit
BITWISE = ("cheb_iter", "stencil_apply", "cheb_iter_halo", "stencil_apply_halo", "cheb_iter_dg",
           "cheb_iter_dg_halo", "ms_mix_apply", "ms_mix_apply_split", "mass_stiffness_apply",
           "mass_stiffness_apply_halo")
# cases of BITWISE whose bytes may differ between arms, with the reason: K1
# at p = 4 and q >= 3 takes K2 + the split march (ops/cuda/stencil.py::
# mix_tile), which sums v = A^-1 u first, where an older tree's Mix form
# summed A^-1 M u
NEW_SUMS = {"ms_mix_apply 3D p=4": "K1 at p = 4 takes its route (mix_tile)"}


def digest(out) -> str:
    """sha256 of the bytes of a kernel's outputs, in order."""
    h = hashlib.sha256()
    for t in out if isinstance(out, tuple) else (out,):
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def run_arm(tree: str, smooth: bool, check: bool, keys=KEYS, arms: bool = False,
            degrees=(1, 2, 3, 4)) -> dict:
    """In this process: the measurement of KEYS on ``tree``'s package;
    ``check``: each kernel held to its plain version at the measured shape
    first (``chip_smoke.REL_TOL``) and its outputs' digest kept; ``arms``:
    the diagnostic arms of KEYS too (``chip_smoke.measure_arms``), where the
    tree's library has them."""
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
    from dealii_spirk_tpu_torch.ops.cuda import stencil as st

    build.build()
    device = torch.device("cuda", 0)
    # the KEYS this tree's package has (an older tree may lack a newer entry)
    cases = [c for c in cs.MEASURE_CASES
             if c[0] in keys and c[0] in st.LAUNCHES and c[-1] in degrees]
    digests = {}
    if check:
        for case in cases:
            c = cs._measure_setup(*case, device)
            inputs = c["make"]()
            got = c["kern"](*inputs)
            tol = cs.PAIR_TOL if case[0] == "cheb_pair_dg" else cs.REL_TOL
            cs._hold(f"{tree}: {case[0]} {c['at']}", got, c["plain"](*inputs), tol)
            if c.get("twin") is not None:
                twin = c["twin"](*inputs)
                cs._hold(f"{tree}:   against {c['twin_name']}", got, twin, tol)
                print(f"{tree}:   equal to {c['twin_name']} bit for bit: "
                      f"{all(torch.equal(g, t) for g, t in zip(got, twin))}", flush=True)
                del twin
            digests[f"{case[0]} {c['at']}"] = digest(got)
            del c, inputs, got
    out = {"tree": tree, "digests": digests, "measured": cs.measure_kernels(device, cases)}
    if arms:  # the arms of KEYS this tree's library has
        lib = build.load_library()
        out["arms"] = cs.measure_arms(device, [
            k for k, (_n, entry, *_rest) in cs.ARM_ENTRIES.items()
            if k in keys and hasattr(lib, entry)])
    if smooth:
        out["smooth"] = [row for cases in (cs.smooth_cases_2d(device), cs.smooth_cases_3d(device),
                                           cs.smooth_cases_degree(device))
                         for row in cs.smooth_rows(cases)]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="the other commit's tree")
    ap.add_argument("--arm-tree", action="append", default=[], metavar="NAME=DIR")
    ap.add_argument("--order", default="parent,tree,tree,parent")
    ap.add_argument("--smooth", action="store_true")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--arms", action="store_true",
                    help="the passes-only and copies-only arms of K3, K3dg, K4, K5, K1")
    ap.add_argument("--keys", default=",".join(KEYS), help="the KEYS to measure, comma-separated")
    ap.add_argument("--degrees", default="1,2,3,4",
                    help="the degrees of the MEASURE_CASES to measure, comma-separated")
    ap.add_argument("--out", default=None)
    ap.add_argument("--arm", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    keys = args.keys.split(",")
    if not set(keys) <= set(KEYS + EXTRA_KEYS):
        ap.error(f"--keys takes some of {', '.join(KEYS + EXTRA_KEYS)}")
    if args.arm is not None:
        degrees = tuple(int(p) for p in args.degrees.split(","))
        print(TAG + json.dumps(run_arm(args.arm, args.smooth, args.check, keys, args.arms,
                                       degrees)), flush=True)
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
        flags = ([f"--{f}" for f in ("smooth", "check", "arms") if getattr(args, f)]
                 + ["--keys", args.keys, "--degrees", args.degrees])
        proc = subprocess.run(cmd + flags, capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines() if not ln.startswith(TAG)]
        print("\n".join(f"[{arm}] {ln}" for ln in lines), flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], flush=True)
            raise SystemExit(f"arm {arm} failed ({proc.returncode})")
        res = json.loads(next(ln for ln in proc.stdout.splitlines() if ln.startswith(TAG))[len(TAG):])
        runs.append({"arm": arm, **res})
    print(f"{'arm':7s} {'case':58s} {'dev warm':>9s} {'dev cold':>9s} {'call warm':>9s} "
          f"{'call cold':>9s} {'bound':>7s} {'b/t cold dev':>12s} {'lib dev cold':>12s}")
    for run in runs:
        for r in run["measured"]:
            cd, lib = r["cold_device_ms"], r["library_cold_device_ms"]
            print(f"{run['arm']:7s} {r['key'] + ' ' + r['at']:58.58s} {r['device_ms'] or 0:9.4f} "
                  f"{cd or 0:9.4f} {r['ms']:9.4f} {r['cold_ms']:9.4f} {r['bound_ms']:7.4f} "
                  f"{(r['bound_ms'] / cd) if cd else 0:12.3f} "
                  + ("none" if lib is None else f"{lib:12.4f}"))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": smi, "runs": runs}, f, indent=1)
    if args.check:
        unequal = []
        for case in runs[0]["digests"]:
            seen = {run["arm"]: run["digests"].get(case) for run in runs}
            print(f"digest {case}: {seen}")
            why = next((w for k, w in NEW_SUMS.items() if case.startswith(k)), None)
            if why and len(set(seen.values())) > 1:
                print(f"  bytes differ, as they may: {why}")
            elif case.split()[0] in BITWISE and len(set(seen.values())) > 1:
                unequal.append(case)
        if unequal:
            raise SystemExit(f"outputs differ between the arms, bit for bit: {unequal}")
        print(f"every arm's {', '.join(BITWISE)} bit for bit the same")
    return 0


if __name__ == "__main__":
    sys.exit(main())
