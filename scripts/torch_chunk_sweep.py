#!/usr/bin/env python3
"""The chunk sweep of the z march's Apply mode (K4, K9a) on one CUDA
device: each case launched at every chunk its tree's march takes, on one
or more trees' packages in turns.

    python3 scripts/torch_chunk_sweep.py [--tree NAME=DIR ...] [--order tree,...]
                                         [--cases NAME,...] [--out FILE]

"tree" is this checkout; ``--tree`` names other trees (for example the
parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists).  Each arm runs in a process of its own that imports
``dealii_spirk_tpu_torch`` from its tree (so it builds and launches that
tree's kernels) and this checkout's ``chip_smoke.py``.  Per case of CASES
and per chunk, a power of two up to the tree's most planes per block
(``march_max_chunk("Apply", p)``, csrc March::ZC): the launch's output,
which must equal the wrapper's bit for bit (taps, weights and the order of
sums at a point do not depend on the chunk; the wrapper itself is held to
its plain version, ``chip_smoke.REL_TOL``), and its device time per launch
L2-cold (``chip_smoke.device_ms`` over input sets of twice the L2), the
least of ``chip_smoke.TURNS`` turns.  The wrapper's own chunk is marked,
and its launch's grid, registers and shared memory (``chip_smoke.launch_attrs``)
printed.
Prints the card, one line per arm, case and chunk, a table, and writes
every figure as JSON to ``--out``.  Needs a CUDA device; imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TAG = "SWEEP_RESULT "
# name: (q, refinement, degree, on the first of two z slabs)
CASES = {
    "K4 P20 r5": (6, 5, 4, False),  # P20's 127 level, six lanes
    "K4 P17 r6": (4, 6, 4, False),  # P17's 255 level
    "K4 P19 r6": (5, 6, 4, False),  # P19's 255 level
    "K4 P16 r6": (4, 6, 3, False),  # P16's 191 level (Q3)
    "K9a P18 slab": (1, 5, 4, True),  # P18's first slab: 64 of 127 planes
}


def run_arm(tree: str, names: list[str]) -> dict:
    """In this process: every chunk of each case on ``tree``'s package."""
    sys.path.insert(0, os.path.abspath(tree))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    import dealii_spirk_tpu_torch
    from dealii_spirk_tpu_torch.fem.grid import make_level
    from dealii_spirk_tpu_torch.ops.cuda import build
    from dealii_spirk_tpu_torch.ops.cuda import stencil as st
    from dealii_spirk_tpu_torch.ops.mass_laplace import level_ops, slab_ops
    from dealii_spirk_tpu_torch.parallel.sharding import z_partition

    pkg = os.path.dirname(os.path.abspath(dealii_spirk_tpu_torch.__file__))
    if not pkg.startswith(os.path.abspath(tree)):
        raise SystemExit(f"imported the package from {pkg}, not from {tree}")
    build.build()
    device = torch.device("cuda", 0)
    rows = []
    for name in names:
        q, ref, p, halo = CASES[name]
        ops = level_ops(make_level(ref, p), torch.float32, device)
        m = ops.m
        nz = z_partition(m, 2)[0][1] if halo else m
        sops = slab_ops(ops, 0, nz) if halo else ops
        h = p if halo else 0
        gen = cs.device_generator(device, 7 * ref + q + 100 * p)
        a = torch.linspace(0.5, 2.0, q, device=device)
        coefs = st._stage_coefs(a, q, device)

        def operand():
            u = cs.uniform_field((q, nz + 2 * h, m, m), -1.0, 1.0, device, gen)
            u[:, :h] = 0.0  # a first slab: zeros below the domain
            return u

        def launch(u, chunk):
            out = torch.empty((q, nz, m, m), dtype=torch.float32, device=device)
            entry = "spirk_stencil_apply_halo" if halo else "spirk_stencil_apply"
            slab = (nz, 0) if halo else ()
            st._launch_raw(entry, device, u.data_ptr(), out.data_ptr(),
                           sops.mass_band.data_ptr(), sops.stiff_band.data_ptr(),
                           coefs.data_ptr(), 0.1, q, m, *slab, chunk, p)
            return out

        kern = st.stencil_apply_halo if halo else st.stencil_apply
        plain = st.stencil_apply_halo_ref if halo else st.stencil_apply_ref
        n_bytes = 4 * q * (2 * nz + 2 * h) * m * m
        sets = [(operand(),) for _ in range(max(2, -(-2 * cs.L2_CACHE_BYTES // n_bytes)))]
        want = kern(sops, a, 0.1, sets[0][0])
        cs._hold(f"{tree}: {name}", want, plain(sops, a, 0.1, sets[0][0]), cs.REL_TOL)
        cap = st.march_max_chunk("Apply", p)
        chunks = [2**k for k in range(cap.bit_length()) if 2**k <= cap]
        for chunk in chunks:
            if not torch.equal(launch(sets[0][0], chunk), want):
                raise AssertionError(f"{tree}: {name} at chunk {chunk} differs from the wrapper")
        bnd = cs.bound("stencil_apply", q, q, nz * m * m, p, 3, halo_points=2 * h * m * m)[0]
        best = {}
        for _turn in range(cs.TURNS):
            for chunk in chunks:
                call = cs._rotating(lambda u, chunk=chunk: launch(u, chunk), sets)
                dev = cs.device_ms(call, cs.DEVICE_NAMES["stencil_apply"])[0]
                if dev is not None and (best.get(chunk) is None or dev < best[chunk]):
                    best[chunk] = dev
                best.setdefault(chunk, None)
        (wrapper,) = st._runs_plan(sops, q, nz, "Apply")
        attrs = cs.launch_attrs(lambda: kern(sops, a, 0.1, sets[0][0]), "::Apply")
        row = {"case": name, "at": f"3D p={p} m={m} q={q}" + (f" slab of {nz}" if halo else ""),
               "bound_ms": bnd, "wrapper_chunk": wrapper, "launch": attrs,
               "cold_device_ms": {str(c): v for c, v in best.items()}}
        print(f"{tree}: {name} the wrapper's launch (profiler trace): {attrs}", flush=True)
        print(f"{tree}: {name} ({row['at']}, bound {bnd:.4f} ms) device ms per launch "
              f"L2-cold, least of {cs.TURNS} turns: " + ", ".join(
                  f"{c}{'*' if c == wrapper else ''} "
                  + ("not seen" if v is None else f"{v:.4f}") for c, v in best.items()),
              flush=True)
        rows.append(row)
        del sets, want
        torch.cuda.empty_cache()
    return {"tree": tree, "rows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", default=[], metavar="NAME=DIR")
    ap.add_argument("--order", default="tree")
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--out", default=None)
    ap.add_argument("--arm", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    names = args.cases.split(",")
    if not set(names) <= set(CASES):
        ap.error(f"--cases takes some of {', '.join(CASES)}")
    if args.arm is not None:
        print(TAG + json.dumps(run_arm(args.arm, names)), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    trees = {"tree": ROOT} | dict(t.split("=", 1) for t in args.tree)
    runs = []
    for arm in args.order.split(","):
        cmd = [sys.executable, os.path.abspath(__file__), "--arm", trees[arm],
               "--cases", args.cases]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines() if not ln.startswith(TAG)]
        print("\n".join(f"[{arm}] {ln}" for ln in lines), flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], flush=True)
            raise SystemExit(f"arm {arm} failed ({proc.returncode})")
        res = json.loads(next(ln for ln in proc.stdout.splitlines()
                              if ln.startswith(TAG))[len(TAG):])
        runs.append({"arm": arm, **res})
    chunks = sorted({int(c) for run in runs for r in run["rows"] for c in r["cold_device_ms"]})
    print(f"{'arm':8s} {'case':14s} {'bound':>7s} " + " ".join(f"{c:>8d}" for c in chunks))
    for run in runs:
        for r in run["rows"]:
            cells = []
            for c in chunks:
                v = r["cold_device_ms"].get(str(c))
                mark = "*" if c == r["wrapper_chunk"] else " "
                cells.append(f"{'':>8s}" if str(c) not in r["cold_device_ms"]
                             else f"{'—' if v is None else f'{v:.4f}':>7s}{mark}")
            print(f"{run['arm']:8s} {r['case']:14s} {r['bound_ms']:7.4f} " + " ".join(cells))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": smi, "runs": runs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
