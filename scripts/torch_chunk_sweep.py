#!/usr/bin/env python3
"""The chunk sweep of the z march's Apply (K4, K9a), MassStiff (K5, K9b)
and Mix (K1) modes on one CUDA device: each case launched at every chunk
its tree's march takes, on one or more trees' packages in turns.

    python3 scripts/torch_chunk_sweep.py [--tree NAME=DIR ...] [--order tree,...]
                                         [--cases NAME,...] [--out FILE]

"tree" is this checkout; ``--tree`` names other trees (for example the
parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists).  Each arm runs in a process of its own that imports
``dealii_spirk_tpu_torch`` from its tree (so it builds and launches that
tree's kernels) and this checkout's ``chip_smoke.py``.  Per case of CASES
and per chunk, a power of two up to the tree's most planes per block
(``march_max_chunk(mode, p)``, csrc March::ZC): the wrapper's launch with
its chunk replaced, whose outputs must equal the wrapper's bit for bit
(taps, weights and the order of sums at a point do not depend on the
chunk; the wrapper itself is held to its plain version,
``chip_smoke.REL_TOL``), and its device time per launch
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
# name: (wrapper, q, refinement, degree, on the first of two z slabs)
CASES = {
    "K4 P20 r5": ("stencil_apply", 6, 5, 4, False),  # P20's 127 level, six lanes
    "K4 P17 r6": ("stencil_apply", 4, 6, 4, False),  # P17's 255 level
    "K4 P19 r6": ("stencil_apply", 5, 6, 4, False),  # P19's 255 level
    "K4 P16 r6": ("stencil_apply", 4, 6, 3, False),  # P16's 191 level (Q3)
    "K9a P18 slab": ("stencil_apply", 1, 5, 4, True),  # P18's first slab: 64 of 127 planes
    "K5 P20 r5": ("mass_stiffness_apply", 6, 5, 4, False),  # P20's vmult
    "K5 P16 r6": ("mass_stiffness_apply", 4, 6, 3, False),  # P16's shape (Q3)
    "K9b P18 slab": ("mass_stiffness_apply", 1, 5, 4, True),
    "K1 P16 r6": ("ms_mix_apply", 4, 6, 3, False),  # P16's finest level (Q3)
}
# per wrapper: its march mode and the profiler's name of its kernel
MODES = {"stencil_apply": ("Apply", "::Apply"), "mass_stiffness_apply": ("MassStiff", "MassStiff"),
         "ms_mix_apply": ("Mix", "Mix<")}


def outputs(out) -> tuple:
    """A wrapper's outputs as a tuple (K5: M u, K u)."""
    return out if isinstance(out, tuple) else (out,)


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
        key, q, ref, p, halo = CASES[name]
        mode, marker = MODES[key]
        ops = level_ops(make_level(ref, p), torch.float32, device)
        m = ops.m
        nz = z_partition(m, 2)[0][1] if halo else m
        sops = slab_ops(ops, 0, nz) if halo else ops
        h = p if halo else 0
        gen = cs.device_generator(device, 7 * ref + q + 100 * p)
        a = torch.linspace(0.5, 2.0, q, device=device)
        ainv = torch.linspace(-1.0, 1.0, q * q, device=device).reshape(q, q)
        fn = getattr(st, key + ("_halo" if halo else ""))
        ref_fn = getattr(st, key + ("_halo" if halo else "") + "_ref")
        args = {"stencil_apply": (a, 0.1), "mass_stiffness_apply": (),
                "ms_mix_apply": (ainv, 0.1)}[key]

        def operand():
            u = cs.uniform_field((q, nz + 2 * h, m, m), -1.0, 1.0, device, gen)
            u[:, :h] = 0.0  # a first slab: zeros below the domain
            return u

        def launch(u, chunk=None, seen=None):
            """The wrapper on u, its launch at ``chunk`` planes per block
            (None: its own, put into ``seen``)."""
            real = st._launch_raw

            def at_chunk(entry, dev, *largs):  # ..., chunk, p
                if seen is not None:
                    seen.append(largs[-2])
                real(entry, dev, *largs[:-2], largs[-2] if chunk is None else chunk, largs[-1])

            st._launch_raw = at_chunk
            try:
                return fn(sops, *args, u)
            finally:
                st._launch_raw = real

        n_bytes = 4 * q * (cs.PASSES[key] * nz + 2 * h) * m * m
        sets = [(operand(),) for _ in range(max(2, -(-2 * cs.L2_CACHE_BYTES // n_bytes)))]
        seen = []
        want = launch(sets[0][0], seen=seen)
        (wrapper,) = seen
        cs._hold(f"{tree}: {name}", want, ref_fn(sops, *args, sets[0][0]), cs.REL_TOL)
        cap = st.march_max_chunk(mode, p)
        chunks = [2**k for k in range(cap.bit_length()) if 2**k <= cap]
        for chunk in chunks:
            got = launch(sets[0][0], chunk)
            if not all(torch.equal(g, w) for g, w in zip(outputs(got), outputs(want))):
                raise AssertionError(f"{tree}: {name} at chunk {chunk} differs from the wrapper")
        bnd = cs.bound(key, q, q, nz * m * m, p, 3, halo_points=2 * h * m * m)[0]
        best = {}
        for _turn in range(cs.TURNS):
            for chunk in chunks:
                call = cs._rotating(lambda u, chunk=chunk: launch(u, chunk), sets)
                dev = cs.device_ms(call, (marker,))[0]
                if dev is not None and (best.get(chunk) is None or dev < best[chunk]):
                    best[chunk] = dev
                best.setdefault(chunk, None)
        attrs = cs.launch_attrs(lambda: launch(sets[0][0]), marker)
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
