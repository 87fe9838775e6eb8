#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the chip.

    python3 portbench/calibrate.py --workload <cell> --seeds 12 --first <seed> --control 3

Builds the cell's system once (``run.Cell``), runs one warm-up episode and
then, for each of ``--seeds`` seeds from ``--first``, one episode from
that seed's field through the window's own episode; each episode's fields
are compared with the float64 reference by ``run.reference_numbers``, as
a run compares them (the program's readings, the lower end of each
limit).  For the first ``--control`` seeds the reference in TF32 is put in
the program's place (the control's readings, the upper end).  One more
episode starts from the manufactured field alone (``field.amplitude`` 0),
so that its counts can be set beside the seeded ones.  Prints one JSON
line per reading and, last, the largest program reading and the smallest
control reading of each number.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import check, run  # noqa: E402


def readings(cell_name: str, seeds: list[int], control: int, device="cuda",
             overrides: dict | None = None) -> list[dict]:
    cell = run.Cell(cell_name, device, overrides=overrides)

    def episode(u0):
        fields = []
        c0 = cell.system.counters()
        t0 = time.perf_counter()
        cell.episode(u0, lambda k, u, dt, err: fields.append(u.cpu()))
        wall = time.perf_counter() - t0
        c1 = cell.system.counters()
        return fields, {"n_outer": c1["n_outer"] - c0["n_outer"],
                        "n_inner": c1["n_inner"] - c0["n_inner"], "episode_s": wall}

    episode(cell.start(seeds[0]))  # warm-up
    out = []
    _, counts = episode(cell.start(seeds[0], {**cell.traffic["field"], "amplitude": 0.0}))
    out.append({"cell": cell_name, "seed": None, "side": "unperturbed", **counts})
    for i, seed in enumerate(seeds):
        fields, counts = episode(cell.start(seed))
        nums = run.reference_numbers(cell, seed, fields)
        out.append({"cell": cell_name, "seed": seed, "side": "program", **nums, **counts})
        if i < control:
            nums = run.reference_numbers(cell, seed, None, precision="tf32")
            out.append({"cell": cell_name, "seed": seed, "side": "control", **nums})
    return out


def summary(rows: list[dict]) -> dict:
    out = {}
    for k in check.NUMBERS:
        prog = [r[k] for r in rows if r["side"] == "program"]
        ctl = [r[k] for r in rows if r["side"] == "control"]
        out[k] = {"lower": max(prog) if prog else None, "upper": min(ctl) if ctl else None}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first", type=int, required=True)
    ap.add_argument("--control", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    rows = readings(args.workload, [args.first + i for i in range(args.seeds)], args.control)
    for r in rows:
        print(json.dumps(r))
    print(json.dumps({"cell": args.workload, "device": torch.cuda.get_device_name(0),
                      "summary": summary(rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
