#!/usr/bin/env python3
"""The port's CLI row beside the JAX package's, for each ``json/`` config,
both on the CPU at f64.

    python3 scripts/torch_cli_parity.py [--refinement-offset K] [--configs a.json,...]
        [--json OUT]

Runs each config through ``python -m dealii_spirk_tpu_torch --device cpu``
and through the JAX package's ``python -m dealii_spirk_tpu`` (JAX on the
CPU with 8 virtual devices, as the tests run it), each in a process of its
own, and prints per config the table row's n_outer and n_inner (per step,
steps 2 on, as the table's ``*_avg``; the ``ost`` row has none, so its CG
count is read off the run), L2 and Linf of both, and whether the counts
are equal and the errors within 1e-10 relative; and the ParaView series
each CLI wrote in its own working directory (``DoOutputParaview``, on in
every config): the same number of ``.vtr`` files, the last one's payload
within 1e-10 relative of the JAX CLI's.  No config sets Precision, so both
run f64, the port on the plain torch operators.
``--refinement-offset K`` lowers every config's NRefinements by K where the
full width cannot run on the CPU (``spirk_sm.json`` takes about 20
auto-sized steps at refinement 8).  ``n_procs`` differs by design (the JAX
package writes its device count, the port its slot count) and is printed,
not compared.  This script imports neither package: each run is a child
process whose stdout carries one ``PARITY`` line.  The port's child runs
on one intra-op thread, as the tests do: with several, CPU solves of the
port beside other processes have hung in MKL's LASWP faults.
"""

from __future__ import annotations

import argparse
import base64
import glob
import json
import os
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-10

# the child: run one package's CLI on one config, recording run_config's result
_CHILD = r"""
import json, os, sys
pkg, path = sys.argv[1], sys.argv[2]
sys.path.insert(0, os.environ["PARITY_ROOT"])
if pkg == "jax":
    import jax
    jax.config.update("jax_platforms", "cpu")
    import dealii_spirk_tpu.__main__ as cli
    argv = ["--no-phase-timers", path]
else:
    import torch
    torch.set_num_threads(1)
    import dealii_spirk_tpu_torch.__main__ as cli
    argv = ["--device", "cpu", "--no-phase-timers", path]
run = cli.run_config


def recording(*args, **kwargs):
    out = run(*args, **kwargs)
    steps = max(out["n_timesteps"] - 1, 1)
    row = out["table"].rows[-1]
    print("PARITY " + json.dumps({
        "n_t": out["n_timesteps"], "n_outer": float(out["n_outer"]) / steps,
        "n_inner": float(out["n_inner"]) / steps, "error_L2": float(out["error_L2"]),
        "error_Linf": float(out["error_Linf"]), "n_procs": int(row["n_procs"]),
    }), flush=True)
    return out


cli.run_config = recording
sys.exit(cli.main(argv))
"""


def run_cli(pkg: str, path: str, workdir: str) -> tuple[dict, float]:
    """(the PARITY record, seconds) of one CLI run of ``pkg`` ("torch" or
    "jax") on the config file ``path``."""
    env = {**os.environ, "PARITY_ROOT": ROOT}
    if pkg == "jax":
        env |= {"JAX_PLATFORMS": "cpu",
                "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _CHILD, pkg, path],
                          capture_output=True, text=True, env=env, cwd=workdir)
    seconds = time.perf_counter() - t0
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("PARITY ")]
    if proc.returncode != 0 or len(lines) != 1:
        raise RuntimeError(f"{pkg} CLI on {path} failed (rc {proc.returncode}):\n"
                           f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return json.loads(lines[0].removeprefix("PARITY ")), seconds


def paraview(workdir: str) -> tuple[list[str], np.ndarray | None]:
    """(the .vtr files a CLI run wrote into ``workdir``, the last one's
    point data)."""
    files = sorted(f for f in os.listdir(workdir) if f.endswith(".vtr"))
    if not files:
        return files, None
    with open(os.path.join(workdir, files[-1])) as f:
        raw = base64.b64decode(f.read().split('format="binary">')[1].split("<")[0])
    (nbytes,) = struct.unpack("<I", raw[:4])
    return files, np.frombuffer(raw[4 : 4 + nbytes], dtype="<f8")


def compare(t: dict, j: dict, t_dir: str, j_dir: str) -> dict:
    """Whether the port's record and ParaView series match the JAX
    package's."""
    counts = (t["n_t"], t["n_outer"], t["n_inner"]) == (j["n_t"], j["n_outer"], j["n_inner"])
    rel = {k: abs(t[k] - j[k]) / abs(j[k]) for k in ("error_L2", "error_Linf")}
    (t_files, t_last), (j_files, j_last) = paraview(t_dir), paraview(j_dir)
    files = t_files == j_files
    if files and t_last is not None:
        rel["paraview"] = float(np.abs(t_last - j_last).max() / np.abs(j_last).max())
    return {"counts_equal": counts, "rel": rel, "vtr_files": [len(t_files), len(j_files)],
            "match": counts and files and all(v <= RTOL for v in rel.values())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--refinement-offset", type=int, default=0,
                    help="lower every config's NRefinements by this much")
    ap.add_argument("--configs", default=None,
                    help="comma-separated config files (default: json/*.json)")
    ap.add_argument("--json", default=None, help="also write the records here")
    args = ap.parse_args(argv)
    paths = (args.configs.split(",") if args.configs
             else sorted(glob.glob(os.path.join(ROOT, "json", "*.json"))))
    records = []
    with tempfile.TemporaryDirectory() as workdir:
        for path in paths:
            with open(path) as f:
                cfg = json.load(f)
            cfg["NRefinements"] = int(cfg.get("NRefinements", 5)) - args.refinement_offset
            cut = os.path.join(workdir, os.path.basename(path))
            with open(cut, "w") as f:
                json.dump(cfg, f)
            dirs = {}
            for pkg in ("torch", "jax"):
                dirs[pkg] = os.path.join(workdir, os.path.basename(path) + "." + pkg)
                os.mkdir(dirs[pkg])
            t, t_s = run_cli("torch", cut, dirs["torch"])
            j, j_s = run_cli("jax", cut, dirs["jax"])
            rec = {"config": os.path.relpath(path, ROOT), "NRefinements": cfg["NRefinements"],
                   "offset": args.refinement_offset, "torch": t, "jax": j,
                   "torch_s": round(t_s, 1), "jax_s": round(j_s, 1),
                   **compare(t, j, dirs["torch"], dirs["jax"])}
            records.append(rec)
            print(json.dumps(rec), flush=True)
    print(f"{'config':28s} {'r':>2s} | {'port n_outer n_inner L2 Linf':42s} | "
          f"{'JAX n_outer n_inner L2 Linf':42s} | match, n_procs port/JAX, .vtr files, "
          f"last .vtr rel. gap")
    for r in records:
        t, j = r["torch"], r["jax"]
        row = [f"{x['n_outer']:6.2f} {x['n_inner']:6.2f} {x['error_L2']:.6e} "
               f"{x['error_Linf']:.6e}" for x in (t, j)]
        print(f"{r['config']:28s} {r['NRefinements']:2d} | {row[0]:42s} | {row[1]:42s} | "
              f"{r['match']}, {t['n_procs']}/{j['n_procs']}, {r['vtr_files'][0]}/"
              f"{r['vtr_files'][1]}, {r['rel'].get('paraview', float('nan')):.1e}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(records, f, indent=1)
    return 0 if all(r["match"] for r in records) else 1


if __name__ == "__main__":
    sys.exit(main())
