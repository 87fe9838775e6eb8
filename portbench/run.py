#!/usr/bin/env python3
"""Benchmark of ``dealii_spirk_tpu_torch`` on one NVIDIA GPU: one run of
one cell of ``BENCHMARK.json``.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up builds the port's problem and scheme for the cell's configuration
(``configs/<config>.json``), makes the initial field of the cell's traffic
(``traffic/<traffic>.json``) from the seed and runs one whole episode as
warm-up.  The window then runs episodes back to back for ``--seconds``
and ends at a step boundary.  With ``--trace 1`` one more episode follows
with the port's phase timers on inside its steps, and one more under
``torch.profiler``; the window itself runs as with ``--trace 0``.  After
that, the fields of one window episode drawn from the seed are compared
with the plain reference (``reference/<config's reference>.py``, float64,
on the same device), once the port's state is freed.  Each metric of the
cell is read from the run's record by its reader,
``metrics/<metric>.py``: with ``--trace 0`` the end-to-end metrics, with
``--trace 1`` the per-layer ones.  The last line of standard output is the
result as one JSON object.  Exits 2 without a result where there is no
CUDA device or fewer than the cell asks for, and 1 where JAX or the JAX
package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "dealii_spirk_tpu")

# every build and kernel cache at a fixed place inside the checkout (the
# port's own kernels build into build/dealii_spirk_tpu_torch there)
for _var, _dir in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = str(ROOT / "build" / "portbench" / _dir)

if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import check, workload  # noqa: E402


def load_bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"BENCHMARK.json has no workload {name!r}")


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics this cell reports in a run of this kind."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def read_metric(name: str, record: dict):
    """The reader ``metrics/<name>.py``'s value for the run, or None."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"metric {name!r} has no reader ({path})")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(record)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


class Cell:
    """A cell's parameters, traffic and limits, and its system under test.
    ``overrides`` replace parameters (the tests' small grids); ``bench``:
    default BENCHMARK.json."""

    def __init__(self, name: str, device, *, overrides: dict | None = None,
                 bench: dict | None = None):
        from portbench.system import System

        self.bench = load_bench() if bench is None else bench
        self.cell = find_cell(self.bench, name)
        self.name = name
        self.config = workload.load("configs", self.cell["config"])
        self.traffic = workload.load("traffic", self.cell["traffic"])
        self.params = {**self.config["parameters"], **(overrides or {})}
        self.limits = check.load_limits(name)
        self.device = torch.device(device)
        self.steps = workload.episode_steps(self.params)
        self.tau = float(self.params["TimeStepSize"])
        self.system = System(self.params, self.device)
        self.dtype = self.system.dtype

    def start(self, seed: int, field: dict | None = None) -> torch.Tensor:
        """The seed's initial field in the port's type."""
        u0 = workload.initial_field(self.params, field or self.traffic["field"], seed, self.device)
        return u0.to(self.system.dtype)

    def episode(self, u0: torch.Tensor, on_step=None) -> None:
        """One episode from ``u0``; after each step calls
        ``on_step(k, u, seconds, error)`` (k from 1), which may return True
        to end the episode there."""
        u = u0
        for k in range(1, self.steps + 1):
            ts = time.perf_counter()
            u, err = self.system.step(u, k * self.tau, self.tau)
            if on_step is not None and on_step(k, u, time.perf_counter() - ts, err):
                return


def reference_numbers(cell: Cell, seed: int, fields, precision: str = "f64") -> dict:
    """The compared numbers of an episode's ``fields`` from the seed's
    start, against the reference from that start exactly (the port's type
    widened to float64); ``precision="tf32"`` puts the control in the
    program's place and ignores ``fields``."""
    device = cell.device
    ref = importlib.import_module(f"portbench.reference.{cell.config['reference']}")
    u0 = workload.initial_field(cell.params, cell.traffic["field"], seed, device)
    u0 = u0.to(cell.dtype).double()
    if precision != "f64":
        fields = [u.cpu() for u in ref.run(cell.params, u0, cell.steps, device, precision)]
    return check.compare(fields, ref.run(cell.params, u0, cell.steps, device),
                         ref.stiffness(cell.params, device), device)


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, *, device="cuda",
             overrides: dict | None = None, fault=None, bench: dict | None = None) -> dict:
    """One run of a cell; returns the result.  ``fault``: a function
    called with the system before the window (the tests plant faults with
    it); ``overrides``, ``bench``: see ``Cell``."""
    t_cell = time.perf_counter()
    cell = Cell(cell_name, device, overrides=overrides, bench=bench)
    cuda = cell.device.type == "cuda"
    system, steps = cell.system, cell.steps
    t_field = time.perf_counter()
    u0 = cell.start(seed)

    t0 = time.perf_counter()
    cell.episode(u0)  # warm-up: tau's preconditioner state, the first launches
    warm_s = time.perf_counter() - t0
    # where set-up went: imports and the CUDA context, the port's problem
    # and scheme, the field, the warm-up episode (no metric reads them)
    setup_parts = {"imports_s": t_cell - T_START, "system_s": t_field - t_cell,
                   "field_s": t0 - t_field, "warmup_s": warm_s}
    if fault is not None:
        fault(system)

    # the window episode whose fields are compared, drawn from the seed
    # among those that surely finish in the window
    sure = max(1, int(seconds / (2.0 * warm_s)))
    sample = int(np.random.default_rng([seed, 1]).integers(sure))
    kept = [torch.empty(u0.shape, dtype=u0.dtype, pin_memory=cuda) for _ in range(steps)]
    step_s, errs = [], []
    state = {"episode": 0, "closed": False}

    def on_step(k, u, dt, err):
        if not state["closed"]:
            step_s.append(dt)
            errs.append(err)
            if time.perf_counter() - t_w >= seconds:
                # the window closes: what it counted, before any step that
                # finishes the compared episode
                state["closed"] = True
                state["end"] = time.perf_counter()
                state["counters"] = system.counters()
        if state["episode"] == sample:
            kept[k - 1].copy_(u)
        return state["closed"] and state["episode"] > sample

    c0 = system.counters()
    setup_s = time.perf_counter() - T_START
    t_w = time.perf_counter()
    while not state["closed"] or state["episode"] <= sample:
        cell.episode(u0, on_step)
        state["episode"] += 1
    window_s = state["end"] - t_w
    c1 = state["counters"]
    peak = torch.cuda.max_memory_allocated(cell.device) if cuda else None

    record = {
        "steps": len(step_s),
        "window_s": window_s,
        "step_s": step_s,
        "setup_s": setup_s,
        "peak_bytes": peak,
        "counters": {
            "n_outer": c1["n_outer"] - c0["n_outer"],
            "n_inner": c1["n_inner"] - c0["n_inner"],
            "launches": {k: c1["launches"][k] - c0["launches"][k] for k in c1["launches"]},
        },
        "spans": None,
        "trace": None,
    }
    if trace:
        if not cuda:
            raise RuntimeError("--trace 1 reads the device's trace: it needs a CUDA device")
        from portbench import devtrace

        # one episode with the phase timers inside the steps, then one
        # under the profiler, each with its own step count
        with system.spans() as spans:
            cell.episode(u0)
        torch.cuda.synchronize()
        record["spans"] = {"steps": steps, **spans}
        with system.launch_shapes() as shapes:
            prof = devtrace.profile(lambda: cell.episode(u0))
        record["trace"] = {**prof, "steps": steps, "launches": shapes}
        peak = torch.cuda.max_memory_allocated(cell.device)

    failed = sum(1 for e in errs if not math.isfinite(e))

    # the port's state goes before the reference runs on the device
    cell.system = None
    del system, u0
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = reference_numbers(cell, seed, kept)
    ok, shown = check.judge(numbers, cell.limits)
    correct = ok and failed == 0 and len(step_s) > 0

    metrics = {}
    for m in cell_metrics(cell.bench, cell_name, trace):
        value = read_metric(m["name"], record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    result = {
        "correct": correct,
        "attempted": len(step_s),
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(cell.device) if cuda else "cpu",
            "count": int(cell.cell.get("chips", 1)),
            "memory_peak_bytes": peak,
        },
    }
    if trace:
        prof = record["trace"]
        result["device"]["busy_s"] = prof["busy_s"]
        result["device"]["window_s"] = prof["wall_s"]
        result["breakdown"] = {
            "device_ops": devtrace.top({k: v[1] for k, v in prof["kernels"].items()}),
            "idle_gaps": devtrace.top(prof["idle_by_host"]),
        }
    result["setup_parts"] = setup_parts
    result["checks"] = shown
    return result


def power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    chips = int(find_cell(load_bench(), args.workload).get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    result["device"]["power"] = power_limit()
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)} (the benchmark runs the port alone)",
              file=sys.stderr)
        return 1
    # the compared numbers beside their limits, last in the result's line
    result["checks"] = result.pop("checks")
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']:.6e} limit {c['limit']:.6e}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
