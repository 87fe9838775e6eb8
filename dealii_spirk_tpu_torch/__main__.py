"""CLI: ``python -m dealii_spirk_tpu_torch [--dim {2,3}] [--device DEV]
[--slots N] [--no-phase-timers] [--profile DIR] cfg1.json [cfg2.json ...]``

Port of ``dealii_spirk_tpu/__main__.py`` (the reference's ``irk-2D`` /
``irk-3D`` executables, ``main.cc:3608-3791``): each JSON config runs in
sequence, accumulating one convergence table that is printed after every
config.
"""

from __future__ import annotations

import argparse
import contextlib
import sys

from .config import Parameters
from .problem import require_device
from .runner import run_config
from .utils.table import ConvergenceTable


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="dealii_spirk_tpu_torch")
    parser.add_argument("--dim", type=int, default=3, choices=(2, 3))
    parser.add_argument(
        "--device", default="cuda", help="torch device to run on: cuda (default) or cpu"
    )
    parser.add_argument(
        "--slots", type=int, default=None,
        help="slots of the (stage, space) mesh of a stage-parallel scheme, all on the "
        "device (default: the stage axis size, a (stage, 1) mesh)",
    )
    parser.add_argument(
        "--phase-timers", action=argparse.BooleanOptionalAction, default=True,
        help="time the phases inside each step in place: the system vmult and the "
        "preconditioner's basis changes and block solves, for the t_vmult / t_prec_* "
        "columns (the reference's in-loop phase timers, main.cc:998-1173), and GMRES's "
        "vector and host work, the V-cycle's smoothing and transfers and the error, "
        "which no column shows; on by default",
    )
    parser.add_argument(
        "--profile", metavar="DIR", default=None,
        help="record a torch.profiler trace of the run (host and device) into "
        "DIR/trace.json; every phase of the step is a spirk.<phase> range on it "
        "(spirk.total, spirk.rhs, spirk.outer_solver, spirk.system_vmult, "
        "spirk.krylov_host, spirk.mg_smooth, ..., spirk.errors)",
    )
    parser.add_argument("configs", nargs="+", help="JSON parameter files")
    return parser


@contextlib.contextmanager
def profiled(out_dir: str | None, device: str):
    """``torch.profiler`` over the block, its Chrome trace written to
    ``out_dir/trace.json``; nothing when ``out_dir`` is None.  The phase
    timers open a ``spirk.<phase>`` range around every phase while it
    records (``utils/timer.py``)."""
    if out_dir is None:
        yield
        return
    from pathlib import Path

    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    path = Path(out_dir)
    path.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path / "trace.json"))


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    try:
        require_device(args.device)
    except RuntimeError as err:
        parser.error(str(err))

    table = ConvergenceTable()
    with profiled(args.profile, args.device):
        for path in args.configs:
            params = Parameters.from_json(path, dim=args.dim)
            run_config(params, table, device=args.device, slots=args.slots,
                       phase_timers=args.phase_timers)
            print()
            print(table.to_string())
    return 0


if __name__ == "__main__":
    sys.exit(main())
