"""CLI: ``python -m dealii_spirk_tpu_torch [--dim {2,3}] [--device DEV]
cfg1.json [cfg2.json ...]``

Port of ``dealii_spirk_tpu/__main__.py`` (the reference's ``irk-2D`` /
``irk-3D`` executables, ``main.cc:3608-3791``): each JSON config runs in
sequence, accumulating one convergence table that is printed after every
config.
"""

from __future__ import annotations

import argparse
import sys

from .config import Parameters
from .runner import run_config
from .utils.table import ConvergenceTable


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="dealii_spirk_tpu_torch")
    parser.add_argument("--dim", type=int, default=3, choices=(2, 3))
    parser.add_argument(
        "--device", default="cpu", help="torch device to run on, e.g. cpu or cuda"
    )
    parser.add_argument("configs", nargs="+", help="JSON parameter files")
    args = parser.parse_args(argv)

    table = ConvergenceTable()
    for path in args.configs:
        params = Parameters.from_json(path, dim=args.dim)
        run_config(params, table, device=args.device)
        print()
        print(table.to_string())
    return 0


if __name__ == "__main__":
    sys.exit(main())
