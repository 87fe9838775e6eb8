"""The comparison that decides ``correct``.

The fields that one window episode produced, step by step, against the
plain reference's fields of the same steps from the same initial field:

* ``rel_l2``: the largest over the steps of ||u - u_ref||_2 / ||u_ref||_2;
* ``rel_linf``: the largest over the steps of max|u - u_ref| / max|u_ref|;
* ``rel_k``: the largest over the steps of ||K (u - u_ref)||_2 / ||K u_ref||_2,
  K the stiffness matrix: the gap in a norm that weighs each mode by its
  eigenvalue, so that rounding noise, which sits in every mode, reads far
  above a smooth gap such as the one a Krylov tolerance leaves.

Each has a limit of its own per cell, in ``limits/<cell>.json`` with the
readings it was set from.
"""

from __future__ import annotations

import json
import math
from collections.abc import Iterable
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
NUMBERS = ("rel_l2", "rel_linf", "rel_k")


def load_limits(cell: str) -> dict[str, float]:
    """The cell's limit of each number it compares."""
    path = HERE / "limits" / f"{cell}.json"
    if not path.is_file():
        raise FileNotFoundError(f"cell {cell!r} has no limits file ({path})")
    raw = json.loads(path.read_text())
    limits = {k: float(v["limit"]) for k, v in raw.items()}
    if not limits or set(limits) - set(NUMBERS):
        raise ValueError(f"limits of {cell!r}: each of {NUMBERS}, at least one")
    return limits


def compare(fields: Iterable[torch.Tensor], reference: Iterable[torch.Tensor], stiffness,
            device) -> dict:
    """The compared numbers of ``fields`` (each step's, any device and
    dtype) against ``reference`` (the same steps, float64); ``stiffness``
    applies K to a float64 field."""
    out = {k: 0.0 for k in NUMBERS}
    n = 0
    for u, ref in zip(fields, reference, strict=True):
        ref = ref.to(device, torch.float64)
        d = u.to(device, torch.float64) - ref
        for key, value in (("rel_l2", float(d.norm() / ref.norm())),
                           ("rel_linf", float(d.abs().max() / ref.abs().max())),
                           ("rel_k", float(stiffness(d).norm() / stiffness(ref).norm()))):
            # a field that is not finite reads infinitely far off
            out[key] = max(out[key], value if math.isfinite(value) else math.inf)
        n += 1
        del d, ref
    if n == 0:
        raise ValueError("no field to compare")
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(whether every number is finite and within its limit, the numbers
    beside their limits)."""
    shown = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(math.isfinite(numbers[k]) and numbers[k] <= limits[k] for k in limits)
    return ok, shown
