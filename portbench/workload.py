"""The general generator of the benchmark's traffic: closed-loop episodes.

A traffic mix (``traffic/<name>.json``) sets the seeded part of the
initial field the solver is sent, ``field``:

    u0 = prod_k sin(2 pi x_k) + a sum_j c_j prod_k sin(pi n_jk x_k)

upstream's manufactured initial field (main.cc:3495-3602, the field every
upstream run starts from) plus the low sine modes ``field.modes`` (one wave
number per axis each) with coefficients c_j drawn uniformly from [-1, 1]
by the seed and scaled by ``field.amplitude``.  The amplitude is chosen so
small that the solver's counts, and so its work, are those of the
manufactured field alone (``tests/test_portbench_runs.py``): every seed
sends the deployment's own problem, with another field.

An episode is one simulation from t = 0 to the configuration's ``EndTime``
in steps of its ``TimeStepSize``; episodes run back to back, each step
after the previous one has returned.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import torch

from .reference.fem1d import support_points

HERE = Path(__file__).resolve().parent


def load(kind: str, name: str) -> dict:
    """``<kind>/<name>.json`` under the benchmark's folder."""
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def episode_steps(params: dict) -> int:
    steps = round(float(params["EndTime"]) / float(params["TimeStepSize"]))
    if steps < 1:
        raise ValueError("an episode needs EndTime >= TimeStepSize")
    return steps


def interior_nodes(p: int, refinement: int) -> np.ndarray:
    cells = 2**refinement
    nodes = support_points(p)
    full = np.concatenate([((np.arange(cells)[:, None] + nodes[None, :-1]) / cells).ravel(), [1.0]])
    return full[1:-1]


def coefficients(field: dict, seed: int) -> np.ndarray:
    """The seed's coefficient of each mode, amplitude included."""
    rng = np.random.default_rng(seed)
    return float(field["amplitude"]) * rng.uniform(-1.0, 1.0, size=len(field["modes"]))


def initial_field(params: dict, field: dict, seed: int, device) -> torch.Tensor:
    """The seeded initial field (float64) on ``device``."""
    dim = int(params.get("Dim", 3))
    x = torch.as_tensor(interior_nodes(int(params["FEDegree"]), int(params["NRefinements"])),
                        dtype=torch.float64, device=device)

    def product(waves, scale):
        out = torch.sin(waves[0] * math.pi * x) * scale
        for w in waves[1:]:
            out = torch.tensordot(out, torch.sin(w * math.pi * x), dims=0)
        return out

    u = product([2.0] * dim, 1.0)
    for waves, c in zip(field["modes"], coefficients(field, seed)):
        if len(waves) != dim:
            raise ValueError(f"mode {waves} has not {dim} wave numbers")
        u += product([float(w) for w in waves], float(c))
    return u
