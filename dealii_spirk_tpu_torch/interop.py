"""Build the port's state from numpy arrays.

The tests hand the JAX package's operators, preconditioner and tables
over as ``np.asarray(...)`` of its objects, so both packages compute with
identical inputs.  Nothing here knows of JAX: every argument is a numpy
array (or a sequence of them).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from .ops.mass_laplace import LevelOps
from .solvers.gmg import GMGData, GMGPrec
from .tables import IRKTables


def _t(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a), dtype=dtype, device=device).contiguous()


def level_ops_from_numpy(
    mass_band, stiff_band, mass_diag, stiff_diag, *, dtype=torch.float64, device="cpu"
) -> LevelOps:
    return LevelOps(
        mass_band=_t(mass_band, dtype, device),
        stiff_band=_t(stiff_band, dtype, device),
        mass_diag=_t(mass_diag, dtype, device),
        stiff_diag=_t(stiff_diag, dtype, device),
    )


def gmg_data_from_numpy(
    level_ops: Sequence[Sequence[np.ndarray]],
    prolongs: Sequence[np.ndarray],
    coarse_mass,
    coarse_stiff,
    *,
    dtype=torch.float64,
    device="cpu",
) -> GMGData:
    """``level_ops``: per level (coarse -> fine) the arrays
    ``(mass_band, stiff_band, mass_diag, stiff_diag)``."""
    return GMGData(
        level_ops=tuple(
            level_ops_from_numpy(*lv, dtype=dtype, device=device) for lv in level_ops
        ),
        prolongs=tuple(_t(P, dtype, device) for P in prolongs),
        coarse_mass=_t(coarse_mass, dtype, device),
        coarse_stiff=_t(coarse_stiff, dtype, device),
    )


def gmg_prec_from_numpy(
    inv_diags, thetas, deltas, coarse_inv, *, dtype=torch.float64, device="cpu"
) -> GMGPrec:
    return GMGPrec(
        inv_diags=tuple(_t(a, dtype, device) for a in inv_diags),
        thetas=tuple(_t(a, dtype, device) for a in thetas),
        deltas=tuple(_t(a, dtype, device) for a in deltas),
        coarse_inv=_t(coarse_inv, dtype, device),
    )


def irk_tables_from_numpy(n_stages: int, **arrays) -> IRKTables:
    """``arrays``: every array field of ``IRKTables`` by name."""
    names = {f.name for f in dataclasses.fields(IRKTables)} - {"n_stages"}
    if set(arrays) != names:
        raise ValueError(f"expected the fields {sorted(names)}")
    return IRKTables(
        n_stages=n_stages,
        **{k: np.asarray(v, dtype=np.float64) for k, v in arrays.items()},
    )
