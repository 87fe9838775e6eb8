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
from .parallel.mesh import SlotMesh
from .parallel.sharding import ShardedBlock, scatter, scatter_pairs
from .solvers.gmg import GMGData, GMGPrec, MeshPrec, scatter_prec
from .tables import IRKTables


def _t(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a), dtype=dtype, device=device).contiguous()


def level_ops_from_numpy(
    mass_band, stiff_band, mass_diag, stiff_diag, mass_dense=None, stiff_dense=None, *,
    dtype=torch.float64, device="cpu"
) -> LevelOps:
    """A level's operators; with ``mass_dense`` and ``stiff_dense`` (not
    None) its dense MatrixBased route too."""
    def opt(a):
        return None if a is None else _t(a, dtype, device)

    return LevelOps(
        mass_band=_t(mass_band, dtype, device),
        stiff_band=_t(stiff_band, dtype, device),
        mass_diag=_t(mass_diag, dtype, device),
        stiff_diag=_t(stiff_diag, dtype, device),
        mass_dense=opt(mass_dense),
        stiff_dense=opt(stiff_dense),
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
    ``(mass_band, stiff_band, mass_diag, stiff_diag)``, and optionally
    ``mass_dense, stiff_dense`` (None where the level has no dense route).
    The hierarchy may be geometric or algebraic (the JAX package's
    ``build_amg_data``): the coarse matrices are taken as given."""
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


def sharded_block_from_numpy(
    W, mesh: SlotMesh, *, dtype=torch.float64, device="cpu"
) -> ShardedBlock:
    """A whole stage block (q, *spatial) split over the mesh (not counted
    as an exchange)."""
    return scatter(_t(W, dtype, device), mesh, kind=None)


def pair_block_from_numpy(
    Z, mesh: SlotMesh, *, dtype=torch.float64, device="cpu"
) -> ShardedBlock:
    """A whole pair block (n2, 2, *spatial) of the complex schemes split
    over the mesh, pairs over the stage rows (not counted as an exchange)."""
    return scatter_pairs(_t(Z, dtype, device), mesh, kind=None)


def sharded_block_to_numpy(block: ShardedBlock) -> np.ndarray:
    """The whole stage block (or pair block) of a sharded one."""
    parts = [np.concatenate([t.detach().cpu().numpy() for t in row], axis=block.z_axis)
             for row in block.parts]
    return np.concatenate(parts, axis=0)


def mesh_prec_from_numpy(
    gmg: GMGData, inv_diags, thetas, deltas, coarse_inv, a, dim: int, mesh: SlotMesh,
) -> MeshPrec:
    """``gmg_prec_from_numpy`` followed by ``scatter_prec``: the multigrid
    state of the stage shifts ``a`` on the mesh, on ``gmg``'s dtype and
    device (the complex schemes' 2 n2 lanes, two to a stage row, too)."""
    dtype, device = gmg.coarse_mass.dtype, gmg.coarse_mass.device
    prec = gmg_prec_from_numpy(
        inv_diags, thetas, deltas, coarse_inv, dtype=dtype, device=device
    )
    return scatter_prec(gmg, prec, _t(a, dtype, device), dim, mesh)


def irk_tables_from_numpy(n_stages: int, **arrays) -> IRKTables:
    """``arrays``: every array field of ``IRKTables`` by name."""
    names = {f.name for f in dataclasses.fields(IRKTables)} - {"n_stages"}
    if set(arrays) != names:
        raise ValueError(f"expected the fields {sorted(names)}")
    return IRKTables(
        n_stages=n_stages,
        **{k: np.asarray(v, dtype=np.float64) for k, v in arrays.items()},
    )
