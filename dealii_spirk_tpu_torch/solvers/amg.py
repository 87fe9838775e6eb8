"""Algebraic multigrid (plain aggregation) — ``BlockPreconditionerType: "AMG"``.

Port of ``dealii_spirk_tpu/solvers/amg.py``, the JAX package's stand-in for
the reference's ``PreconditionerAMG`` (``preconditioner.h:176-215``, a
Trilinos ML AMG): a hierarchy built from the matrix entries rather than
the mesh.

* 1D aggregation: pairs of neighbouring unknowns {2i, 2i+1} form an
  aggregate (the last one keeps the remainder), with a piecewise-constant
  tentative prolongator (plain, unsmoothed aggregation);
* Galerkin coarse operators ``P^T A P`` per axis.  With ``P = P1 (x) ...
  (x) P1`` the coarse ``a M + b K`` stays in the separable family, with
  the 1D matrices ``P1^T M1 P1`` and ``P1^T K1 P1``, so the V-cycle, its
  Chebyshev smoothing and the dense coarse solve (``solvers/gmg.py``) run
  unchanged on these levels, the CUDA kernels included: the coarse band
  tables are contiguous (2p + 1, m) tables like the geometric ones, on
  even m as well as odd.

Iteration counts are those of plain aggregation, higher than geometric
multigrid's, and equal to the JAX package's, not to Trilinos ML's
(PARITY.md).  The numpy parts are built in f64, as in the JAX package,
and cast once.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fem.assembly import band_to_dense
from ..fem.grid import Space
from ..ops.mass_laplace import LevelOps
from .gmg import COARSE_SIZE_LIMIT, GMGData, coarse_dense


def aggregation_prolongator(m: int) -> np.ndarray:
    """Piecewise-constant tentative prolongator of the aggregates
    {2i, 2i+1} (the last aggregate keeps the remainder), (m, ceil(m/2))."""
    mc = (m + 1) // 2
    P = np.zeros((m, mc))
    P[np.arange(m), np.minimum(np.arange(m) // 2, mc - 1)] = 1.0
    return P


def dense_to_band(A: np.ndarray, p: int) -> np.ndarray:
    """Band storage ``band[p+k, i] = A[i, i+k]`` (the inverse of
    ``fem.assembly.band_to_dense``); raises if A has entries outside the
    band (aggregation's Galerkin products stay within the fine bandwidth:
    |I - J| <= (p + 1) / 2 <= p)."""
    m = A.shape[0]
    band = np.zeros((2 * p + 1, m))
    for k in range(-p, p + 1):
        i = np.arange(max(0, -k), min(m, m - k))
        band[p + k, i] = A[i, i + k]
    if not np.allclose(band_to_dense(band), A, atol=1e-13 * max(1.0, np.abs(A).max())):
        raise ValueError("matrix entries outside the band")
    return band


def build_amg_data(
    space: Space,
    dtype=torch.float64,
    device="cpu",
    with_dense: bool = False,
    coarse_size_limit: int = COARSE_SIZE_LIMIT,
) -> GMGData:
    """The aggregation hierarchy of ``space``'s finest level in the
    ``GMGData`` that ``build_gmg_data`` gives (``vcycle`` and
    ``gmg_reinit`` take it as it is); ``with_dense``: each level with its
    dense 1D matrices (the MatrixBased route)."""
    fine = space.levels[-1]
    p = fine.degree
    mats = [(fine.mass_dense, fine.stiff_dense)]
    prolongs: list[np.ndarray] = []
    # coarsen until the dense coarse solve takes over
    while mats[0][0].shape[0] ** space.dim > coarse_size_limit and mats[0][0].shape[0] > 2:
        M1, K1 = mats[0]
        P = aggregation_prolongator(M1.shape[0])
        mats.insert(0, (P.T @ M1 @ P, P.T @ K1 @ P))
        prolongs.insert(0, P)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device).contiguous()

    def ops_for(M1: np.ndarray, K1: np.ndarray) -> LevelOps:
        return LevelOps(
            mass_band=t(dense_to_band(M1, p)),
            stiff_band=t(dense_to_band(K1, p)),
            mass_diag=t(np.diag(M1)),
            stiff_diag=t(np.diag(K1)),
            mass_dense=t(M1) if with_dense else None,
            stiff_dense=t(K1) if with_dense else None,
        )

    cm, ck = coarse_dense(*mats[0], space.dim)
    return GMGData(
        level_ops=tuple(ops_for(M1, K1) for M1, K1 in mats),
        prolongs=tuple(t(P) for P in prolongs),
        coarse_mass=t(cm),
        coarse_stiff=t(ck),
    )
