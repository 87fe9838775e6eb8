"""Grid levels and the per-refinement discretization bundle.

A refinement level ``l`` of the unit hypercube has ``2^l`` cells per axis
(reference ``main.cc:3038-3039``: ``GridGenerator::hyper_cube`` +
``refine_global``).  Because the grid is isotropic, one set of 1D data
serves every spatial axis.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .assembly import (
    assemble_band_1d,
    band_to_dense,
    evaluation_operator,
    interior_nodes_1d,
    local_matrices,
    prolongation_1d,
)


@dataclass(frozen=True)
class Level1D:
    """All 1D operator data for one refinement level (numpy, host-side)."""

    refinement: int
    degree: int
    n_cells: int
    h: float
    m: int  # number of interior nodes per axis
    x: np.ndarray  # interior node coordinates, (m,)
    mass_band: np.ndarray  # (2p+1, m)
    stiff_band: np.ndarray  # (2p+1, m)
    mass_diag: np.ndarray  # (m,)
    stiff_diag: np.ndarray  # (m,)

    @property
    def mass_dense(self) -> np.ndarray:
        return band_to_dense(self.mass_band)

    @property
    def stiff_dense(self) -> np.ndarray:
        return band_to_dense(self.stiff_band)


def make_level(refinement: int, degree: int) -> Level1D:
    n_cells = 2**refinement
    h = 1.0 / n_cells
    mloc, kloc = local_matrices(degree)
    mass_band = assemble_band_1d(n_cells, degree, mloc, h)
    stiff_band = assemble_band_1d(n_cells, degree, kloc, 1.0 / h)
    p = degree
    return Level1D(
        refinement=refinement,
        degree=degree,
        n_cells=n_cells,
        h=h,
        m=n_cells * degree - 1,
        x=interior_nodes_1d(n_cells, degree),
        mass_band=mass_band,
        stiff_band=stiff_band,
        mass_diag=mass_band[p].copy(),
        stiff_diag=stiff_band[p].copy(),
    )


def min_refinement(degree: int) -> int:
    """Coarsest level with at least one interior node per axis."""
    return 1 if degree == 1 else 0


@dataclass(frozen=True)
class Space:
    """Discretization of the heat-equation problem at one refinement.

    Bundles the finest-level 1D data, the geometric-coarsening hierarchy
    for GMG (coarse -> fine, analogous to
    ``create_geometric_coarsening_sequence`` at reference
    ``main.cc:3091-3093``), 1D prolongations between consecutive levels,
    and the quadrature machinery for RHS assembly and error evaluation.
    """

    dim: int
    degree: int
    refinement: int
    levels: tuple[Level1D, ...]  # coarse -> fine
    prolongations: tuple[np.ndarray, ...]  # [l]: level l -> level l+1
    # RHS load with QGauss(p+1): 1D basis integrals against sin(a pi x)
    rhs_eval: np.ndarray  # (nq_rhs, m) evaluation operator
    rhs_xq: np.ndarray
    rhs_wq: np.ndarray
    # error integration with QGauss(p+2)
    err_eval: np.ndarray  # (nq_err, m)
    err_xq: np.ndarray
    err_wq: np.ndarray
    wave_number: float = field(default=2.0)

    @property
    def fine(self) -> Level1D:
        return self.levels[-1]

    @property
    def shape(self) -> tuple[int, ...]:
        return (self.fine.m,) * self.dim

    @property
    def n_dofs(self) -> int:
        """Total DoF count *including* boundary nodes (table parity with
        reference ``main.cc:3387``)."""
        return (self.fine.n_cells * self.degree + 1) ** self.dim

    @property
    def n_cells_total(self) -> int:
        return self.fine.n_cells**self.dim

    @property
    def dx_min(self) -> float:
        """Minimum vertex distance (= cell width on the hypercube), used by
        the automatic time-step rule (reference ``main.cc:3310-3318``)."""
        return self.fine.h


def make_space(dim: int, degree: int, refinement: int) -> Space:
    if dim not in (2, 3):
        raise ValueError("reference supports dim in {2, 3} (irk-2D/irk-3D)")
    lmin = min_refinement(degree)
    if refinement < lmin:
        raise ValueError(f"refinement must be >= {lmin} for degree {degree}")
    levels = tuple(make_level(l, degree) for l in range(lmin, refinement + 1))
    prolongations = tuple(
        prolongation_1d(lev.n_cells, degree) for lev in levels[:-1]
    )
    fine = levels[-1]
    rhs_eval, rhs_xq, rhs_wq = evaluation_operator(
        fine.n_cells, degree, degree + 1
    )
    err_eval, err_xq, err_wq = evaluation_operator(
        fine.n_cells, degree, degree + 2
    )
    return Space(
        dim=dim,
        degree=degree,
        refinement=refinement,
        levels=levels,
        prolongations=prolongations,
        rhs_eval=rhs_eval,
        rhs_xq=rhs_xq,
        rhs_wq=rhs_wq,
        err_eval=err_eval,
        err_xq=err_xq,
        err_wq=err_wq,
    )
