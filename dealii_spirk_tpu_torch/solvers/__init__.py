"""Krylov solvers, Chebyshev smoothing and geometric multigrid (port of
``dealii_spirk_tpu/solvers``)."""

from .krylov import gmres, pcg
from .gcr import gcr
from .chebyshev import chebyshev_apply, estimate_chebyshev_range
from .gmg import GMGData, build_gmg_data, gmg_reinit, vcycle

__all__ = [
    "pcg",
    "gmres",
    "gcr",
    "chebyshev_apply",
    "estimate_chebyshev_range",
    "GMGData",
    "build_gmg_data",
    "gmg_reinit",
    "vcycle",
]
