"""Chebyshev point-Jacobi smoother (deal.II PreconditionChebyshev semantics).

Port of ``dealii_spirk_tpu/solvers/chebyshev.py``.  The reference smooths
every GMG level with Chebyshev(degree=5, smoothing_range=20) over a
point-Jacobi preconditioner, with the interval estimated by 20 CG
iterations (reference ``preconditioner.h:219-232``, ``:352-373``).

``chebyshev_apply`` is written the way the JAX package's canonical
smoother (``solvers/gmg.py::_chebyshev_canon``) runs it: the entry step
(with the residual ``b - A x0`` when an initial guess is given) and then
``degree - 1`` fused iterations, each one call of ``cheb_iter``.  The
caller passes the operator pieces, so the same code runs the CUDA kernels
(K4 ``stencil_apply``, K3 ``cheb_iter``) or their plain versions.
"""

from __future__ import annotations

from typing import Callable

import torch

from .krylov import cg_lanczos_extremal_eigs


def estimate_chebyshev_range(
    A: Callable,
    inv_diag,
    rhs,
    *,
    n_cg_iterations: int,
    smoothing_range: float,
):
    """Per-stage Chebyshev intervals ``(theta, delta)`` = (centre,
    half-width) of a stage block from CG-Lanczos on the
    Jacobi-preconditioned operator: ``max_ev = 1.2 * lambda_max``,
    ``min_ev = max_ev / smoothing_range``."""
    _lmin, lmax = cg_lanczos_extremal_eigs(
        A, rhs, M=lambda r: inv_diag * r, n_iterations=n_cg_iterations, batch=True
    )
    max_ev = 1.2 * lmax
    min_ev = max_ev / smoothing_range
    return 0.5 * (max_ev + min_ev), 0.5 * (max_ev - min_ev)


def chebyshev_apply(
    apply: Callable,
    cheb_iter: Callable,
    inv_diag: torch.Tensor,
    theta: torch.Tensor,
    delta: torch.Tensor,
    b: torch.Tensor,
    *,
    x0: torch.Tensor | None = None,
    degree: int = 5,
) -> torch.Tensor:
    """Chebyshev-accelerated Jacobi iteration of the given degree on a
    stage block ``b`` (q, *spatial) with per-stage ``theta``/``delta``.

    ``apply(u)`` is the operator; ``cheb_iter(c1, c2, d, r, x)`` one fused
    step ``r' = r - A d; d' = c1 d + c2 D^-1 r'; x' = x + d'``.  With
    ``x0=None`` this is the preconditioner application (deal.II ``vmult``,
    zero initial guess — GMG pre-smoothing); with an initial guess it is
    the smoother ``step`` used for post-smoothing.
    """
    lanes = (b.shape[0],) + (1,) * (b.ndim - 1)
    theta_b = theta.reshape(lanes)
    r = b if x0 is None else b - apply(x0)
    d = (inv_diag * r) / theta_b
    x = d if x0 is None else x0 + d
    sigma = theta / delta
    rho = 1.0 / sigma
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        r, d, x = cheb_iter(rho_new * rho, 2.0 * rho_new / delta, d, r, x)
        rho = rho_new
    return x
