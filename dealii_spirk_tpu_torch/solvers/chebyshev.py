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
(K4 ``stencil_apply``, K3 ``cheb_iter``) or their plain versions.  Given
``cheb_pair`` it takes the iterations two at a time, then the odd one
singly, as the JAX package's ``body2`` / ``use_pair`` loop does
(``solvers/gmg.py:572-603``).
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
    jacobi: Callable,
    theta: torch.Tensor,
    delta: torch.Tensor,
    b: torch.Tensor,
    *,
    x0: torch.Tensor | None = None,
    degree: int = 5,
    cheb_pair: Callable | None = None,
) -> torch.Tensor:
    """Chebyshev-accelerated Jacobi iteration of the given degree on a
    stage block ``b`` (q, *spatial) with per-stage ``theta``/``delta``.

    ``apply(u)`` is the operator; ``jacobi(r)`` is ``D^-1 r`` (of the entry
    step); ``cheb_iter(c1, c2, d, r, x)`` one fused step
    ``r' = r - A d; d' = c1 d + c2 D^-1 r'; x' = x + d'``.  With
    ``x0=None`` this is the preconditioner application (deal.II ``vmult``,
    zero initial guess — GMG pre-smoothing); with an initial guess it is
    the smoother ``step`` used for post-smoothing.

    ``cheb_pair(c1a, c2a, c1b, c2b, d, r, x)``: two steps in one call (K8),
    the first with (c1a, c2a), the second with (c1b, c2b); with it the
    ``degree - 1`` steps run as floor((degree - 1) / 2) pair calls and, for
    an even degree, one last ``cheb_iter``.
    """
    lanes = (b.shape[0],) + (1,) * (b.ndim - 1)
    theta_b = theta.reshape(lanes)
    r = b if x0 is None else b - apply(x0)
    d = jacobi(r) / theta_b
    x = d if x0 is None else x0 + d
    sigma = theta / delta
    rho = 1.0 / sigma
    n_pair, n_single = divmod(degree - 1, 2) if cheb_pair is not None else (0, degree - 1)
    for _ in range(n_pair):
        rho1 = 1.0 / (2.0 * sigma - rho)
        rho2 = 1.0 / (2.0 * sigma - rho1)
        r, d, x = cheb_pair(
            rho1 * rho, 2.0 * rho1 / delta, rho2 * rho1, 2.0 * rho2 / delta, d, r, x
        )
        rho = rho2
    for _ in range(n_single):
        rho_new = 1.0 / (2.0 * sigma - rho)
        r, d, x = cheb_iter(rho_new * rho, 2.0 * rho_new / delta, d, r, x)
        rho = rho_new
    return x
