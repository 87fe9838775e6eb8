"""One-step-theta (Crank–Nicolson) scheme — ``ost``.

Port of ``dealii_spirk_tpu/schemes/ost.py`` (reference
``TimeIntegrationSchemes::OneStepTheta``, ``main.cc:476-595``): theta = 1/2,
CG to an absolute ``1e-8 ||rhs||`` (at most 1000 iterations, warm started
at u^n) preconditioned by one multigrid V-cycle; no statistics.

The sign is the JAX package's *consistent* theta scheme for
``u_t = laplace(u) + f`` with the positive stiffness K:

    (M + theta tau K) u^{n+1}
        = (M - (1 - theta) tau K) u^n + tau [theta F^{n+1} + (1-theta) F^n]

The reference's OST carries the opposite sign on both K terms
(``main.cc:509``, ``:523``), inconsistent with its own IRK (README.md).

The solve runs on the one-lane block u[None]: with ``kernels`` the rhs,
the start residual and every CG vmult are K4 (``stencil_apply``; 2D
K4-2D) and the V-cycle runs K3/K4 at q=1, as ``irk``'s per-stage solves
do; without, the plain operators by the levels' route (MatrixBased: dense).
In f32 the CG target ``1e-8 ||rhs||`` lies below what f32 reaches; ``pcg``
floors it at 32 eps of the start residual, as the JAX package does.
"""

from __future__ import annotations

import torch

from ..ops.cuda import stencil as st
from ..solvers.gmg import gmg_reinit, vcycle
from ..solvers.krylov import pcg
from .base import SchemeBase

THETA = 0.5
MAXITER = 1000


class OneStepTheta(SchemeBase):
    def _reinit(self, tau):
        one = torch.ones(1, dtype=self.dtype, device=self.device)
        return gmg_reinit(self.gmg, one, THETA * tau, self.dim, start=self.start)

    def solve_step(self, u, timestep_number, t, tau):
        prec = self.prec_state(tau)
        one = torch.ones(1, dtype=self.dtype, device=self.device)
        apply = st.stencil_apply if self.kernels else st.stencil_apply_ref
        problem = self.problem
        with self.timers.phase("total"):
            with self.timers.phase("outer_solver"):
                U = u[None]
                rhs = apply(self.fine, one, -(1.0 - THETA) * tau, U)
                rhs = rhs + tau * THETA * problem.rhs(t)
                rhs = rhs + tau * (1.0 - THETA) * problem.rhs(t - tau)
                abstol = 1e-8 * torch.sqrt(torch.sum(rhs * rhs))
                res = pcg(
                    lambda v: apply(self.fine, one, THETA * tau, v),
                    rhs,
                    M=lambda r: vcycle(self.gmg, prec, one, THETA * tau, r, self.dim,
                                       kernels=self.kernels, cheb_pair=self.cheb_pair,
                                       phase=self.timers.phase),
                    x0=U,
                    maxiter=MAXITER,
                    abstol=abstol,
                )
                u = res.x[0]
        n_it = res.n_iterations
        if n_it >= MAXITER:
            raise RuntimeError(f"CG did not converge within {MAXITER} iterations")
        self.step_log.append({"n_outer": n_it})
        self.n_outer += n_it
        self.after_step(timestep_number)
        return u

    def get_statistics(self, table, scaling_factor=1.0):
        # the reference's OST reports no statistics (main.cc:539-546)
        pass
