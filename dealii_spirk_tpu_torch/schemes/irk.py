"""Fully implicit Radau IIA Runge–Kutta with real-diagonalised
preconditioning — ``irk`` and ``irk_batched``.

Port of ``dealii_spirk_tpu/schemes/irk.py`` (reference
``main.cc:771-1222``).  An s-stage step solves the coupled system

    (A^{-1} (x) M + tau I (x) K) W = (A^{-1} (x) I) R,
    R_i = F(t + (c_i - 1) tau) - K u^n,

by outer GMRES preconditioned with ``T (block-diag solves) T^{-1}``, where
``T diag(D) T^{-1} = L`` is the real diagonalisation of the lower-
triangular factor of A^{-1}.  The update is ``u += tau sum_i b_i W_i``.
The diagonal blocks ``(d_i M + tau K)`` are solved

* ``irk_batched``: together, by one stage-batched GMG V-cycle
  (InnerTolerance is ignored, as in the JAX package);
* ``irk``: one stage after the other (reference ``main.cc:1122-1154``),
  each by one V-cycle on that stage (InnerTolerance 0) or by CG with the
  V-cycle as its preconditioner (InnerTolerance > 0); every stage's
  V-cycle and CG iterations are counted in ``n_inner``.

With ``kernels=True`` the solve runs the hand-written kernels
(``ops/cuda/stencil.py``): the outer vmult is K1 (``ms_mix_apply``) for
3D ``irk_batched`` and otherwise K5 (``mass_stiffness_apply``), then a K2
mix of ``M W`` by A^-1 and ``+ tau K W``, as the JAX package does where
its one-pass vmult does not run (``irk.py:189-200``); the T^-1 / T mixes
are K2 (``stage_mix``) and the V-cycles run K3/K4 (3D) or K4-2D.  With
``kernels=False`` the same solve runs the plain torch operators.

Above ``COMPACT_GRID_DOFS`` DoFs per stage GMRES restarts every
``COMPACT_BASIS`` iterations, as the JAX package does, and a solve that
runs past them warns: deal.II's 30-vector basis would not have restarted.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.cuda import stencil as st
from ..solvers.gmg import gmg_reinit, stage_prec, vcycle
from ..solvers.krylov import gmres, pcg
from .base import RadauScheme


class IRK(RadauScheme):
    def __init__(self, problem, params, **options):
        """``options``: see ``RadauScheme``."""
        super().__init__(problem, params, **options)
        self.sequential = params.time_integration_scheme == "irk"
        tabs = self.tables
        self.T, self.T_inv = self.tensor(tabs.T), self.tensor(tabs.T_inv)
        self.d_vec = self.tensor(tabs.D)

    def _reinit(self, tau):
        # all stages batched, also for `irk` (JAX schemes/irk.py:165-166)
        return gmg_reinit(self.gmg, self.d_vec, tau, self.dim, start=self.start)

    def _stage_solve(self, prec_i, i: int, z: torch.Tensor, tau) -> tuple[torch.Tensor, int]:
        """(d_i M + tau K)^-1 z for one stage block z (1, *spatial): one
        V-cycle, or CG preconditioned by it (JAX irk.py:235-257); returns
        the solution and its inner count."""
        d_i = self.d_vec[i : i + 1]

        def V(r):
            return vcycle(self.gmg, prec_i, d_i, tau, r, self.dim, kernels=self.kernels)

        inner_tol = self.params.inner_tolerance
        if inner_tol <= 0.0:
            return V(z), 1
        apply = st.stencil_apply if self.kernels else st.stencil_apply_ref
        res = pcg(
            lambda w: apply(self.fine, d_i, tau, w),
            z,
            M=V,
            maxiter=100,
            abstol=1e-10,
            reltol=inner_tol,
        )
        return res.x, res.n_iterations

    def solve_fn(self, W_rhs, prec, tau):
        """GMRES on the coupled system; returns (W, n_outer, per-stage
        inner counts, restarts)."""
        k, fine, dim, q = self.kernels, self.fine, self.dim, self.q
        mix = st.stage_mix if k else st.stage_mix_ref
        ms = st.mass_stiffness_apply if k else st.mass_stiffness_apply_ref

        if k and dim == 3 and not self.sequential:

            def Aop(W):  # K1
                return st.ms_mix_apply(fine, self.A_inv, tau, W)

        else:

            def Aop(W):  # K5, K2, + tau K W
                MW, KW = ms(fine, W)
                return mix(self.A_inv, MW) + tau * KW

        stage_precs = [stage_prec(prec, i) for i in range(q)] if self.sequential else None

        def Mop(v, carry):
            z = mix(self.T_inv, v)
            if self.sequential:
                carry = carry.copy()
                outs = []
                for i in range(q):
                    zi, n = self._stage_solve(stage_precs[i], i, z[i : i + 1], tau)
                    outs.append(zi)
                    carry[i] += n
                z = torch.cat(outs)
            else:
                z = vcycle(self.gmg, prec, self.d_vec, tau, z, dim, kernels=k)
                carry = carry + 1
            return mix(self.T, z), carry

        res = gmres(
            Aop,
            W_rhs,
            M=Mop,
            M_carry=np.zeros(q, dtype=np.int64),
            maxiter=1000,
            abstol=1e-20,
            reltol=self.params.outer_tolerance,
            restart=self.restart,
        )
        return res.x, res.n_iterations, res.M_carry, res.n_restarts

    def solve_step(self, u, timestep_number, t, tau):
        prec = self.prec_state(tau)
        with self.timers.phase("total"):
            with self.timers.phase("rhs"):
                W_rhs = self.rhs_fn(u, t, tau)
            with self.timers.phase("outer_solver"):
                W, n_outer, n_inner, n_restarts = self.solve_fn(W_rhs, prec, tau)
            with self.timers.phase("solution_update"):
                u = self.update_fn(u, W, tau)
        self.check_outer(n_outer, "outer GMRES")
        # the batched scheme's block V-cycle counts once (reference
        # main.cc:1115-1119); `irk` counts every stage's inner iterations
        inner = int(n_inner.sum()) if self.sequential else int(n_inner[0])
        self.step_log.append(
            {
                "n_outer": n_outer,
                "n_inner": inner,
                "n_inner_stage": n_inner.tolist(),
                "n_restarts": n_restarts,
            }
        )
        self.n_outer += n_outer
        self.n_inner_stage = self.n_inner_stage + n_inner
        self.n_inner += inner
        self.after_step(timestep_number)
        return u

    def get_statistics(self, table, scaling_factor=1.0):
        super().get_statistics(table, scaling_factor)
        self.add_per_stage_times(table, scaling_factor, self.q)
