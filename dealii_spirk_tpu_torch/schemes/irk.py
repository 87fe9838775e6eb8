"""Fully implicit Radau IIA Runge–Kutta with real-diagonalised
preconditioning — ``irk_batched``.

Port of the ``irk_batched`` path of ``dealii_spirk_tpu/schemes/irk.py``
(reference ``main.cc:771-1222``).  An s-stage step solves the coupled
system

    (A^{-1} (x) M + tau I (x) K) W = (A^{-1} (x) I) R,
    R_i = F(t + (c_i - 1) tau) - K u^n,

by outer GMRES preconditioned with ``T (block-diag solves) T^{-1}``, where
``T diag(D) T^{-1} = L`` is the real diagonalisation of the lower-
triangular factor of A^{-1}; the diagonal blocks ``(d_i M + tau K)`` are
solved together by one stage-batched GMG V-cycle (InnerTolerance 0 — the
batched scheme ignores InnerTolerance, as in the JAX package).  The
update is ``u += tau sum_i b_i W_i``.

With ``kernels=True`` the outer vmult is kernel K1 (``ms_mix_apply``),
the T^-1 / T mixes are K2 (``stage_mix``) and the V-cycle runs K3/K4;
with ``kernels=False`` the same solve runs the plain torch operators.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.cuda import stencil as st
from ..ops.mass_laplace import apply_stiffness
from ..solvers.gmg import gmg_reinit, vcycle
from ..solvers.krylov import gmres
from ..tables import IRKTables, irk_tables
from .base import SchemeBase, stage_times_factor

GMRES_RESTART = 28  # deal.II's default basis (30 temporary vectors)


class IRK(SchemeBase):
    def __init__(
        self,
        problem,
        params,
        *,
        kernels: bool | None = None,
        tables: IRKTables | None = None,
        start=None,
    ):
        """``kernels``: run the hand-written kernels (default: when the
        configuration's operator mode on this device is "pallas").
        ``tables``: Butcher/diagonalisation tables (default: computed).
        ``start``: Lanczos start vectors for ``gmg_reinit``."""
        super().__init__(problem, params)
        mode = params.operator_mode(self.device)
        if mode == "dense":
            raise NotImplementedError(
                "MatrixBased (dense) operators are not ported yet (ROADMAP Queue 1 item 7)"
            )
        self.kernels = mode == "pallas" if kernels is None else kernels
        q = params.irk_stages
        self.q = q
        tabs = tables if tables is not None else irk_tables(q)

        def t(a):
            return torch.as_tensor(a, dtype=self.dtype, device=self.device)

        self.A_inv, self.T, self.T_inv = t(tabs.A_inv), t(tabs.T), t(tabs.T_inv)
        self.b_vec, self.c_vec, self.d_vec = t(tabs.b), t(tabs.c), t(tabs.D)
        self.start = start
        # per-step solver counts of every step (never cleared)
        self.step_log: list[dict] = []

    def _reinit(self, tau):
        return gmg_reinit(self.gmg, self.d_vec, tau, self.dim, start=self.start)

    def rhs_fn(self, u, t, tau):
        tf = stage_times_factor(self.c_vec, t, tau, self.dim)
        W = self.problem.stage_load(tf)
        W = W - apply_stiffness(self.fine, u, self.dim)[None]
        # the A^-1 mix of the rhs stays the plain GEMM (once per step)
        return st.stage_mix_ref(self.A_inv, W)

    def solve_fn(self, W_rhs, prec, tau):
        """GMRES on the coupled system; returns (W, n_outer, per-stage
        inner counts, restarts)."""
        if self.kernels:
            ms_mix, mix = st.ms_mix_apply, st.stage_mix
        else:
            ms_mix, mix = st.ms_mix_apply_ref, st.stage_mix_ref
        fine, dim = self.fine, self.dim

        def Aop(W):
            return ms_mix(fine, self.A_inv, tau, W)

        def Mop(v, carry):
            z = mix(self.T_inv, v)
            z = vcycle(self.gmg, prec, self.d_vec, tau, z, dim, kernels=self.kernels)
            return mix(self.T, z), carry + 1

        res = gmres(
            Aop,
            W_rhs,
            M=Mop,
            M_carry=np.zeros(self.q, dtype=np.int64),
            maxiter=1000,
            abstol=1e-20,
            reltol=self.params.outer_tolerance,
            restart=GMRES_RESTART,
        )
        return res.x, res.n_iterations, res.M_carry, res.n_restarts

    def update_fn(self, u, W, tau):
        return u + tau * torch.tensordot(self.b_vec, W, dims=1)

    def solve_step(self, u, timestep_number, t, tau):
        prec = self.prec_state(tau)
        with self.timers.phase("total"):
            with self.timers.phase("rhs"):
                W_rhs = self.rhs_fn(u, t, tau)
            with self.timers.phase("outer_solver"):
                W, n_outer, n_inner, n_restarts = self.solve_fn(W_rhs, prec, tau)
            with self.timers.phase("solution_update"):
                u = self.update_fn(u, W, tau)
        if n_outer >= 1000:
            # reference aborts on solver non-convergence (main.cc:927-930)
            raise RuntimeError("outer GMRES did not converge within 1000 iterations")
        self.step_log.append(
            {"n_outer": n_outer, "n_inner": int(n_inner[0]), "n_restarts": n_restarts}
        )
        self.n_outer += n_outer
        self.n_inner_stage = self.n_inner_stage + n_inner
        # one block V-cycle counts once (reference main.cc:1115-1119)
        self.n_inner += int(n_inner[0])
        self.after_step(timestep_number)
        return u

    def get_statistics(self, table, scaling_factor=1.0):
        super().get_statistics(table, scaling_factor)
        self.add_per_stage_times(table, scaling_factor, self.q)
