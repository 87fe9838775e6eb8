"""Fully implicit Radau IIA Runge–Kutta with real-diagonalised
preconditioning — ``irk``, ``irk_batched`` and ``spirk``.

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
  V-cycle and CG iterations are counted in ``n_inner``;
* ``spirk``: the batched solve with the stage axis on the rows of a
  (stage, space) slot mesh and the z axis of a 3D field on its columns
  (``parallel/``; reference ``main.cc:1229-1760``): every Krylov vector is
  a ``ShardedBlock``, the vmult is the sharded K5 (K9b) + a mesh mix of
  ``M W`` by A^-1 + tau ``K W``, the preconditioner a mesh mix by T^-1, one
  sharded V-cycle (InnerTolerance 0) or the masked stage-batched CG over
  the sharded shifted apply (K9a) and that V-cycle (InnerTolerance > 0),
  and a mesh mix by T.  The mixes are the ring rotation
  (``UseSharedMemory`` false, one stage per row) or the all-gather; K1 and
  K2 couple the stages inside one kernel and are not used on a mesh, as
  in the JAX package.  Where the fine level does not split over the space
  axis (2D, or a z extent that ``canon_shardable`` refuses) the scheme
  warns and runs on the mesh's first space column — a (stage, 1) mesh —
  and never gathers a field to run it whole.

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

from ..ops.cuda import sharded as shk
from ..ops.cuda import stencil as st
from ..parallel.mesh import SlotMesh
from ..parallel.ring import allgather_stage_mix, ring_stage_mix
from ..parallel.sharding import gather, scatter
from ..solvers.gmg import gmg_reinit, scatter_prec, stage_prec, vcycle
from ..solvers.krylov import gmres, pcg
from .base import RadauScheme


class IRK(RadauScheme):
    def __init__(self, problem, params, mesh: SlotMesh | None = None, **options):
        """``mesh``: the slot mesh of ``spirk`` (default: one slot per
        stage on the problem's device).  ``options``: see ``RadauScheme``."""
        super().__init__(problem, params, **options)
        self.sequential = params.time_integration_scheme == "irk"
        tabs = self.tables
        self.T, self.T_inv = self.tensor(tabs.T), self.tensor(tabs.T_inv)
        self.d_vec = self.tensor(tabs.D)
        self._k1_table = None  # (tau, K1's coefficient table), k1_table
        self.mesh = None
        if params.time_integration_scheme == "spirk":
            self._init_mesh(mesh)

    def _init_mesh(self, mesh: SlotMesh | None) -> None:
        q = self.q
        mesh = self.fit_mesh(mesh, q)
        if q % mesh.n_stage:
            raise ValueError(f"{q} stages do not split over a stage axis of {mesh.n_stage}")
        self.mesh = mesh
        # the mixers take their matrices on the host (parallel/ring.py)
        self._host = {
            name: getattr(self, name).cpu() for name in ("A_inv", "T", "T_inv")
        }
        self.ring = not self.params.use_sm and mesh.n_stage == q
        self._mixer = ring_stage_mix if self.ring else allgather_stage_mix
        self.fine_level = shk.shard_level(self.fine, mesh, self.dim)

    def mix(self, name: str, W):
        """The stage mix by ``A_inv``, ``T`` or ``T_inv`` on the mesh."""
        return self._mixer(self._host[name], W)

    def _reinit(self, tau):
        # all stages batched, also for `irk` (JAX schemes/irk.py:165-166)
        prec = gmg_reinit(self.gmg, self.d_vec, tau, self.dim, start=self.start)
        if self.mesh is None:
            return prec
        return scatter_prec(self.gmg, prec, self.d_vec, self.dim, self.mesh)

    def rhs_fn(self, u, t, tau):
        if self.mesh is None:
            return super().rhs_fn(u, t, tau)
        return self.mix("A_inv", scatter(self.stage_rhs(u, t, tau), self.mesh))

    def update_fn(self, u, W, tau):
        if self.mesh is not None:
            W = gather(W, self.device)
        return super().update_fn(u, W, tau)

    def _solve_mesh(self, W_rhs, prec, tau):
        """``solve_fn`` on the mesh (JAX schemes/irk.py:183-327 with a
        mesh)."""
        k, q, mesh, level = self.kernels, self.q, self.mesh, self.fine_level
        phase = self.timers.phase

        def Aop(W):  # K9b (2D: K5-2D per stage row), the mesh mix, + tau K W
            with phase("system_vmult"):
                MW, KW = shk.sharded_mass_stiffness_apply(level, W, kernels=k)
                return self.mix("A_inv", MW) + tau * KW

        def shifted(W):  # the inner CG's operator: K9a (2D: K4-2D)
            return shk.sharded_stencil_apply(level, self.d_vec, tau, W, kernels=k)

        def V(r):
            return vcycle(self.gmg, prec, self.d_vec, tau, r, self.dim, kernels=k, mesh=mesh,
                          phase=phase)

        inner_tol = self.params.inner_tolerance

        def Mop(v, carry):
            with phase("preconditioner_bc"):
                z = self.mix("T_inv", v)
            with phase("preconditioner_solver"):
                if inner_tol > 0.0:
                    res = pcg(shifted, z, M=V, maxiter=100, abstol=1e-10, reltol=inner_tol,
                              batch=True)
                    z = res.x
                    carry = carry + res.n_iterations.cpu().numpy()
                else:
                    z = V(z)
                    carry = carry + 1
            with phase("preconditioner_bc"):
                return self.mix("T", z), carry

        res = gmres(
            Aop,
            W_rhs,
            M=Mop,
            M_carry=np.zeros(q, dtype=np.int64),
            maxiter=1000,
            abstol=1e-20,
            reltol=self.params.outer_tolerance,
            restart=self.restart,
            phase=phase,
        )
        return res.x, res.n_iterations, res.M_carry, res.n_restarts

    def _stage_solve(self, prec_i, i: int, z: torch.Tensor, tau) -> tuple[torch.Tensor, int]:
        """(d_i M + tau K)^-1 z for one stage block z (1, *spatial): one
        V-cycle, or CG preconditioned by it (JAX irk.py:235-257); returns
        the solution and its inner count."""
        d_i = self.d_vec[i : i + 1]

        def V(r):
            return vcycle(self.gmg, prec_i, d_i, tau, r, self.dim, kernels=self.kernels,
                          cheb_pair=self.cheb_pair, phase=self.timers.phase)

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

    def k1_table(self, tau) -> torch.Tensor:
        """K1's (q + 1, q) coefficient table [A^-1; tau] (``st.mix_table``),
        built once per tau and handed to every K1 launch of the vmult."""
        if self._k1_table is None or self._k1_table[0] != float(tau):
            self._k1_table = (float(tau), st.mix_table(self.A_inv, tau))
        return self._k1_table[1]

    def solve_fn(self, W_rhs, prec, tau):
        """GMRES on the coupled system; returns (W, n_outer, per-stage
        inner counts, restarts)."""
        if self.mesh is not None:
            return self._solve_mesh(W_rhs, prec, tau)
        k, fine, dim, q = self.kernels, self.fine, self.dim, self.q
        mix = st.stage_mix if k else st.stage_mix_ref
        ms = st.mass_stiffness_apply if k else st.mass_stiffness_apply_ref
        phase = self.timers.phase
        k1 = k and dim == 3 and not self.sequential
        mw = self.k1_table(tau) if k1 else None

        def Aop(W):
            with phase("system_vmult"):
                if k1:
                    return st.ms_mix_apply(fine, self.A_inv, tau, W, mw)
                MW, KW = ms(fine, W)  # K5, K2, + tau K W
                return mix(self.A_inv, MW) + tau * KW

        stage_precs = [stage_prec(prec, i) for i in range(q)] if self.sequential else None

        def Mop(v, carry):
            with phase("preconditioner_bc"):
                z = mix(self.T_inv, v)
            with phase("preconditioner_solver"):
                if self.sequential:
                    carry = carry.copy()
                    outs = []
                    for i in range(q):
                        zi, n = self._stage_solve(stage_precs[i], i, z[i : i + 1], tau)
                        outs.append(zi)
                        carry[i] += n
                    z = torch.cat(outs)
                else:
                    z = vcycle(self.gmg, prec, self.d_vec, tau, z, dim, kernels=k,
                               cheb_pair=self.cheb_pair, phase=phase)
                    carry = carry + 1
            with phase("preconditioner_bc"):
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
            phase=phase,
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
        # main.cc:1115-1119); `irk` and `spirk` count every stage's inner
        # iterations
        inner = int(n_inner[0]) if self.params.is_batched else int(n_inner.sum())
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
