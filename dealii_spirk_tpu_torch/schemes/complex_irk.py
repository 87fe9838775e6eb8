"""Complex-diagonalised Radau IIA — ``complex_irk``, ``complex_irk_batched``,
``complex_spirk`` and ``complex_spirk_batched``.

Port of ``dealii_spirk_tpu/schemes/complex_irk.py`` (reference
``main.cc:1886-2375`` and ``main.cc:2382-2934``).  The stage system is
diagonalised exactly with the complex eigendecomposition
``A^-1 = V diag(lambda) V^-1``, so there is no outer Krylov loop over the
coupled system:

1. the complex ``T^-1`` maps the q real stage right-hand sides to one
   (re, im) block per conjugate pair (the representative at the even
   index), ceil(q/2) pairs (reference ``main.cc:2149-2155``);
2. each pair solves ``((lambda_re + i lambda_im) M + tau K) w = z`` in
   2x2 real-block form by GMRES to OuterTolerance, the pairs as masked
   lanes of one batched GMRES (``krylov.gmres(batch=True)``), each with
   its own count;
3. the back map ``2 Re(T w)`` doubles the pairs that stand for a
   conjugate pair (reference ``main.cc:2216-2225``).

The pair preconditioner is

* ``complex_irk_batched``: one block V-cycle over the 2 n2 (re, im) lanes
  with the shift ``lambda_re + lambda_im`` of each pair;
* ``complex_irk``: PRESB (reference ``main.cc:2284-2335``), two shifted
  inner solves per application, each one V-cycle (InnerTolerance 0) or
  CG preconditioned by it to the *absolute* tolerance InnerTolerance
  (reference ``main.cc:2302``).

With ``kernels=True`` the pair vmult is K5 (``mass_stiffness_apply``) on
the 2 n2 lanes, a K2 mix of ``M Z`` by the 2x2 blocks
``[[l_re, -l_im], [l_im, l_re]]`` and ``+ tau K Z``; the T^-1 and T maps
are one K2 each (the (re, im) rows interleaved), PRESB's ``M x0`` and the
inner CG operator are K4, and the V-cycles run K3 / K3dg / K4 (K8 on the
``cheb_pair`` levels when asked).  With ``kernels=False`` the same solve
runs the plain torch versions.

``complex_spirk(_batched)`` run the same solve with the pair axis on the
stage rows of an (n2, space) slot mesh (``mesh=``; the JAX package's
``ComplexIRK(mesh=)``): both components of pair j live on row j, the z
axis of a 3D field on the space slots (``parallel/sharding.py::
scatter_pairs``).  The right-hand side is formed and mapped by T^-1
unsharded, scattered onto the mesh, and the solution gathered and mapped
back by T, every message through ``sharding.send``.  The pair vmult is K9b
per slot and the 2x2 block, which is row-local: it passes no message along
the stage axis, only z halos.  The preconditioner is one mesh V-cycle over
the 2 n2 lanes (batched) or PRESB's two shifted mesh solves over n2 lanes,
each one mesh V-cycle or the masked batched CG over K9a, with ``M x0`` K9a
at (a, b) = (1, 0).  A fine level that does not split over the space axis
narrows the mesh to (n2, 1) with a RuntimeWarning, as ``spirk`` does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.cuda import sharded as shk
from ..ops.cuda import stencil as st
from ..parallel.mesh import SlotMesh
from ..parallel.sharding import (
    gather,
    lane_view,
    pair_component,
    pair_view,
    scatter_pairs,
    stack_pairs,
)
from ..solvers.gmg import gmg_reinit, scatter_prec, vcycle
from ..solvers.krylov import gmres, pcg
from .base import RadauScheme


class ComplexIRK(RadauScheme):
    def __init__(self, problem, params, mesh: SlotMesh | None = None, **options):
        """``mesh``: the slot mesh of ``complex_spirk(_batched)`` (default:
        one slot per pair on the problem's device).  ``options``: see
        ``RadauScheme``."""
        super().__init__(problem, params, **options)
        self.batched = params.is_batched
        q, tabs = self.q, self.tables
        n2 = tabs.n_pairs
        self.n_pairs = n2
        # pair representatives: rows / columns at even indices
        d_re, d_im = tabs.D_re[::2], tabs.D_im[::2]
        scal = np.where(np.arange(n2) < q // 2, 2.0, 1.0)
        T_re_s, T_im_s = tabs.T_re[:, ::2] * scal, tabs.T_im[:, ::2] * scal
        # (re, im) of pair j at lane 2j + c of the flattened (2 n2) block
        fwd = np.empty((2 * n2, q))
        fwd[0::2], fwd[1::2] = tabs.T_inv_re[::2], tabs.T_inv_im[::2]
        back = np.empty((q, 2 * n2))
        back[:, 0::2], back[:, 1::2] = T_re_s, -T_im_s
        block = np.zeros((2 * n2, 2 * n2))
        for j in range(n2):
            block[2 * j : 2 * j + 2, 2 * j : 2 * j + 2] = [
                [d_re[j], -d_im[j]],
                [d_im[j], d_re[j]],
            ]
        self.T_inv_pairs, self.T_pairs = self.tensor(fwd), self.tensor(back)
        self.lam_block = self.tensor(block)
        self.d_im = self.tensor(d_im)
        # PRESB / block-GMG shifts (reference main.cc:1959)
        self.shifts = self.tensor(d_re + d_im)
        self.shifts_lanes = self.shifts.repeat_interleave(2)
        self.mesh = None
        if params.is_stage_parallel:
            self._init_mesh(mesh, d_re, d_im)

    def _init_mesh(self, mesh: SlotMesh | None, d_re, d_im) -> None:
        n2 = self.n_pairs
        mesh = self.fit_mesh(mesh, n2)
        if n2 % mesh.n_stage:
            raise ValueError(f"{n2} pairs do not split over a stage axis of {mesh.n_stage}")
        self.mesh = mesh
        self.fine_level = shk.shard_level(self.fine, mesh, self.dim)
        # every slot's (l_re, l_im) of its row's pairs, shaped to its block
        pl = n2 // mesh.n_stage
        self._lam_slots = [
            [
                tuple(
                    torch.as_tensor(v[i * pl : (i + 1) * pl], dtype=self.dtype,
                                    device=mesh.device(i, j)).reshape((pl,) + (1,) * self.dim)
                    for v in (d_re, d_im)
                )
                for j in range(mesh.n_space)
            ]
            for i in range(mesh.n_stage)
        ]

    def _reinit(self, tau):
        # block GMG: both (re, im) components share the pair's shift
        a = self.shifts_lanes if self.batched else self.shifts
        prec = gmg_reinit(self.gmg, a, tau, self.dim, start=self.start)
        if self.mesh is None:
            return prec
        return scatter_prec(self.gmg, prec, a, self.dim, self.mesh)

    def _vcycle(self, prec, a, tau, r):
        if self.mesh is not None:
            return vcycle(self.gmg, prec, a, tau, r, self.dim, kernels=self.kernels,
                          mesh=self.mesh, phase=self.timers.phase)
        return vcycle(self.gmg, prec, a, tau, r, self.dim, kernels=self.kernels,
                      cheb_pair=self.cheb_pair, phase=self.timers.phase)

    def _shifted(self, a, tau, w):
        """(a_j M + tau K) w_j: K4, or K9a on the mesh."""
        if self.mesh is not None:
            return shk.sharded_stencil_apply(self.fine_level, a, tau, w, kernels=self.kernels)
        apply = st.stencil_apply if self.kernels else st.stencil_apply_ref
        return apply(self.fine, a, tau, w)

    def _inner_solve(self, rhs, prec, tau):
        """(shift_j M + tau K)^-1 rhs_j for every pair j at once; returns
        the solution and the (n2,) inner counts."""
        inner_tol = self.params.inner_tolerance
        if inner_tol <= 0.0:
            return self._vcycle(prec, self.shifts, tau, rhs), np.ones(self.n_pairs, np.int64)
        res = pcg(
            lambda w: self._shifted(self.shifts, tau, w),
            rhs,
            M=lambda r: self._vcycle(prec, self.shifts, tau, r),
            maxiter=100,
            abstol=inner_tol,  # absolute, as the reference's PRESB
            batch=True,
        )
        return res.x, res.n_iterations.cpu().numpy()

    def _presb(self, v, carry, prec, tau):
        """PRESB: x0 ~ S^-1 (v_re + v_im), x1 ~ S^-1 (v_im - l_im M x0),
        out = (x0 - x1, x1), S = (l_re + l_im) M + tau K, on a pair block or
        a plain (n2, 2, *spatial) tensor."""
        v_re, v_im = pair_component(v, 0), pair_component(v, 1)
        x0, c0 = self._inner_solve(v_re + v_im, prec, tau)
        lam = self.d_im if self.mesh is not None else self.d_im.reshape(
            (self.n_pairs,) + (1,) * self.dim)
        x1, c1 = self._inner_solve(v_im - self._shifted(1.0, 0.0, x0) * lam, prec, tau)
        return stack_pairs(x0 - x1, x1), carry + np.stack([c0, c1], axis=1)

    def pair_vmult(self, Z, tau):
        """The 2x2 real-block complex apply on the (n2, 2, *spatial) pairs
        (reference operator.h:593-666): ``[[l_re, -l_im], [l_im, l_re]] M Z
        + tau K Z``.  Unsharded, K5 on the 2 n2 lanes and a K2 mix of ``M Z``
        by the pair blocks; on the mesh, K9b per slot and the 2x2 block per
        slot — both components of a pair lie on one stage row, so no message
        crosses the stage axis."""
        if self.mesh is None:
            ms = st.mass_stiffness_apply if self.kernels else st.mass_stiffness_apply_ref
            mix = st.stage_mix if self.kernels else st.stage_mix_ref
            MZ, KZ = ms(self.fine, lane_view(Z))
            return (mix(self.lam_block, MZ) + tau * KZ).reshape(Z.shape)
        MZ, KZ = shk.sharded_mass_stiffness_apply(self.fine_level, lane_view(Z),
                                                  kernels=self.kernels)

        def block(i, j, t):
            lre, lim = self._lam_slots[i][j]
            return torch.stack([lre * t[:, 0] - lim * t[:, 1], lim * t[:, 0] + lre * t[:, 1]],
                               dim=1)

        return pair_view(MZ).map_slots(block) + tau * pair_view(KZ)

    def solve_fn(self, W_rhs, prec, tau):
        """The pair solves; returns (W, the GMRES result).  On the mesh the
        mapped right-hand side is scattered pair by pair onto the stage rows
        and the solution gathered before the back map (JAX
        complex_irk.py:230-265)."""
        mix = st.stage_mix if self.kernels else st.stage_mix_ref
        phase = self.timers.phase
        with phase("preconditioner_bc"):
            Z = pair_view(mix(self.T_inv_pairs, W_rhs))
            if self.mesh is not None:
                Z = scatter_pairs(Z, self.mesh)

        def Mop(v, carry):
            with phase("preconditioner_solver"):
                if not self.batched:
                    return self._presb(v, carry, prec, tau)
                out = self._vcycle(prec, self.shifts_lanes, tau, lane_view(v))
                return pair_view(out), carry + 1

        def Aop(v):
            with phase("system_vmult"):
                return self.pair_vmult(v, tau)

        res = gmres(
            Aop,
            Z,
            M=Mop,
            M_carry=np.zeros((self.n_pairs, 2), dtype=np.int64),
            maxiter=1000,
            abstol=1e-20,
            reltol=self.params.outer_tolerance,
            restart=self.restart,
            batch=True,
            phase=phase,
        )
        with phase("preconditioner_bc"):
            x = lane_view(res.x)
            if self.mesh is not None:
                x = gather(x, self.device)
            return mix(self.T_pairs, x), res

    def solve_step(self, u, timestep_number, t, tau):
        prec = self.prec_state(tau)
        with self.timers.phase("total"):
            with self.timers.phase("rhs"):
                W_rhs = self.rhs_fn(u, t, tau)
            with self.timers.phase("outer_solver"):
                W, res = self.solve_fn(W_rhs, prec, tau)
            with self.timers.phase("solution_update"):
                u = self.update_fn(u, W, tau)
        n_outer, carry = res.n_iterations, res.M_carry
        self.check_outer(int(n_outer.max()), "a pair GMRES lane")
        self.step_log.append(
            {
                "n_outer": int(n_outer.sum()),
                "n_inner": int(carry.sum()),
                "n_outer_pair": n_outer.tolist(),
                "n_inner_pair": carry.tolist(),
                "n_sweeps": res.n_sweeps,
                "n_restarts": res.n_restarts,
            }
        )
        self.n_outer += int(n_outer.sum())
        self.n_inner += int(carry.sum())
        # each pair's GMRES count drives the per-group time attribution
        # (reference t_prec_solver_0..9, main.cc:810-813)
        self.n_inner_stage[:n_outer.shape[0]] += n_outer
        self.after_step(timestep_number)
        return u

    def get_statistics(self, table, scaling_factor=1.0):
        super().get_statistics(table, scaling_factor)
        self.add_per_stage_times(table, scaling_factor, self.n_pairs)
