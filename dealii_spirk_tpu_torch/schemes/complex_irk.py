"""Complex-diagonalised Radau IIA — ``complex_irk`` and
``complex_irk_batched``.

Port of ``dealii_spirk_tpu/schemes/complex_irk.py`` (reference
``main.cc:1886-2375``).  The stage system is diagonalised exactly with
the complex eigendecomposition ``A^-1 = V diag(lambda) V^-1``, so there is
no outer Krylov loop over the coupled system:

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
inner CG operator are K4, and the V-cycles run K3 / K3dg / K4.  With
``kernels=False`` the same solve runs the plain torch versions.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.cuda import stencil as st
from ..solvers.gmg import gmg_reinit, vcycle
from ..solvers.krylov import gmres, pcg
from .base import RadauScheme


class ComplexIRK(RadauScheme):
    def __init__(self, problem, params, **options):
        """``options``: see ``RadauScheme``."""
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

    def _reinit(self, tau):
        # block GMG: both (re, im) components share the pair's shift
        a = self.shifts_lanes if self.batched else self.shifts
        return gmg_reinit(self.gmg, a, tau, self.dim, start=self.start)

    def _vcycle(self, prec, a, tau, r):
        return vcycle(self.gmg, prec, a, tau, r, self.dim, kernels=self.kernels)

    def _inner_solve(self, rhs, prec, tau):
        """(shift_j M + tau K)^-1 rhs_j for every pair j at once; returns
        the solution and the (n2,) inner counts."""
        inner_tol = self.params.inner_tolerance
        if inner_tol <= 0.0:
            return self._vcycle(prec, self.shifts, tau, rhs), np.ones(self.n_pairs, np.int64)
        apply = st.stencil_apply if self.kernels else st.stencil_apply_ref
        res = pcg(
            lambda w: apply(self.fine, self.shifts, tau, w),
            rhs,
            M=lambda r: self._vcycle(prec, self.shifts, tau, r),
            maxiter=100,
            abstol=inner_tol,  # absolute, as the reference's PRESB
            batch=True,
        )
        return res.x, res.n_iterations.cpu().numpy()

    def solve_fn(self, W_rhs, prec, tau):
        """The pair solves; returns (W, the GMRES result)."""
        k, fine, n2 = self.kernels, self.fine, self.n_pairs
        mix = st.stage_mix if k else st.stage_mix_ref
        ms = st.mass_stiffness_apply if k else st.mass_stiffness_apply_ref
        apply = st.stencil_apply if k else st.stencil_apply_ref
        sp = tuple(W_rhs.shape[1:])
        lanes = (2 * n2,) + sp

        def Aop(Z):
            """2x2 real-block complex apply over the (n2, 2, *spatial)
            pairs (reference operator.h:593-666)."""
            MZ, KZ = ms(fine, Z.reshape(lanes))
            return (mix(self.lam_block, MZ) + tau * KZ).reshape(Z.shape)

        if self.batched:

            def Mop(v, carry):
                out = self._vcycle(prec, self.shifts_lanes, tau, v.reshape(lanes))
                return out.reshape(v.shape), carry + 1

        else:

            def Mop(v, carry):
                """PRESB: x0 ~ S^-1 (v_re + v_im), x1 ~ S^-1 (v_im - l_im M x0),
                out = (x0 - x1, x1), S = (l_re + l_im) M + tau K."""
                x0, c0 = self._inner_solve(v[:, 0] + v[:, 1], prec, tau)
                lam = self.d_im.reshape((n2,) + (1,) * len(sp))
                x1, c1 = self._inner_solve(v[:, 1] - lam * apply(fine, 1.0, 0.0, x0), prec, tau)
                return torch.stack([x0 - x1, x1], dim=1), carry + np.stack([c0, c1], axis=1)

        Z = mix(self.T_inv_pairs, W_rhs).reshape((n2, 2) + sp)
        res = gmres(
            Aop,
            Z,
            M=Mop,
            M_carry=np.zeros((n2, 2), dtype=np.int64),
            maxiter=1000,
            abstol=1e-20,
            reltol=self.params.outer_tolerance,
            restart=self.restart,
            batch=True,
        )
        return mix(self.T_pairs, res.x.reshape(lanes)), res

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
