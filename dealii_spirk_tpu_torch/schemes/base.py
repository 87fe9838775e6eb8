"""Shared scheme machinery: statistics, timers, preconditioner caching.

Port of ``dealii_spirk_tpu/schemes/base.py`` (reference
``TimeIntegrationSchemes::Interface`` + ``IRKBase``, ``main.cc:455-764``):
each scheme exposes ``solve_step`` and ``get_statistics``; phase timers
and iteration counters reset after the first timestep (preconditioner
setup exclusion, reference ``main.cc:971-973``) and statistics are
normalised per timestep.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from .. import config
from ..config import Parameters
from ..fem.functions import rhs_time_factor
from ..ops.cuda import stencil as st
from ..ops.mass_laplace import apply_stiffness
from ..parallel.mesh import SlotMesh, make_mesh
from ..parallel.sharding import canon_shardable
from ..problem import HeatProblem
from ..solvers.amg import build_amg_data
from ..solvers.gmg import build_gmg_data
from ..solvers.krylov import COMPACT_BASIS, COMPACT_GRID_DOFS
from ..tables import IRKTables, irk_tables
from ..utils.timer import PhaseTimers

GMRES_RESTART = 28  # deal.II's default basis (30 temporary vectors)


class SchemeBase:
    def __init__(self, problem: HeatProblem, params: Parameters, *,
                 kernels: bool | None = None, start=None, cheb_pair: bool | None = None,
                 phase_timers: bool = False):
        """The multigrid hierarchy of ``BlockPreconditionerType`` (GMG, or
        the plain-aggregation AMG of ``solvers/amg.py``; JAX
        ``schemes/base.py:27-43``), each level with its dense matrices in
        MatrixBased mode (``operator_mode`` "dense": every plain operator
        then takes the dense route).
        ``kernels``: run the hand-written kernels (default: when the
        configuration's operator mode on this device is "pallas";
        MatrixBased never does, as the JAX package never routes it to
        Pallas).
        ``start``: Lanczos start vectors for ``gmg_reinit``.
        ``cheb_pair``: let the unsharded kernel V-cycles take two Chebyshev
        steps per K8 launch (``gmg.vcycle``; default ``config.CHEB_PAIR``,
        off unless ``SPIRK_CHEB_PAIR=1``).
        ``phase_timers``: also time the phases inside the step (the
        system vmult, the preconditioner's basis changes and block solves,
        GMRES's vector and host work, the V-cycle's smoothing and
        transfers) and the error in place (``PhaseTimers.inner``); off,
        their columns read "-".  The timers are the problem's
        (``problem.timers``), so the error lands in the same object."""
        self.problem = problem
        self.params = params
        self.dim = problem.space.dim
        self.dtype = problem.dtype
        self.device = problem.device
        self.mode = params.operator_mode(self.device)
        if self.mode == "dense" and kernels:
            raise ValueError("MatrixBased runs the plain dense operators, not the kernels")
        self.kernels = self.mode == "pallas" if kernels is None else kernels
        build = build_amg_data if params.block_preconditioner_type == "AMG" else build_gmg_data
        self.gmg = build(problem.space, dtype=self.dtype, device=self.device,
                         with_dense=self.mode == "dense")
        self.fine = self.gmg.level_ops[-1]
        self.start = start
        self.cheb_pair = config.CHEB_PAIR if cheb_pair is None else cheb_pair
        self.timers: PhaseTimers = problem.timers
        self.timers.inner = phase_timers
        self.n_outer = 0.0
        self.n_inner = 0.0
        # per-stage inner counts for per-stage time attribution (reference
        # main.cc:810-813)
        self.n_inner_stage = np.zeros(params.irk_stages)
        # per-step solver counts of every step (never cleared)
        self.step_log: list[dict] = []
        self._tau_cached: float | None = None
        self._prec = None

    # -- preconditioner lifecycle -------------------------------------------
    def _reinit(self, tau: float):
        """Subclasses: build the tau-dependent preconditioner state."""
        raise NotImplementedError

    def prec_state(self, tau: float):
        """Lazily rebuild on time-step change (reference main.cc:823-851)."""
        if self._prec is None or self._tau_cached != tau:
            self._prec = self._reinit(tau)
            self._tau_cached = tau
        return self._prec

    # -- statistics ----------------------------------------------------------
    def clear_statistics(self) -> None:
        self.timers.clear()
        self.n_outer = 0.0
        self.n_inner = 0.0
        self.n_inner_stage = self.n_inner_stage * 0

    def after_step(self, timestep_number: int) -> None:
        if timestep_number == 1:
            self.clear_statistics()

    def get_statistics(self, table, scaling_factor: float = 1.0) -> None:
        s = max(scaling_factor, 1.0)
        for col, val in (
            ("n_outer", self.n_outer / s),
            ("n_inner", self.n_inner / s),
        ):
            # single process: min == avg == max (the reference reports the
            # spread over MPI ranks, main.cc:692-704)
            for suffix in ("min", "avg", "max"):
                table.add_value(f"{col}_{suffix}", round(val, 2))
        t = self.timers.seconds
        # a phase never timed (t_vmult / t_prec_* without phase timers)
        # reads None, printed "-", never 0
        for col, key in (
            ("t", "total"),
            ("t_rhs", "rhs"),
            ("t_solver", "outer_solver"),
            ("t_update", "solution_update"),
            ("t_vmult", "system_vmult"),
            ("t_prec_bc", "preconditioner_bc"),
            ("t_prec_solver", "preconditioner_solver"),
        ):
            table.add_value(col, None if t[key] is None else t[key] / s)
            table.set_scientific(col, True)

    def add_per_stage_times(self, table, scaling_factor: float, n_lanes: int) -> None:
        """t_prec_solver_0..9 (reference ``main.cc:810-813``): per-stage
        share of the preconditioner-solve time, attributed by the per-lane
        inner iteration counters."""
        s = max(scaling_factor, 1.0)
        total = self.timers.seconds["preconditioner_solver"]
        counts = np.asarray(self.n_inner_stage, dtype=float)
        if counts.sum() > 0:
            shares = counts / counts.sum()
        else:
            shares = np.zeros_like(counts)
            shares[:n_lanes] = 1.0 / max(n_lanes, 1)
        for i in range(10):
            if total is None:
                v = None
            else:
                v = float(total / s * shares[i]) if i < len(shares) else 0.0
            table.add_value(f"t_prec_solver_{i}", v)
            table.set_scientific(f"t_prec_solver_{i}", True)

    # -- interface -----------------------------------------------------------
    def solve_step(self, u, timestep_number: int, t: float, tau: float):
        raise NotImplementedError


class RadauScheme(SchemeBase):
    """What the Radau IIA schemes share (``irk``, ``complex_irk`` and their
    batched forms): the Butcher data, the huge-grid GMRES basis, the rhs ``A^-1 (F - K u)`` and the b-weighted update."""

    def __init__(self, problem: HeatProblem, params: Parameters, *,
                 tables: IRKTables | None = None, **options):
        """``tables``: Butcher/diagonalisation tables (default: computed).
        ``options``: see ``SchemeBase``."""
        super().__init__(problem, params, **options)
        self.q = params.irk_stages
        self.tables = tables if tables is not None else irk_tables(self.q)
        self.A_inv = self.tensor(self.tables.A_inv)
        self.b_vec, self.c_vec = self.tensor(self.tables.b), self.tensor(self.tables.c)
        # the JAX package's huge-grid GMRES policy (schemes/irk.py:116)
        self.compact = self.fine.m**self.dim > COMPACT_GRID_DOFS
        self.restart = COMPACT_BASIS if self.compact else GMRES_RESTART

    def fit_mesh(self, mesh: SlotMesh | None, n_stage: int) -> SlotMesh:
        """The slot mesh of a stage-parallel scheme: ``mesh``, or one slot
        per stage row on the problem's device.  Where the fine level does
        not split over its space axis (2D, or a z extent that
        ``canon_shardable`` refuses) the mesh narrows to its first space
        column with a RuntimeWarning; a field is never gathered to run it
        whole."""
        if mesh is None:
            mesh = make_mesh(n_stage, devices=[self.device] * n_stage)
        fine, dim = self.fine, self.dim
        if mesh.n_space > 1 and not canon_shardable((fine.m,) * dim, fine.p, dim, mesh.n_space):
            warnings.warn(
                f"the {dim}D fine level (m={fine.m}, degree {fine.p}) does not split "
                f"over {mesh.n_space} space slots: running on the mesh's first space "
                f"column, a ({mesh.n_stage}, 1) mesh",
                RuntimeWarning,
                stacklevel=5,
            )
            mesh = mesh.first_space_column()
        return mesh

    def tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=self.dtype, device=self.device)

    def stage_rhs(self, u, t, tau):
        """R_i = F(t + (c_i - 1) tau) - K u as a (q, *spatial) block."""
        tf = stage_times_factor(self.c_vec, t, tau, self.dim)
        W = self.problem.stage_load(tf)
        return W - apply_stiffness(self.fine, u, self.dim)[None]

    def rhs_fn(self, u, t, tau):
        # the A^-1 mix of the rhs stays the plain GEMM (once per step)
        return st.stage_mix_ref(self.A_inv, self.stage_rhs(u, t, tau))

    def update_fn(self, u, W, tau):
        return u + tau * torch.tensordot(self.b_vec, W, dims=1)

    def check_outer(self, n_outer: int, what: str) -> None:
        """Abort on non-convergence (reference main.cc:927-930) and warn
        when the compact basis restarted where deal.II's would not."""
        if n_outer >= 1000:
            raise RuntimeError(f"{what} did not converge within 1000 iterations")
        if self.compact and n_outer > self.restart:
            warnings.warn(
                f"{what} took {n_outer} iterations — beyond the "
                f"{self.restart}-column compact basis used at this grid size, "
                "so a restart fired where deal.II's 30-vector basis would "
                "not; iteration counts may diverge from the reference here",
                RuntimeWarning,
                stacklevel=3,
            )


def stage_times_factor(c_vec: torch.Tensor, t: float, tau: float, dim: int) -> torch.Tensor:
    """Per-stage forcing time factors g(t + (c_i - 1) tau) (reference
    ``main.cc:867-869``)."""
    return rhs_time_factor(t + (c_vec - 1.0) * tau, dim)
