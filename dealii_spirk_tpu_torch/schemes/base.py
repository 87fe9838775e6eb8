"""Shared scheme machinery: statistics, timers, preconditioner caching.

Port of ``dealii_spirk_tpu/schemes/base.py`` (reference
``TimeIntegrationSchemes::Interface`` + ``IRKBase``, ``main.cc:455-764``):
each scheme exposes ``solve_step`` and ``get_statistics``; phase timers
and iteration counters reset after the first timestep (preconditioner
setup exclusion, reference ``main.cc:971-973``) and statistics are
normalised per timestep.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import Parameters
from ..fem.functions import rhs_time_factor
from ..problem import HeatProblem
from ..solvers.gmg import build_gmg_data
from ..utils.timer import PhaseTimers


class SchemeBase:
    def __init__(self, problem: HeatProblem, params: Parameters):
        if params.block_preconditioner_type == "AMG":
            raise NotImplementedError(
                "BlockPreconditionerType AMG is not ported yet (ROADMAP "
                "Queue 1 item 14); use GMG"
            )
        self.problem = problem
        self.params = params
        self.dim = problem.space.dim
        self.dtype = problem.dtype
        self.device = problem.device
        self.gmg = build_gmg_data(problem.space, dtype=self.dtype, device=self.device)
        self.fine = self.gmg.level_ops[-1]
        self.timers = PhaseTimers(self.device)
        self.n_outer = 0.0
        self.n_inner = 0.0
        # per-stage inner counts for per-stage time attribution (reference
        # main.cc:810-813)
        self.n_inner_stage = np.zeros(params.irk_stages)
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
        # a phase never timed (the replayed t_vmult / t_prec_* pieces are
        # not ported) reads None, printed "-", never 0
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


def stage_times_factor(c_vec: torch.Tensor, t: float, tau: float, dim: int) -> torch.Tensor:
    """Per-stage forcing time factors g(t + (c_i - 1) tau) (reference
    ``main.cc:867-869``)."""
    return rhs_time_factor(t + (c_vec - 1.0) * tau, dim)
