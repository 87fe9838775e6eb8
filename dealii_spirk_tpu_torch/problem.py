"""The heat-equation benchmark problem: state, forcing, errors.

Port of ``dealii_spirk_tpu/problem.py`` (reference ``main.cc:3014-3603``).
The manufactured solution is separable, so

* the initial condition is the outer product of 1D sine samples at the
  interior nodes (nodal interpolation, reference ``main.cc:3301-3303``),
* the load vector is ``F(t) = g(t) * F0`` with the 1D factor of ``F0``
  precomputed with QGauss(p+1) (reference ``main.cc:3213-3219``),
* L2/Linf errors integrate ``(u_h - u)^2`` with QGauss(p+2) on the tensor
  quadrature grid (reference ``main.cc:3436-3469``).

The problem owns the run's phase timers (``utils/timer.py``): its schemes
time their phases in the same object, and ``errors`` is the ``errors``
phase.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import Parameters
from .fem.functions import WAVE, rhs_time_factor, solution_time_factor
from .fem.grid import Space, make_space
from .ops.banded import apply_dense_1d
from .utils.timer import PhaseTimers


def require_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist (the
    port runs on the card unless the caller asks for the CPU, and never
    falls back to it)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the port runs on the GPU by default; "
            "pass device='cpu' (CLI: --device cpu) to run on the CPU"
        )
    return dev


def _outer(vecs):
    out = vecs[0]
    for v in vecs[1:]:
        out = torch.tensordot(out, v, dims=0)
    return out


class HeatProblem:
    """Device-resident problem data for one (dim, degree, refinement)."""

    def __init__(self, params: Parameters, device="cuda"):
        self.device = require_device(device)
        self.space: Space = make_space(
            params.dim, params.fe_degree, params.n_refinements
        )
        self.dtype = torch.float64 if params.precision == "f64" else torch.float32
        sp = self.space
        dim = sp.dim

        def t(a):
            return torch.as_tensor(a, dtype=self.dtype, device=self.device)

        self.u0 = _outer([t(np.sin(WAVE * np.pi * sp.fine.x))] * dim)
        f1 = sp.rhs_eval.T @ (sp.rhs_wq * np.sin(WAVE * np.pi * sp.rhs_xq))
        self._load_1d = t(f1)
        self._E = t(sp.err_eval)
        self._wq = t(sp.err_wq)
        self._sinq = t(np.sin(WAVE * np.pi * sp.err_xq))
        # the run's phase timers; a scheme made on this problem sets their
        # ``inner`` and times its phases in them
        self.timers = PhaseTimers(self.device)

    def stage_load(self, tf: torch.Tensor) -> torch.Tensor:
        """(len(tf), *spatial) per-stage load block ``tf_i * F0``."""
        out = tf[:, None] * self._load_1d[None]
        for _ in range(self.space.dim - 1):
            out = torch.tensordot(out, self._load_1d, dims=0)
        return out

    def rhs(self, t: float) -> torch.Tensor:
        """The load vector F(t) = g(t) F0 on the grid (JAX ``rhs``)."""
        tt = torch.tensor([t], dtype=self.dtype, device=self.device)
        return self.stage_load(rhs_time_factor(tt, self.space.dim))[0]

    def initial_condition(self) -> torch.Tensor:
        return self.u0

    def errors(self, u: torch.Tensor, t: float) -> tuple[float, float]:
        """(L2, Linf) error against the analytical solution at time t
        (the ``errors`` phase, which ends in the host's read of both)."""
        with self.timers.phase("errors"):
            dim = self.space.dim
            uq = u
            for ax in range(dim):
                uq = apply_dense_1d(self._E, uq, ax)
            tt = torch.tensor(t, dtype=self.dtype, device=self.device)
            exact = _outer([self._sinq] * dim) * solution_time_factor(tt)
            diff = uq - exact
            sq = diff * diff
            for ax in reversed(range(dim)):
                sq = torch.tensordot(sq, self._wq, dims=([ax], [0]))
            return float(torch.sqrt(sq)), float(diff.abs().max())
