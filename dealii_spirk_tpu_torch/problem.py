"""The heat-equation benchmark problem: state, forcing, errors.

Port of ``dealii_spirk_tpu/problem.py`` (reference ``main.cc:3014-3603``).
The manufactured solution is separable, so

* the initial condition is the outer product of 1D sine samples at the
  interior nodes (nodal interpolation, reference ``main.cc:3301-3303``),
* the load vector is ``F(t) = g(t) * F0`` with the 1D factor of ``F0``
  precomputed with QGauss(p+1) (reference ``main.cc:3213-3219``),
* L2/Linf errors integrate ``(u_h - u)^2`` with QGauss(p+2) on the tensor
  quadrature grid (reference ``main.cc:3436-3469``).
"""

from __future__ import annotations

import numpy as np
import torch

from .config import Parameters
from .fem.functions import WAVE, solution_time_factor
from .fem.grid import Space, make_space
from .ops.banded import apply_dense_1d


def _outer(vecs):
    out = vecs[0]
    for v in vecs[1:]:
        out = torch.tensordot(out, v, dims=0)
    return out


class HeatProblem:
    """Device-resident problem data for one (dim, degree, refinement)."""

    def __init__(self, params: Parameters, device="cpu"):
        self.device = torch.device(device)
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

    def stage_load(self, tf: torch.Tensor) -> torch.Tensor:
        """(len(tf), *spatial) per-stage load block ``tf_i * F0``."""
        out = tf[:, None] * self._load_1d[None]
        for _ in range(self.space.dim - 1):
            out = torch.tensordot(out, self._load_1d, dims=0)
        return out

    def initial_condition(self) -> torch.Tensor:
        return self.u0

    def errors(self, u: torch.Tensor, t: float) -> tuple[float, float]:
        """(L2, Linf) error against the analytical solution at time t."""
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
