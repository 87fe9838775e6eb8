"""Geometric multigrid V-cycle with Chebyshev smoothing.

Port of ``dealii_spirk_tpu/solvers/gmg.py`` (the reference's
``PreconditionerGMG``, ``preconditioner.h:219-501``): global-coarsening
level hierarchy truncated at ``COARSE_SIZE_LIMIT``, Chebyshev(5) /
point-Jacobi smoothing with CG-estimated intervals on every level above
the coarsest, and an exact dense coarse solve (a precomputed inverse —
a deliberate deviation from the reference's AMG coarse V-cycle that can
only reduce iteration counts).

``vcycle`` is the stage-batched V-cycle of the JAX package's
``vcycle_canon`` on the compact (q, m, m, m) layout.  With
``kernels=True`` its smoother and residual run through the hand-written
CUDA kernels (K3 ``cheb_iter``, K4 ``stencil_apply``; on CPU tensors the
wrappers run their plain versions); with ``kernels=False`` the same
structure runs the plain torch operators.  Grid transfers are dense 1D
contractions (``apply_dense_1d``) and the coarse solve a batched dense
inverse, as the JAX package leaves both to XLA.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..fem.grid import Space
from ..ops.cuda import stencil as st
from ..ops.mass_laplace import LevelOps, apply_shifted_batched, level_ops, operator_diagonal
from ..ops.transfer import prolong, restrict
from .chebyshev import chebyshev_apply, estimate_chebyshev_range

SMOOTHER_DEGREE = 5  # reference preconditioner.h:222
SMOOTHING_RANGE = 20.0  # reference preconditioner.h:221
EIG_CG_ITERATIONS = 20  # reference preconditioner.h:223

# levels at or below this DoF count are dropped and solved exactly by the
# dense coarse solve (the JAX package's rule, gmg.py:93-98)
COARSE_SIZE_LIMIT = 1024


@dataclass(frozen=True)
class GMGData:
    """Static (tau-independent) multigrid data for one problem."""

    level_ops: tuple[LevelOps, ...]  # coarse -> fine
    prolongs: tuple[torch.Tensor, ...]  # [l]: level l -> level l+1
    coarse_mass: torch.Tensor  # dense coarsest-level dim-D mass matrix
    coarse_stiff: torch.Tensor


@dataclass(frozen=True)
class GMGPrec:
    """Shift-dependent state produced by ``gmg_reinit``: per level the
    (q, *spatial) inverse Jacobi diagonal and the (q,) Chebyshev interval,
    plus the (q, n_c, n_c) inverse of the coarse matrices."""

    inv_diags: tuple[torch.Tensor, ...]
    thetas: tuple[torch.Tensor, ...]
    deltas: tuple[torch.Tensor, ...]
    coarse_inv: torch.Tensor


def _coarse_dense(space: Space, l0: int) -> tuple[np.ndarray, np.ndarray]:
    lev = space.levels[l0]
    M1, K1 = lev.mass_dense, lev.stiff_dense
    if space.dim == 2:
        M = np.kron(M1, M1)
        K = np.kron(K1, M1) + np.kron(M1, K1)
    else:
        MM = np.kron(M1, M1)
        MK = np.kron(M1, K1) + np.kron(K1, M1)
        M = np.kron(M1, MM)
        K = np.kron(K1, MM) + np.kron(M1, MK)
    return M, K


def build_gmg_data(space: Space, dtype=torch.float64, device="cpu") -> GMGData:
    # coarsest retained level: the largest one still within the dense
    # coarse-solve budget (always keep at least the bottom level, and keep
    # the finest level out of the dense solve when there are >= 2 levels)
    l0 = 0
    for i, lev in enumerate(space.levels):
        if lev.m**space.dim <= COARSE_SIZE_LIMIT:
            l0 = i
    if l0 == len(space.levels) - 1 and len(space.levels) > 1:
        l0 -= 1
    cm, ck = _coarse_dense(space, l0)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device).contiguous()

    return GMGData(
        level_ops=tuple(level_ops(lev, dtype, device) for lev in space.levels[l0:]),
        prolongs=tuple(t(P) for P in space.prolongations[l0:]),
        coarse_mass=t(cm),
        coarse_stiff=t(ck),
    )


def default_start(shape: tuple[int, ...]) -> np.ndarray:
    """Lanczos start vector of a level: uniform on [0, 1) from a fixed
    seed, drawn anew (same seed) for every level — the distribution and
    per-level reuse of the JAX package's ``jax.random.uniform(PRNGKey(42),
    shape)``, whose bits torch cannot reproduce."""
    return np.random.default_rng(42).random(shape)


def gmg_reinit(
    gmg: GMGData,
    a: torch.Tensor,
    b: float,
    dim: int,
    *,
    start: Callable[[tuple[int, ...]], np.ndarray] | None = None,
) -> GMGPrec:
    """Build the GMG state for the stage-batched operators a_i M + b K
    (the block preconditioner, reference ``main.cc:3150-3178`` and
    ``PreconditionerGMG::reinit``, ``preconditioner.h:341-447``): per-level
    Jacobi diagonals, Chebyshev interval estimates and the coarse inverse.

    ``start(shape)`` gives each smoothed level's Lanczos start vector
    (broadcast over the stages); ``default_start`` when None.
    """
    start = start or default_start
    dtype, device = gmg.coarse_mass.dtype, gmg.coarse_mass.device
    a = torch.as_tensor(a, dtype=dtype, device=device)
    q = a.shape[0]
    one = torch.ones(q, dtype=dtype, device=device)
    inv_diags, thetas, deltas = [], [], []
    for lvl, ops in enumerate(gmg.level_ops):
        inv_diag = 1.0 / operator_diagonal(ops, a, b, dim)
        inv_diags.append(inv_diag)
        if lvl == 0:
            # the coarsest level is solved exactly (dense); no smoother
            thetas.append(one)
            deltas.append(one)
            continue
        shape = (ops.m,) * dim
        rhs = torch.as_tensor(np.array(start(shape)), dtype=dtype, device=device)
        rhs = rhs.expand((q,) + shape).contiguous()
        theta, delta = estimate_chebyshev_range(
            lambda u, ops=ops: apply_shifted_batched(ops, a, b, u, dim),
            inv_diag,
            rhs,
            n_cg_iterations=EIG_CG_ITERATIONS,
            smoothing_range=SMOOTHING_RANGE,
        )
        thetas.append(theta)
        deltas.append(delta)
    coarse = a[:, None, None] * gmg.coarse_mass[None] + b * gmg.coarse_stiff
    return GMGPrec(
        inv_diags=tuple(inv_diags),
        thetas=tuple(thetas),
        deltas=tuple(deltas),
        coarse_inv=torch.linalg.inv(coarse),
    )


def _coarse_solve(prec: GMGPrec, r: torch.Tensor) -> torch.Tensor:
    q = r.shape[0]
    x = torch.bmm(prec.coarse_inv, r.reshape(q, -1, 1))
    return x.reshape(r.shape)


def vcycle(
    gmg: GMGData,
    prec: GMGPrec,
    a: torch.Tensor,
    b: float,
    r: torch.Tensor,
    dim: int,
    *,
    kernels: bool,
) -> torch.Tensor:
    """One stage-batched V-cycle approximating (a_i M + b K)^-1 r_i.

    Per level: pre-smoothing from a zero initial guess, the residual
    ``r - A x`` restricted to the next coarser level, the coarse
    correction prolongated back, post-smoothing from the corrected guess;
    the coarsest retained level is solved exactly.  Matches deal.II's
    ``Multigrid`` as configured by the reference (one V-cycle per inner
    solve when InnerTolerance == 0, reference ``main.cc:1126-1148``).
    """
    apply_fn = st.stencil_apply if kernels else st.stencil_apply_ref
    cheb_fn = st.cheb_iter if kernels else st.cheb_iter_ref

    def smooth(l: int, rl: torch.Tensor, x0: torch.Tensor | None = None):
        ops, invd = gmg.level_ops[l], prec.inv_diags[l]
        return chebyshev_apply(
            lambda u: apply_fn(ops, a, b, u),
            lambda c1, c2, d, rr, x: cheb_fn(ops, a, b, c1, c2, d, rr, x, invd),
            invd,
            prec.thetas[l],
            prec.deltas[l],
            rl,
            x0=x0,
            degree=SMOOTHER_DEGREE,
        )

    def solve(l: int, rl: torch.Tensor) -> torch.Tensor:
        if l == 0:
            return _coarse_solve(prec, rl)
        x = smooth(l, rl)
        res = rl - apply_fn(gmg.level_ops[l], a, b, x)
        xc = solve(l - 1, restrict(gmg.prolongs[l - 1], res, dim))
        x = x + prolong(gmg.prolongs[l - 1], xc, dim)
        return smooth(l, rl, x0=x)

    return solve(len(gmg.level_ops) - 1, r)
