"""Preconditioned CG and GMRES on torch tensors.

Port of ``dealii_spirk_tpu/solvers/krylov.py``; semantics follow deal.II's
solvers as used by the reference so iteration counts are comparable:

* ``pcg``: preconditioned CG monitoring the *unpreconditioned* residual
  norm (deal.II SolverCG), stopping at
  ``||r|| <= max(abstol, reltol * ||r0||)`` (reference ``main.cc:900``,
  ``main.cc:1126-1148``).  ``batch`` runs independent systems along the
  leading axis with per-lane masks and iteration counts.
* ``gmres``: *left*-preconditioned GMRES with modified Gram–Schmidt and
  Givens rotations, restart length 28 (deal.II's default of 30 temporary
  vectors; ``COMPACT_BASIS`` above ``COMPACT_GRID_DOFS``), exiting on the
  Givens residual estimate.  ``batch`` runs independent systems along the
  leading axis as masked lanes (the complex schemes' pair solves).

Both floor the relative tolerance at 32 eps of the dtype (the JAX
package's rule), so an f64 tolerance run in f32 cannot spin to maxiter.

The loops are plain Python: each iteration reads its stopping test on the
host.  The JAX package's adaptive 12-column first cycle exists because a
compiled graph is static; a dynamic loop that allocates basis vectors as
it goes gives the same iterates as one long restart cycle without it.
GMRES keeps the small Hessenberg/Givens arithmetic on the host in numpy
at the field's dtype.  Given a ``phase`` callable (``PhaseTimers.phase``)
it times its own device vector work as ``krylov_vectors`` and that host
arithmetic, from the return of each host read to the next launch, as
``krylov_host``; the operator and the preconditioner are the caller's to
time.

The solvers touch their vectors only through arithmetic with vectors,
numbers and per-lane coefficients, ``_dot``, ``_where`` and ``_zeros_like``,
so a plain tensor and a ``ShardedBlock`` of a slot mesh
(``parallel/sharding.py``: per-slot partial sums added in a fixed order)
run through the same code, with the same one host read per iteration.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..utils.timer import no_phase


# The JAX package's huge-grid GMRES policy (krylov.py:183-193): above
# COMPACT_GRID_DOFS DoFs per stage the schemes restart every COMPACT_BASIS
# iterations instead of 28 (28 basis vectors of a refinement-8, q=4
# block are 7.4 GB in f32); solves take 4-6 outer iterations, so 12
# columns lose nothing, and a solve that runs past them warns.
COMPACT_GRID_DOFS = 8_000_000
COMPACT_BASIS = 12


def _dot(a, b, batch: bool) -> torch.Tensor:
    if not isinstance(a, torch.Tensor):
        return a.dot(b, batch)
    if batch:
        return torch.sum(a * b, dim=tuple(range(1, a.ndim)))
    return torch.sum(a * b)


def _expand(s: torch.Tensor, ref: torch.Tensor, batch: bool) -> torch.Tensor:
    if batch:
        return s.reshape(s.shape + (1,) * (ref.ndim - 1))
    return s


def _zeros_like(v):
    return torch.zeros_like(v) if isinstance(v, torch.Tensor) else v.zeros_like()


def _where(mask: torch.Tensor, a, b):
    """``a`` where the (lane-shaped) mask holds, else ``b``."""
    return torch.where(mask, a, b) if isinstance(a, torch.Tensor) else a.select(mask, b)


def _eps_floor(dtype: torch.dtype) -> float:
    return 32.0 * torch.finfo(dtype).eps


class KrylovResult(NamedTuple):
    x: torch.Tensor
    n_iterations: object  # int, or (lanes,) int tensor when batched
    residual: object  # final monitored residual norm
    M_carry: object = None  # final preconditioner carry (stateful M only)
    n_restarts: int = 0  # restart boundaries that recomputed the residual
    # operator applications inside the restart cycles: the iterations of
    # the slowest live lane, summed over cycles (== n_iterations unbatched)
    n_sweeps: int = 0


def pcg(
    A: Callable,
    b: torch.Tensor,
    *,
    M: Callable | None = None,
    x0: torch.Tensor | None = None,
    maxiter: int = 1000,
    abstol: float = 1e-20,
    reltol: float = 0.0,
    batch: bool = False,
) -> KrylovResult:
    """Preconditioned conjugate gradients (deal.II SolverCG semantics)."""
    if M is None:
        M = lambda r: r
    if x0 is None:
        x = _zeros_like(b)
        r = b
    else:
        x = x0
        r = b - A(x0)
    z = M(r)
    p = z
    rz = _dot(r, z, batch)
    rnorm = torch.sqrt(_dot(r, r, batch))
    tol = torch.clamp(max(reltol, _eps_floor(b.dtype)) * rnorm, min=abstol)
    iters = torch.zeros(rnorm.shape, dtype=torch.int64, device=b.device)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    for _k in range(maxiter):
        active = rnorm > tol
        if not bool(active.any()):
            break
        Ap = A(p)
        pAp = _dot(p, Ap, batch)
        alpha = torch.where(pAp != 0, rz / torch.where(pAp != 0, pAp, 1.0), zero)
        am = _expand(torch.where(active, alpha, zero), x, batch)
        x = x + am * p
        r = r - am * Ap
        z = M(r)
        rz_new = _dot(r, z, batch)
        beta = torch.where(rz != 0, rz_new / torch.where(rz != 0, rz, 1.0), zero)
        bm = _expand(torch.where(active, beta, zero), x, batch)
        keep = _expand(active, x, batch)
        p = _where(keep, z + bm * p, p)
        rz = torch.where(active, rz_new, rz)
        rnorm = torch.where(active, torch.sqrt(_dot(r, r, batch)), rnorm)
        iters = iters + active.to(torch.int64)
    n_it = iters if batch else int(iters)
    return KrylovResult(x=x, n_iterations=n_it, residual=rnorm)


def cg_lanczos_extremal_eigs(
    A: Callable,
    b: torch.Tensor,
    *,
    M: Callable | None = None,
    n_iterations: int = 20,
    batch: bool = False,
):
    """Estimate extremal eigenvalues of M^-1 A via CG-Lanczos: a fixed
    number of preconditioned CG iterations collecting the Lanczos
    tridiagonal from the alpha/beta coefficients, then the small symmetric
    eigenproblem (deal.II ``PreconditionChebyshev``, reference
    ``preconditioner.h:219-232``).  Returns ``(lambda_min, lambda_max)``,
    per lane when ``batch``."""
    if M is None:
        M = lambda r: r
    x = _zeros_like(b)
    r = b
    z = M(b)
    p = z
    rz = _dot(b, z, batch)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    alphas, betas = [], []
    for _k in range(n_iterations):
        Ap = A(p)
        pAp = _dot(p, Ap, batch)
        safe = torch.abs(pAp) > 1e-300
        alpha = torch.where(safe, rz / torch.where(safe, pAp, one), one)
        x = x + _expand(alpha, x, batch) * p
        r = r - _expand(alpha, r, batch) * Ap
        z = M(r)
        rz_new = _dot(r, z, batch)
        safe2 = torch.abs(rz) > 1e-300
        beta = torch.where(safe2, rz_new / torch.where(safe2, rz, one), zero)
        p = z + _expand(beta, p, batch) * p
        rz = rz_new
        alphas.append(alpha)
        betas.append(beta)
    alphas = torch.stack(alphas, dim=-1)
    betas = torch.stack(betas, dim=-1)

    # tridiagonal: diag_k = 1/alpha_k + beta_{k-1}/alpha_{k-1},
    #              offdiag_k = sqrt(beta_k)/alpha_k
    inv_a = 1.0 / alphas
    diag = inv_a + torch.cat(
        [torch.zeros_like(inv_a[..., :1]), betas[..., :-1] * inv_a[..., :-1]],
        dim=-1,
    )
    off = torch.sqrt(torch.clamp(betas[..., :-1], min=0.0)) * inv_a[..., :-1]
    T = torch.diag_embed(diag) + torch.diag_embed(off, 1) + torch.diag_embed(off, -1)
    w = torch.linalg.eigvalsh(T)
    return w[..., 0], w[..., -1]


def gmres(
    A: Callable,
    b: torch.Tensor,
    *,
    M: Callable | None = None,
    M_carry=None,
    maxiter: int = 1000,
    abstol: float = 1e-20,
    reltol: float = 0.0,
    restart: int = 28,
    batch: bool = False,
    phase: Callable = no_phase,
) -> KrylovResult:
    """Left-preconditioned GMRES(restart) with modified Gram–Schmidt and
    Givens rotations, from x0 = 0.

    Exits on the Givens residual estimate, like deal.II: the preconditioned
    residual is recomputed only at a restart boundary that will continue.
    When ``M_carry`` is given, ``M`` has the stateful signature
    ``M(v, carry) -> (z, carry)`` and the carry is threaded through every
    preconditioner application and returned (the IRK schemes count inner
    V-cycles with it, reference ``main.cc:1176-1182``).

    ``batch``: independent systems along the leading axis of ``b`` (see
    ``_gmres_lanes``); the carry is then a numpy array whose leading axis
    is the lane axis, and the counts are per lane.  Unbatched, the system
    is one lane.

    ``phase``: ``phase(name)`` gives the context in which the solver runs
    its ``krylov_vectors`` and ``krylov_host`` work (default: none).
    """
    stateful = M is not None and M_carry is not None
    if M is None:
        Ms = lambda v, c: (v, c)
    elif M_carry is None:
        Ms = lambda v, c: (M(v), c)
    else:
        Ms = M
    kw = dict(maxiter=maxiter, abstol=abstol, reltol=reltol, restart=restart, phase=phase)
    if batch:
        return _gmres_lanes(A, b, Ms, M_carry, stateful=stateful, **kw)

    def Ms_lane(v, c):
        z, c = Ms(v[0], None if c is None else c[0])
        return z[None], None if c is None else np.asarray(c)[None]

    res = _gmres_lanes(
        lambda v: A(v[0])[None], b[None], Ms_lane,
        None if M_carry is None else np.asarray(M_carry)[None], stateful=stateful, **kw,
    )
    return res._replace(
        x=res.x[0],
        n_iterations=int(res.n_iterations[0]),
        residual=float(res.residual[0]),
        M_carry=res.M_carry if M_carry is None else res.M_carry[0],
    )


def _gmres_lanes(
    A: Callable,
    b: torch.Tensor,
    Ms: Callable,
    carry,
    *,
    stateful: bool,
    maxiter: int,
    abstol: float,
    reltol: float,
    restart: int,
    phase: Callable,
) -> KrylovResult:
    """GMRES on independent systems stacked along the leading (lane) axis
    of ``b``, as the JAX package's ``gmres(batch=True)`` runs them
    (``solvers/krylov.py:290-431``).

    Every lane keeps its own tolerance, iteration count, Hessenberg and
    Givens state (host numpy arrays at the field's precision) and exits on
    its own Givens estimate.  A lane that is done stays frozen: its x stops
    changing, its carry entries stop counting.  The cycles are shared: a
    cycle runs while any lane is live, and at its end the residual is
    recomputed (one vmult and one preconditioner application for all
    lanes) when any lane goes on; the lanes that were live in that cycle
    take the recomputed residual, and its norm replaces their estimate.

    Each host read of device results (a column of the Hessenberg, the
    residual norms) closes a ``krylov_vectors`` block; the ``krylov_host``
    block that follows runs until the next launch.
    """
    npdt = np.float64 if b.dtype == torch.float64 else np.float32
    f = npdt
    lanes = b.shape[0]
    R = restart

    def norms(v):
        return np.sqrt(_dot(v, v, True).cpu().numpy().astype(npdt))

    def ex(s: np.ndarray) -> torch.Tensor:
        return _expand(torch.as_tensor(s, dtype=b.dtype, device=b.device), b, True)

    def mask_carry(new, old, active):
        if not stateful:
            return old
        act = active.reshape(active.shape + (1,) * (np.ndim(new) - 1))
        return np.where(act, new, old)

    with phase("krylov_vectors"):
        x = _zeros_like(b)
    r, carry = Ms(b, carry)
    with phase("krylov_vectors"):
        res = norms(r)
    with phase("krylov_host"):
        tol = np.maximum(f(abstol), f(max(reltol, _eps_floor(b.dtype))) * res)
        it = np.zeros(lanes, dtype=np.int64)
        n_restarts = n_sweeps = 0

    def live():
        return (res > tol) & (it < maxiter)

    while live().any():
        cycle_live = live()
        with phase("krylov_vectors"):
            beta = norms(r)
        with phase("krylov_host"):
            H = np.zeros((lanes, R + 1, R), dtype=npdt)
            g = np.zeros((lanes, R + 1), dtype=npdt)
            g[:, 0] = beta
            cs = np.zeros((lanes, R), dtype=npdt)
            sn = np.zeros((lanes, R), dtype=npdt)
            k = 0
        with phase("krylov_vectors"):
            V = [r / ex(np.where(beta > 0, beta, f(1.0)))]
        while k < R and live().any():
            active = live()
            w, carry_new = Ms(A(V[k]), carry)
            carry = mask_carry(carry_new, carry, active)
            with phase("krylov_vectors"):
                hs = []
                for j in range(k + 1):
                    hij = _dot(V[j], w, True)
                    w = w - _expand(hij, w, True) * V[j]
                    hs.append(hij)
                hk1 = torch.sqrt(_dot(w, w, True))
                hs.append(hk1)
                V.append(w / _expand(torch.where(hk1 > 0, hk1, torch.ones_like(hk1)), w, True))
                hcol = torch.stack(hs, dim=1).cpu().numpy().astype(npdt)  # (lanes, k + 2)
            with phase("krylov_host"):
                for j in range(k):
                    hj, hj1 = hcol[:, j].copy(), hcol[:, j + 1].copy()
                    hcol[:, j] = cs[:, j] * hj + sn[:, j] * hj1
                    hcol[:, j + 1] = -sn[:, j] * hj + cs[:, j] * hj1
                hk, hk1r = hcol[:, k].copy(), hcol[:, k + 1].copy()
                denom = np.sqrt(hk * hk + hk1r * hk1r)
                pos = denom > 0
                safe = np.where(pos, denom, f(1.0))
                c_new = np.where(pos, hk / safe, f(1.0))
                s_new = np.where(pos, hk1r / safe, f(0.0))
                hcol[:, k] = denom
                hcol[:, k + 1] = 0.0
                gk = g[:, k].copy()
                # frozen lanes keep their state
                H[active, : k + 2, k] = hcol[active]
                cs[active, k] = c_new[active]
                sn[active, k] = s_new[active]
                g[active, k] = (c_new * gk)[active]
                g[active, k + 1] = (-s_new * gk)[active]
                res = np.where(active, np.abs(-s_new * gk), res).astype(npdt)
                it += active
                n_sweeps += 1
                k += 1
        with phase("krylov_host"):
            # per-lane back-substitution on the rotated (upper-triangular)
            # H, over the columns with a nonzero diagonal, as the JAX
            # package sizes it: a breakdown column (w = 0, e.g. an inner
            # solve that took no iteration) drops out instead of dividing
            # by zero
            idx = np.arange(k)
            n_cols = np.sum(np.abs(H[:, idx, idx]) > 0, axis=1)
            y = np.zeros((lanes, k), dtype=npdt)
            for lane in range(lanes):
                kl = int(n_cols[lane])
                for i in range(kl - 1, -1, -1):
                    y[lane, i] = (
                        g[lane, i] - H[lane, i, i + 1 : kl] @ y[lane, i + 1 : kl]
                    ) / H[lane, i, i]
        with phase("krylov_vectors"):
            dx = _zeros_like(x)
            for j in range(int(n_cols.max(initial=0))):
                dx = dx + ex(y[:, j]) * V[j]
            x = x + dx
        if live().any():
            # restart: recompute the preconditioned residual
            Ax = A(x)
            with phase("krylov_vectors"):
                d = b - Ax
            r, carry_new = Ms(d, carry)
            carry = mask_carry(carry_new, carry, cycle_live)
            with phase("krylov_vectors"):
                rnorm = norms(r)
            with phase("krylov_host"):
                res = np.where(cycle_live, rnorm, res).astype(npdt)
                n_restarts += 1
    return KrylovResult(
        x=x, n_iterations=it, residual=res, M_carry=carry,
        n_restarts=n_restarts, n_sweeps=n_sweeps,
    )
