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
  vectors), exiting on the Givens residual estimate.

Both floor the relative tolerance at 32 eps of the dtype (the JAX
package's rule), so an f64 tolerance run in f32 cannot spin to maxiter.

The loops are plain Python: each iteration reads its stopping test on the
host.  The JAX package's adaptive 12-column first cycle and its compact
basis exist because a compiled graph is static; a dynamic loop that
allocates basis vectors as it goes gives the same iterates as one long
restart cycle without them.  GMRES keeps the small Hessenberg/Givens
arithmetic on the host in numpy at the field's dtype.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch


def _dot(a: torch.Tensor, b: torch.Tensor, batch: bool) -> torch.Tensor:
    if batch:
        return torch.sum(a * b, dim=tuple(range(1, a.ndim)))
    return torch.sum(a * b)


def _expand(s: torch.Tensor, ref: torch.Tensor, batch: bool) -> torch.Tensor:
    if batch:
        return s.reshape(s.shape + (1,) * (ref.ndim - 1))
    return s


def _eps_floor(dtype: torch.dtype) -> float:
    return 32.0 * torch.finfo(dtype).eps


class KrylovResult(NamedTuple):
    x: torch.Tensor
    n_iterations: object  # int, or (lanes,) int tensor when batched
    residual: object  # final monitored residual norm
    M_carry: object = None  # final preconditioner carry (stateful M only)
    n_restarts: int = 0  # restart boundaries that recomputed the residual


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
        x = torch.zeros_like(b)
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
        p = torch.where(keep, z + bm * p, p)
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
    x = torch.zeros_like(b)
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
) -> KrylovResult:
    """Left-preconditioned GMRES(restart) with modified Gram–Schmidt and
    Givens rotations, from x0 = 0.

    Exits on the Givens residual estimate, like deal.II: the preconditioned
    residual is recomputed only at a restart boundary that will continue.
    When ``M_carry`` is given, ``M`` has the stateful signature
    ``M(v, carry) -> (z, carry)`` and the carry is threaded through every
    preconditioner application and returned (the IRK schemes count inner
    V-cycles with it, reference ``main.cc:1176-1182``).
    """
    if M is None:
        Ms = lambda v, c: (v, c)
    elif M_carry is None:
        Ms = lambda v, c: (M(v), c)
    else:
        Ms = M
    carry = M_carry
    npdt = np.float64 if b.dtype == torch.float64 else np.float32
    f = npdt  # host scalars at the field's precision

    x = torch.zeros_like(b)
    r, carry = Ms(b, carry)
    res = f(np.sqrt(f(_dot(r, r, False).item())))
    tol = max(f(abstol), f(max(reltol, _eps_floor(b.dtype))) * res)
    it = 0
    n_restarts = 0
    while res > tol and it < maxiter:
        # one restart cycle from x with preconditioned residual r
        beta = f(np.sqrt(f(_dot(r, r, False).item())))
        V = [r / float(beta if beta > 0 else 1.0)]
        H = np.zeros((restart + 1, restart), dtype=npdt)
        g = np.zeros(restart + 1, dtype=npdt)
        g[0] = beta
        cs = np.zeros(restart, dtype=npdt)
        sn = np.zeros(restart, dtype=npdt)
        k = 0
        while res > tol and k < restart and it < maxiter:
            w, carry = Ms(A(V[k]), carry)
            hs = []
            for j in range(k + 1):
                hij = _dot(V[j], w, False)
                w = w - hij * V[j]
                hs.append(hij)
            hk1 = torch.sqrt(_dot(w, w, False))
            hs.append(hk1)
            V.append(w / torch.where(hk1 > 0, hk1, torch.ones_like(hk1)))
            hcol = torch.stack(hs).cpu().numpy().astype(npdt)
            # apply the previous rotations, then a new one annihilating
            # hcol[k+1]
            for j in range(k):
                hj, hj1 = hcol[j], hcol[j + 1]
                hcol[j] = cs[j] * hj + sn[j] * hj1
                hcol[j + 1] = -sn[j] * hj + cs[j] * hj1
            hk, hk1r = hcol[k], hcol[k + 1]
            denom = f(np.sqrt(hk * hk + hk1r * hk1r))
            c_new = hk / denom if denom > 0 else f(1.0)
            s_new = hk1r / denom if denom > 0 else f(0.0)
            hcol[k] = denom
            hcol[k + 1] = 0.0
            H[: k + 2, k] = hcol
            cs[k], sn[k] = c_new, s_new
            gk = g[k]
            g[k] = c_new * gk
            g[k + 1] = -s_new * gk
            res = f(abs(g[k + 1]))
            it += 1
            k += 1
        # back-substitution on the rotated (upper-triangular) H
        y = np.zeros(k, dtype=npdt)
        for i in range(k - 1, -1, -1):
            y[i] = (g[i] - H[i, i + 1 : k] @ y[i + 1 : k]) / H[i, i]
        dx = torch.zeros_like(x)
        for j in range(k):
            dx = dx + float(y[j]) * V[j]
        x = x + dx
        if res > tol and it < maxiter:
            # restart: recompute the preconditioned residual
            r, carry = Ms(b - A(x), carry)
            res = f(np.sqrt(f(_dot(r, r, False).item())))
            n_restarts += 1
    return KrylovResult(
        x=x, n_iterations=it, residual=float(res), M_carry=carry,
        n_restarts=n_restarts,
    )
