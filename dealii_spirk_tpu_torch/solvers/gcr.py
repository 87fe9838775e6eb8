"""Preconditioned GCR (generalized conjugate residual).

Port of ``dealii_spirk_tpu/solvers/gcr.py`` (the reference's hand-written
``SolverGCR``, ``main.cc:77-171``, present as an alternative to GMRES
behind ``if (false)`` switches at ``main.cc:906/1365/2192/2746``):
right-preconditioned, explicit orthogonalization of the A-images of the
search directions, residual monitored in the unpreconditioned norm, fixed
basis size (GCRmaxit = 40, no restart).  A Python loop with one host read
of the residual per iteration, as ``pcg``; unbatched, as the JAX
package's.
"""

from __future__ import annotations

from typing import Callable

import torch

from .krylov import KrylovResult


def gcr(
    A: Callable,
    b: torch.Tensor,
    *,
    M: Callable | None = None,
    x0: torch.Tensor | None = None,
    maxiter: int = 40,
    abstol: float = 1e-20,
    reltol: float = 0.0,
) -> KrylovResult:
    if M is None:
        M = lambda r: r
    if x0 is None:
        x = torch.zeros_like(b)
        p = -b
    else:
        x = x0
        p = A(x0) - b  # the reference works with the negated residual

    res = torch.sqrt(torch.sum(p * p))
    tol = max(abstol, reltol * float(res))
    H, Hd, Hn = [], [], []  # A-images, directions, their squared norms
    it = 0
    while float(res) > tol and it < maxiter:
        search = M(p)
        Asearch = A(search)
        for h, hd, hn in zip(H, Hd, Hn):
            t = torch.sum(h * Asearch) / hn
            Asearch = Asearch - t * h
            search = search - t * hd
        nA = torch.sum(Asearch * Asearch)
        safe = torch.where(nA > 0, nA, torch.ones_like(nA))  # a zero direction stores 1
        H.append(Asearch)
        Hd.append(search)
        Hn.append(safe)
        c = torch.sum(Asearch * p) / safe
        x = x - c * search
        p = p - c * Asearch
        res = torch.sqrt(torch.sum(p * p))
        it += 1
    return KrylovResult(x=x, n_iterations=it, residual=res)
