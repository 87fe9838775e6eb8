"""The 1D finite-element data of the heat-equation benchmark, worked out
from the problem's statement alone (arXiv:2209.06700 §5; deal.II's FE_Q
and QGauss): continuous degree-p Lagrange elements on Gauss-Lobatto support
points over a uniform mesh of the unit interval, homogeneous Dirichlet
nodes removed, mass and stiffness integrated with p + 1 Gauss points
(exact on affine cells), and the load of the manufactured forcing with the
same rule.  numpy, float64.
"""

from __future__ import annotations

import numpy as np
from numpy.polynomial import legendre

WAVE = 2.0  # sin(2 pi x) in every direction


def support_points(p: int) -> np.ndarray:
    """p + 1 Gauss-Lobatto points on [0, 1]: the ends and the roots of
    the derivative of the Legendre polynomial of degree p."""
    inner = legendre.Legendre.basis(p).deriv().roots() if p > 1 else np.array([])
    return (np.concatenate([[-1.0], np.sort(inner.real), [1.0]]) + 1.0) / 2.0


def gauss(n: int) -> tuple[np.ndarray, np.ndarray]:
    x, w = legendre.leggauss(n)
    return (x + 1.0) / 2.0, w / 2.0


def lagrange(nodes: np.ndarray, x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(values, derivatives) of the Lagrange basis on ``nodes`` at ``x``,
    each (len(x), len(nodes))."""
    n = len(nodes)
    val = np.empty((len(x), n))
    der = np.empty((len(x), n))
    for j in range(n):
        others = np.delete(nodes, j)
        den = np.prod(nodes[j] - others)
        fac = x[:, None] - others[None, :]
        val[:, j] = np.prod(fac, axis=1) / den
        der[:, j] = sum(np.prod(np.delete(fac, k, axis=1), axis=1)
                        for k in range(n - 1)) / den
    return val, der


class Interval:
    """Degree-p elements on 2^refinement cells: the interior nodes ``x``,
    dense mass ``M`` and stiffness ``K`` (m x m, m = 2^r p - 1) and the
    load ``f`` of sin(2 pi x)."""

    def __init__(self, p: int, refinement: int):
        cells = 2**refinement
        h = 1.0 / cells
        nodes = support_points(p)
        xq, wq = gauss(p + 1)
        phi, dphi = lagrange(nodes, xq)
        m_loc = h * phi.T @ (wq[:, None] * phi)
        k_loc = dphi.T @ (wq[:, None] * dphi) / h
        n = cells * p + 1
        M = np.zeros((n, n))
        K = np.zeros((n, n))
        f = np.zeros(n)
        x = np.zeros(n)
        for c in range(cells):
            sl = slice(c * p, c * p + p + 1)
            M[sl, sl] += m_loc
            K[sl, sl] += k_loc
            x[sl] = (c + nodes) * h
            f[sl] += h * phi.T @ (wq * np.sin(WAVE * np.pi * (c + xq) * h))
        inner = slice(1, n - 1)
        self.p, self.refinement, self.m = p, refinement, n - 2
        self.x = x[inner]
        self.M = M[inner, inner]
        self.K = K[inner, inner]
        self.f = f[inner]
