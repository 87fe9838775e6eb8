"""1D Lagrange bases and quadrature on the unit interval.

Conventions follow deal.II's FE_Q / QGauss used by the reference:

* element support points are Gauss–Lobatto points (deal.II FE_Q default),
* operator & RHS quadrature is Gauss–Legendre with ``degree + 1`` points
  (reference ``main.cc:3029``),
* error quadrature uses ``degree + 2`` points (reference
  ``main.cc:3436-3469``).
"""

from __future__ import annotations

import numpy as np

from ..tables import _jacobi_nodes


def gauss_legendre_01(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Gauss–Legendre nodes/weights on [0, 1]."""
    x, w = np.polynomial.legendre.leggauss(n)
    return (x + 1.0) / 2.0, w / 2.0


def gauss_lobatto_01(degree: int) -> np.ndarray:
    """``degree + 1`` Gauss–Lobatto points on [0, 1] (FE_Q support points)."""
    if degree < 1:
        raise ValueError("degree must be >= 1")
    if degree == 1:
        return np.array([0.0, 1.0])
    interior = (_jacobi_nodes(degree - 1, 1.0, 1.0) + 1.0) / 2.0
    return np.concatenate([[0.0], interior, [1.0]])


def lagrange_matrix(nodes: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Evaluation matrix ``E[i, j] = phi_j(x_i)`` of the Lagrange basis."""
    nodes = np.asarray(nodes, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    n = len(nodes)
    E = np.ones((len(x), n))
    for j in range(n):
        for k in range(n):
            if k != j:
                E[:, j] *= (x - nodes[k]) / (nodes[j] - nodes[k])
    return E


def lagrange_deriv_matrix(nodes: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Derivative matrix ``D[i, j] = phi_j'(x_i)`` of the Lagrange basis."""
    nodes = np.asarray(nodes, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    n = len(nodes)
    D = np.zeros((len(x), n))
    for j in range(n):
        for m in range(n):
            if m == j:
                continue
            term = np.ones_like(x) / (nodes[j] - nodes[m])
            for k in range(n):
                if k != j and k != m:
                    term *= (x - nodes[k]) / (nodes[j] - nodes[k])
            D[:, j] += term
    return D
