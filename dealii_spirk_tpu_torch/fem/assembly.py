"""1D FEM assembly on the uniform unit-interval mesh.

Everything the dim-dimensional operators need factorizes into 1D data:
the global mass/stiffness matrices of the tensor-product Q_p space are
Kronecker products/sums of the 1D matrices assembled here (this replaces
the reference's matrix-free cell loop, reference ``operator.h:379-451``,
and its Trilinos assembled path, reference ``operator.h:104-246``).

Matrices are stored *banded*: ``band[p + k, i] = Op[i, i + k]`` for offsets
``k in [-p, p]`` (half-bandwidth = element degree on the interior-node
grid), with out-of-range entries zero.  This is exactly the layout the
roll-and-scale stencil apply consumes (see ``ops/banded.py``).
"""

from __future__ import annotations

import numpy as np

from .basis import (
    gauss_legendre_01,
    gauss_lobatto_01,
    lagrange_deriv_matrix,
    lagrange_matrix,
)


def local_matrices(degree: int) -> tuple[np.ndarray, np.ndarray]:
    """Reference-cell mass and stiffness matrices on [0, 1].

    Uses QGauss(degree + 1) like the reference (``main.cc:3029``); this is
    exact for the affine cells of the hypercube mesh.  Scale mass by ``h``
    and stiffness by ``1/h`` for a cell of width ``h``.
    """
    nodes = gauss_lobatto_01(degree)
    xq, wq = gauss_legendre_01(degree + 1)
    phi = lagrange_matrix(nodes, xq)
    dphi = lagrange_deriv_matrix(nodes, xq)
    mass = phi.T @ (wq[:, None] * phi)
    stiff = dphi.T @ (wq[:, None] * dphi)
    return mass, stiff


def assemble_band_1d(
    n_cells: int, degree: int, local: np.ndarray, scale: float
) -> np.ndarray:
    """Assemble a global 1D operator in banded form on *interior* nodes.

    The full 1D mesh has ``n_cells * degree + 1`` nodes; homogeneous
    Dirichlet conditions remove the two endpoint nodes (the reference keeps
    them as identity rows via constraints, reference ``operator.h:308-309``
    — on the tensor grid, dropping them is equivalent and cheaper).

    Returns ``band`` of shape ``(2 * degree + 1, m)`` with
    ``m = n_cells * degree - 1``.
    """
    p = degree
    n = n_cells * p + 1
    band_full = np.zeros((2 * p + 1, n))
    for i in range(p + 1):
        for j in range(p + 1):
            k = j - i
            # rows o+i for every cell offset o = c*p
            rows = np.arange(n_cells) * p + i
            np.add.at(band_full[p + k], rows, local[i, j] * scale)
    # interior restriction: global row r = i + 1, column r + k must also be
    # an interior node (1 <= r + k <= n - 2)
    m = n - 2
    band = np.zeros((2 * p + 1, m))
    for k in range(-p, p + 1):
        i = np.arange(m)
        valid = (i + 1 + k >= 1) & (i + 1 + k <= n - 2)
        band[p + k, valid] = band_full[p + k, i[valid] + 1]
    return band


def band_to_dense(band: np.ndarray) -> np.ndarray:
    """Expand a banded 1D operator into a dense (m, m) matrix."""
    p = (band.shape[0] - 1) // 2
    m = band.shape[1]
    A = np.zeros((m, m))
    for k in range(-p, p + 1):
        for i in range(m):
            j = i + k
            if 0 <= j < m:
                A[i, j] = band[p + k, i]
    return A


def interior_nodes_1d(n_cells: int, degree: int) -> np.ndarray:
    """Coordinates of the interior global nodes (Gauss–Lobatto layout)."""
    h = 1.0 / n_cells
    support = gauss_lobatto_01(degree)
    xs = (np.arange(n_cells)[:, None] + support[None, :-1]) * h
    full = np.concatenate([xs.ravel(), [1.0]])
    return full[1:-1]


def evaluation_operator(
    n_cells: int, degree: int, n_q: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Interior-nodal -> quadrature-point evaluation.

    Returns ``(E, xq, wq)`` where ``E`` has shape
    ``(n_cells * n_q, m)``: values of the interior global basis functions at
    the tensor quadrature points, plus the global quadrature coordinates and
    weights.  Used for RHS assembly (QGauss(p+1), reference
    ``main.cc:3213-3219``) and error integration (QGauss(p+2), reference
    ``main.cc:3436-3469``).
    """
    p = degree
    h = 1.0 / n_cells
    n = n_cells * p + 1
    xq_ref, wq_ref = gauss_legendre_01(n_q)
    support = gauss_lobatto_01(p)
    phi = lagrange_matrix(support, xq_ref)  # (n_q, p+1)
    E_full = np.zeros((n_cells * n_q, n))
    xq = np.zeros(n_cells * n_q)
    wq = np.zeros(n_cells * n_q)
    for c in range(n_cells):
        rows = slice(c * n_q, (c + 1) * n_q)
        cols = slice(c * p, c * p + p + 1)
        E_full[rows, cols] = phi
        xq[rows] = (c + xq_ref) * h
        wq[rows] = wq_ref * h
    return E_full[:, 1:-1], xq, wq


def prolongation_1d(n_cells_coarse: int, degree: int) -> np.ndarray:
    """1D interior-node prolongation from ``n_cells_coarse`` to ``2x`` cells.

    Q_p spaces on nested uniform meshes are nested, so prolongation is
    plain interpolation: ``P[i, j] = phi_j^coarse(x_i^fine)`` (the
    tensor-grid equivalent of deal.II's MGTransferGlobalCoarsening
    embedding used at reference ``preconditioner.h:236-340``).
    Restriction is the transpose.
    """
    p = degree
    nf = 2 * n_cells_coarse
    x_fine_full = np.concatenate(
        [
            (
                (np.arange(nf)[:, None] + gauss_lobatto_01(p)[None, :-1])
                / nf
            ).ravel(),
            [1.0],
        ]
    )
    support = gauss_lobatto_01(p)
    hc = 1.0 / n_cells_coarse
    n_fine = nf * p + 1
    n_coarse = n_cells_coarse * p + 1
    P_full = np.zeros((n_fine, n_coarse))
    for i, x in enumerate(x_fine_full):
        c = min(int(x / hc), n_cells_coarse - 1)
        xi = x / hc - c
        vals = lagrange_matrix(support, np.array([xi]))[0]
        P_full[i, c * p : c * p + p + 1] += vals
    # interpolation writes each fine node once; the += above would double
    # count fine nodes shared by coarse-cell boundaries only if xi lands on
    # both cells, which the floor() above prevents.
    return P_full[1:-1, 1:-1]
