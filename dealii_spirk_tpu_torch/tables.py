"""Radau IIA Butcher tables and their (real / complex) diagonalizations.

The reference ships these as pre-generated text files (``tables/*.txt``)
produced by an Octave script (reference ``tables/irk_ev.m:1-73``) and loads
them at runtime (reference ``main.cc:599-656``).  Here we *generate* them
from first principles with numpy so any stage count is supported without
data files:

* Radau IIA collocation nodes: interior nodes are the roots of the Jacobi
  polynomial P_{s-1}^{(1,0)} mapped to (0,1), plus the right endpoint 1
  (computed via Golub–Welsch, i.e. eigenvalues of the Jacobi tridiagonal —
  numerically robust for all s we care about).
* Butcher matrix A from the collocation conditions
  ``A[i,j] = \\int_0^{c_i} \\ell_j(t) dt`` evaluated with Gauss–Legendre
  quadrature (no ill-conditioned Vandermonde solves).
* ``b`` is the last row of A (Radau IIA is stiffly accurate) and
  ``A_inv = A^{-1}``.
* Real "diagonalization" used by the ``irk``/``spirk`` preconditioner
  (reference ``tables/irk_ev.m:33-50``): factor ``A_inv = L @ U`` with U
  *unit* upper-triangular (Crout), then eigendecompose the lower-triangular
  L exactly: its eigenvalues are its diagonal (all real and positive) and
  its eigenvectors follow from forward substitution.  The preconditioner
  ``T diag(D) T^{-1} = L`` then approximates ``A_inv`` up to the unit
  upper-triangular factor.
* Complex diagonalization used by the ``complex_*`` schemes (reference
  ``tables/irk_ev.m:52-72``): a true eigendecomposition of ``A_inv``,
  eigenpairs sorted by descending |lambda|^2 with each conjugate pair
  adjacent and the +imag member first.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np


# ---------------------------------------------------------------------------
# orthogonal-polynomial machinery (Golub–Welsch)
# ---------------------------------------------------------------------------


def _jacobi_nodes(n: int, alpha: float, beta: float) -> np.ndarray:
    """Roots of the Jacobi polynomial P_n^{(alpha,beta)} on [-1, 1]."""
    if n == 0:
        return np.zeros(0)
    k = np.arange(n, dtype=np.float64)
    ab = alpha + beta
    # three-term recurrence coefficients of monic Jacobi polynomials
    with np.errstate(divide="ignore", invalid="ignore"):
        a = (beta**2 - alpha**2) / ((2 * k + ab) * (2 * k + ab + 2))
    if ab == 0.0 or ab == -1.0:  # pragma: no cover - not hit for (1,0)
        a[0] = (beta - alpha) / (ab + 2)
    kk = np.arange(1, n, dtype=np.float64)
    bsq = (
        4
        * kk
        * (kk + alpha)
        * (kk + beta)
        * (kk + ab)
        / ((2 * kk + ab) ** 2 * (2 * kk + ab + 1) * (2 * kk + ab - 1))
    )
    J = np.diag(a) + np.diag(np.sqrt(bsq), 1) + np.diag(np.sqrt(bsq), -1)
    return np.sort(np.linalg.eigvalsh(J))


def radau_iia_nodes(n_stages: int) -> np.ndarray:
    """Radau IIA collocation nodes c_1 < ... < c_s = 1 on (0, 1]."""
    if n_stages < 1:
        raise ValueError("need at least one stage")
    interior = (_jacobi_nodes(n_stages - 1, 1.0, 0.0) + 1.0) / 2.0
    return np.concatenate([interior, [1.0]])


def _lagrange_eval(nodes: np.ndarray, j: int, x: np.ndarray) -> np.ndarray:
    """Evaluate the j-th Lagrange basis polynomial for ``nodes`` at ``x``."""
    result = np.ones_like(x)
    for k in range(len(nodes)):
        if k != j:
            result = result * (x - nodes[k]) / (nodes[j] - nodes[k])
    return result


def radau_iia(n_stages: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Return the Radau IIA Butcher data ``(A, b, c)``.

    ``A[i, j] = \\int_0^{c_i} \\ell_j(t) dt`` (collocation), ``b = A[-1]``
    (stiffly accurate).  Matches the reference's ``tables/A{q}.txt`` /
    ``b_vec_{q}.txt`` / ``c_vec_{q}.txt``.
    """
    c = radau_iia_nodes(n_stages)
    # Gauss-Legendre rule, exact for polynomials of degree <= 2*ngl-1; the
    # Lagrange bases have degree s-1 so ngl = s is already exact.
    xg, wg = np.polynomial.legendre.leggauss(n_stages + 2)
    A = np.zeros((n_stages, n_stages))
    for i in range(n_stages):
        # map [-1,1] -> [0, c_i]
        t = 0.5 * c[i] * (xg + 1.0)
        w = 0.5 * c[i] * wg
        for j in range(n_stages):
            A[i, j] = np.dot(w, _lagrange_eval(c, j, t))
    b = A[-1].copy()
    return A, b, c


# ---------------------------------------------------------------------------
# diagonalizations
# ---------------------------------------------------------------------------


def _lu_unit_upper(B: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Crout factorization ``B = L @ U`` (L general lower, U *unit* upper).

    No pivoting, mirroring ``lu(sparse(Ainv.'), 0)`` in the reference's
    ``tables/irk_ev.m:33-35`` (which computes the Doolittle factorization of
    ``A_inv^T`` and transposes).
    """
    n = B.shape[0]
    L = np.zeros_like(B)
    U = np.eye(n, dtype=B.dtype)
    for j in range(n):
        for i in range(j, n):
            L[i, j] = B[i, j] - L[i, :j] @ U[:j, j]
        for k in range(j + 1, n):
            U[j, k] = (B[j, k] - L[j, :j] @ U[:j, k]) / L[j, j]
    return L, U


def _eig_lower_triangular(L: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Exact eigendecomposition of a lower-triangular matrix.

    Eigenvalues are the diagonal; the eigenvector for ``lambda_k = L[k,k]``
    has zeros above k, one at k, and forward-substituted entries below.
    Columns are normalized to unit 2-norm (Octave ``eig`` convention, see
    reference ``tables/T{q}.txt``).
    """
    n = L.shape[0]
    d = np.diag(L).copy()
    V = np.zeros_like(L)
    for k in range(n):
        V[k, k] = 1.0
        for i in range(k + 1, n):
            denom = d[k] - L[i, i]
            if abs(denom) < 1e-14 * max(abs(d[k]), 1.0):  # pragma: no cover
                raise np.linalg.LinAlgError("repeated eigenvalue in L factor")
            V[i, k] = (L[i, k:i] @ V[k:i, k]) / denom
        V[:, k] /= np.linalg.norm(V[:, k])
    return d, V


@dataclass(frozen=True)
class IRKTables:
    """All stage-coupling data for an s-stage Radau IIA method.

    Field-by-field parity with the reference's table files
    (``tables/{A,A_inv,T,T_inv,L}{q}.txt``, ``tables/{b,c,D}_vec_*{q}.txt``
    and the complex set ``tables/{T,T_inv}_{re,im}{q}.txt``,
    ``tables/D_vec_{re,im}_{q}.txt``).
    """

    n_stages: int
    A: np.ndarray
    A_inv: np.ndarray
    b: np.ndarray
    c: np.ndarray
    # real factor-diagonalization (irk / spirk preconditioner)
    L: np.ndarray  # lower-triangular factor of A_inv (reference L{q}.txt)
    T: np.ndarray
    T_inv: np.ndarray
    D: np.ndarray  # real, positive eigenvalues of L, descending
    # complex eigendecomposition (complex_* schemes)
    T_re: np.ndarray
    T_im: np.ndarray
    T_inv_re: np.ndarray
    T_inv_im: np.ndarray
    D_re: np.ndarray
    D_im: np.ndarray


def _complex_diagonalization(A_inv: np.ndarray):
    w, V = np.linalg.eig(A_inv)
    # sort by descending |lambda|^2, matching `sort(-diag(D*D'))` in the
    # reference tables/irk_ev.m:57; stable so conjugate pairs stay adjacent
    order = np.argsort(-(w * w.conj()).real, kind="stable")
    w = w[order]
    V = V[:, order]
    s = len(w)
    # canonical pair orientation: +imag first within each conjugate pair
    for i in range(0, s - 1, 2):
        if abs(w[i].imag) > 1e-12 and w[i].imag < 0:
            w[[i, i + 1]] = w[[i + 1, i]]
            V[:, [i, i + 1]] = V[:, [i + 1, i]]
    for i in range(0, s - 1, 2):
        if not np.isclose(w[i].conj(), w[i + 1], rtol=1e-8, atol=1e-10):
            raise np.linalg.LinAlgError(
                "conjugate eigenpairs of A_inv are not adjacent"
            )
    # force exact conjugate symmetry of the eigenvector columns so that the
    # downstream "solve one pair member, reconstruct both" trick
    # (reference main.cc:2216-2225) is exact
    for i in range(0, s - 1, 2):
        if abs(w[i].imag) > 1e-12:
            V[:, i + 1] = V[:, i].conj()
            w[i + 1] = w[i].conj()
    V_inv = np.linalg.inv(V)
    return w, V, V_inv


@functools.lru_cache(maxsize=None)
def irk_tables(n_stages: int) -> IRKTables:
    """Compute (and cache) all tables for an ``n_stages``-stage Radau IIA.

    Prefers the native C++ core (long-double precision,
    ``native/fem_core.cc``) with this numpy implementation as fallback;
    the complex eigendecomposition always runs in numpy.
    """
    from .native import core

    nc = core()
    if nc is not None:
        t = nc.radau_tables(n_stages)
        A, b, c = t["A"], t["b"], t["c"]
        A_inv, L = t["A_inv"], t["L"]
        d, V, T_inv = t["D"], t["T"], t["T_inv"]
    else:
        A, b, c = radau_iia(n_stages)
        A_inv = np.linalg.inv(A)
        L, _U = _lu_unit_upper(A_inv)
        d, V = _eig_lower_triangular(L)
        order = np.argsort(-d, kind="stable")  # descending, cf. D_vec_q.txt
        d = d[order]
        V = V[:, order]
        T_inv = np.linalg.inv(V)

    if nc is not None:
        try:
            ct = nc.complex_tables(A_inv)
            w = ct["D_re"] + 1j * ct["D_im"]
            Vc = ct["T_re"] + 1j * ct["T_im"]
            Vc_inv = ct["T_inv_re"] + 1j * ct["T_inv_im"]
        except RuntimeError:
            w, Vc, Vc_inv = _complex_diagonalization(A_inv)
    else:
        w, Vc, Vc_inv = _complex_diagonalization(A_inv)

    return IRKTables(
        n_stages=n_stages,
        A=A,
        A_inv=A_inv,
        b=b,
        c=c,
        L=L,
        T=V,
        T_inv=T_inv,
        D=d,
        T_re=Vc.real.copy(),
        T_im=Vc.imag.copy(),
        T_inv_re=Vc_inv.real.copy(),
        T_inv_im=Vc_inv.imag.copy(),
        D_re=w.real.copy(),
        D_im=w.imag.copy(),
    )
