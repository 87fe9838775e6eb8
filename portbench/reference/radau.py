"""Radau IIA Butcher tables from their definition (Hairer and Wanner,
Solving ODEs II, IV.5): the q collocation nodes are the roots of
P_q(2c - 1) - P_{q-1}(2c - 1), the last one c_q = 1; A[i, j] is the
integral of the j-th Lagrange polynomial on the nodes from 0 to c_i; b is
A's last row.  numpy, float64.
"""

from __future__ import annotations

import numpy as np
from numpy.polynomial import legendre
from numpy.polynomial import polynomial as poly


def radau_iia(q: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(A, b, c) of the q-stage Radau IIA method."""
    series = np.zeros(q + 1)
    series[q], series[q - 1] = 1.0, -1.0
    c = np.sort((legendre.legroots(series).real + 1.0) / 2.0)
    c[-1] = 1.0
    A = np.empty((q, q))
    for j in range(q):
        others = np.delete(c, j)
        lj = poly.polyfromroots(others) / np.prod(c[j] - others)
        integral = poly.polyint(lj)
        A[:, j] = poly.polyval(c, integral)
    return A, A[-1].copy(), c
