"""ctypes bindings for the native C++ setup core (``native/fem_core.cc``).

Loads ``native/libspirk_fem.so``; if absent, attempts a one-shot ``make``
build.  Every entry point has a pure-numpy fallback in ``fem/`` /
``tables.py`` — callers use :func:`core` and treat ``None`` as "fall back".
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libspirk_fem.so")

_DP = ctypes.POINTER(ctypes.c_double)


def _as_dp(a: np.ndarray):
    return a.ctypes.data_as(_DP)


class NativeCore:
    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        for name, argtypes in {
            "spirk_gauss_legendre": (ctypes.c_int, _DP, _DP),
            "spirk_gauss_lobatto": (ctypes.c_int, _DP),
            "spirk_local_matrices": (ctypes.c_int, _DP, _DP),
            "spirk_assemble_band_1d": (
                ctypes.c_int,
                ctypes.c_int,
                _DP,
                ctypes.c_double,
                _DP,
            ),
            "spirk_prolongation_1d": (ctypes.c_int, ctypes.c_int, _DP),
            "spirk_radau_tables": (
                ctypes.c_int,
                _DP,
                _DP,
                _DP,
                _DP,
                _DP,
                _DP,
                _DP,
                _DP,
            ),
            "spirk_complex_tables": (
                ctypes.c_int,
                _DP,
                _DP,
                _DP,
                _DP,
                _DP,
                _DP,
                _DP,
            ),
        }.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int

    def gauss_legendre(self, n: int):
        x = np.zeros(n)
        w = np.zeros(n)
        if self._lib.spirk_gauss_legendre(n, _as_dp(x), _as_dp(w)):
            raise RuntimeError("native gauss_legendre failed")
        return x, w

    def gauss_lobatto(self, degree: int):
        p = np.zeros(degree + 1)
        if self._lib.spirk_gauss_lobatto(degree, _as_dp(p)):
            raise RuntimeError("native gauss_lobatto failed")
        return p

    def local_matrices(self, degree: int):
        n = degree + 1
        mass = np.zeros((n, n))
        stiff = np.zeros((n, n))
        if self._lib.spirk_local_matrices(degree, _as_dp(mass), _as_dp(stiff)):
            raise RuntimeError("native local_matrices failed")
        return mass, stiff

    def assemble_band_1d(self, n_cells, degree, local, scale):
        local = np.ascontiguousarray(local, dtype=np.float64)
        m = n_cells * degree - 1
        band = np.zeros((2 * degree + 1, m))
        if self._lib.spirk_assemble_band_1d(
            n_cells, degree, _as_dp(local), float(scale), _as_dp(band)
        ):
            raise RuntimeError("native assemble_band_1d failed")
        return band

    def prolongation_1d(self, n_cells_coarse, degree):
        mf = 2 * n_cells_coarse * degree - 1
        mc = n_cells_coarse * degree - 1
        P = np.zeros((mf, mc))
        if self._lib.spirk_prolongation_1d(n_cells_coarse, degree, _as_dp(P)):
            raise RuntimeError("native prolongation_1d failed")
        return P

    def radau_tables(self, s: int):
        A = np.zeros((s, s))
        A_inv = np.zeros((s, s))
        b = np.zeros(s)
        c = np.zeros(s)
        L = np.zeros((s, s))
        T = np.zeros((s, s))
        T_inv = np.zeros((s, s))
        D = np.zeros(s)
        if self._lib.spirk_radau_tables(
            s,
            _as_dp(A),
            _as_dp(A_inv),
            _as_dp(b),
            _as_dp(c),
            _as_dp(L),
            _as_dp(T),
            _as_dp(T_inv),
            _as_dp(D),
        ):
            raise RuntimeError("native radau_tables failed")
        return dict(A=A, A_inv=A_inv, b=b, c=c, L=L, T=T, T_inv=T_inv, D=D)

    def complex_tables(self, A_inv: np.ndarray):
        """Complex eigendecomposition of A_inv with the reference's pair
        conventions (native Hessenberg + complex-shift QR + inverse
        iteration; cf. tables/irk_ev.m:52-72)."""
        s = A_inv.shape[0]
        A_inv = np.ascontiguousarray(A_inv, dtype=np.float64)
        T_re = np.zeros((s, s))
        T_im = np.zeros((s, s))
        T_inv_re = np.zeros((s, s))
        T_inv_im = np.zeros((s, s))
        D_re = np.zeros(s)
        D_im = np.zeros(s)
        if self._lib.spirk_complex_tables(
            s,
            _as_dp(A_inv),
            _as_dp(T_re),
            _as_dp(T_im),
            _as_dp(T_inv_re),
            _as_dp(T_inv_im),
            _as_dp(D_re),
            _as_dp(D_im),
        ):
            raise RuntimeError("native complex_tables failed")
        return dict(
            T_re=T_re,
            T_im=T_im,
            T_inv_re=T_inv_re,
            T_inv_im=T_inv_im,
            D_re=D_re,
            D_im=D_im,
        )


_core: NativeCore | None | bool = False  # False = not attempted


def core() -> NativeCore | None:
    """The native core, or None if it cannot be loaded/built."""
    global _core
    if _core is not False:
        return _core
    _core = None
    try:
        if not os.path.exists(_SO_PATH):
            subprocess.run(
                ["make", "-C", _NATIVE_DIR, "-s"],
                check=True,
                capture_output=True,
                timeout=120,
            )
        _core = NativeCore(ctypes.CDLL(_SO_PATH))
    except Exception:
        _core = None
    return _core
