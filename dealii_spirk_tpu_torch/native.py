"""ctypes bindings for the native C++ setup core (``native/fem_core.cc``).

The port builds its own copy of the library from that source, at first
use, into ``build/dealii_spirk_tpu_torch/`` at the repository root (the
kernels' build directory, git-ignored), under a name keyed by a hash of
the source and the compiler flags.  The compiler writes a temporary file
in that directory, which ``os.replace`` moves into place, all under an
exclusive ``fcntl.flock`` on a lock file there: the first process builds,
the others wait and load the finished file, so no process loads a
partly written library or races another's build.  Every entry point has
a pure-numpy fallback in ``tables.py``; callers use :func:`core` and
treat ``None`` as "fall back", which it warns about once, naming the
error.  The two routes do not give the same complex eigenvectors (each
normalises and phases them its own way), so a run's tables depend on
the route.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import warnings
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "native" / "fem_core.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "dealii_spirk_tpu_torch"
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")

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


def library_path() -> Path:
    """The library built from SOURCE with CXX_FLAGS, in BUILD_DIR."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libspirk_fem_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile SOURCE unless its library exists; one process at a time."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libspirk_fem.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if out.exists():  # another process built it while this one waited
            return out
        cxx = shutil.which("g++") or shutil.which("c++")
        if cxx is None:
            raise RuntimeError("no C++ compiler (g++ or c++) found")
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)], check=True,
                           capture_output=True, text=True, timeout=300)
            os.replace(tmp, out)
        except subprocess.CalledProcessError as e:
            raise RuntimeError(f"{cxx} failed ({e.returncode}): {e.stderr[-2000:]}") from e
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return out


_core: NativeCore | None | bool = False  # False = not attempted


def core() -> NativeCore | None:
    """The native core, built on first use, or None (with a warning, once
    per process) if it cannot be built or loaded."""
    global _core
    if _core is not False:
        return _core
    _core = None
    try:
        _core = NativeCore(ctypes.CDLL(str(build())))
    except Exception as e:  # noqa: BLE001 (any failure takes the numpy route)
        warnings.warn(f"native setup core unavailable, tables fall back to numpy: {e!r}",
                      RuntimeWarning, stacklevel=2)
    return _core
