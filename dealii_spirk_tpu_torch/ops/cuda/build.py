"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

All sources compile with ``nvcc`` into one shared library with a plain C
interface, loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds).  The library lands in ``build/dealii_spirk_tpu_torch/`` at the
repository root, under a name keyed by a hash of the sources and flags:
an edited source builds anew, an unchanged one is reused.  Nothing is
built on import — the first CUDA launch (or ``build()``) does it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "dealii_spirk_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argtypes (every one returns a cudaError_t as int)
SIGNATURES = {
    # u, out, mband, kband, w, q, m, p, stream
    "spirk_stencil_apply": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    # d, r, x, invd, r_out, d_out, x_out, mband, kband, w, q, m, p, stream
    "spirk_cheb_iter": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # u, out, mband, kband, mw, q, m, p, stream
    "spirk_ms_mix_apply": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    # W, out, mat, q_out, q_in, n, stream
    "spirk_stage_mix": (_P, _P, _P, _I, _I, ctypes.c_longlong, _P),
}

_lib: ctypes.CDLL | None = None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libspirk_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build() -> Path:
    """Compile the kernels unless a library for these sources exists.
    The compiler's report (registers, shared memory, spills from
    ``-Xptxas -v``) is kept beside the library as ``.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = [str(s) for s in sorted(CSRC.glob("*.cu"))]
    with tempfile.NamedTemporaryFile(
        dir=BUILD_DIR, suffix=".so", delete=False
    ) as tmp:
        tmp_path = tmp.name
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp_path, *cu],
            capture_output=True,
            text=True,
        )
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}"
            )
        os.replace(tmp_path, out)
    finally:
        if os.path.exists(tmp_path):
            os.unlink(tmp_path)
    return out


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.spirk_error_string.argtypes = [ctypes.c_int]
        lib.spirk_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
