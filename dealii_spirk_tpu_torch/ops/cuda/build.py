"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with its own ``nvcc`` process, all started together,
and the objects link into one shared library with a plain C interface,
loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds).
The library lands in ``build/dealii_spirk_tpu_torch/`` at the repository
root, under a name keyed by a hash of the sources and flags: an edited
source builds anew, an unchanged one is reused.  Nothing is built on
import — the first CUDA launch (or ``build()``) does it.
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> argtypes (every one returns a cudaError_t as int)
SIGNATURES = {
    # the z march (csrc/march.cuh), whole field: fields, mband, kband, a (q,), b,
    # [c1 (q,), c2 (q,),] q, m, chunk, p, stream (ops/cuda/stencil.py::_march)
    # K4: u, out
    "spirk_stencil_apply": (_P,) * 5 + (_F,) + (_I,) * 4 + (_P,),
    # K3: d, r, x, invd, r_out, d_out, x_out
    "spirk_cheb_iter": (_P,) * 10 + (_F, _P, _P) + (_I,) * 4 + (_P,),
    # K3dg: d, r, x, mdiag, kdiag, r_out, d_out, x_out
    "spirk_cheb_iter_dg": (_P,) * 11 + (_F, _P, _P) + (_I,) * 4 + (_P,),
    # the march on a z slab: ..., q, m, nzl, z_off, chunk, p, stream
    "spirk_stencil_apply_halo": (_P,) * 5 + (_F,) + (_I,) * 6 + (_P,),
    "spirk_cheb_iter_halo": (_P,) * 10 + (_F, _P, _P) + (_I,) * 6 + (_P,),
    "spirk_cheb_iter_dg_halo": (_P,) * 11 + (_F, _P, _P) + (_I,) * 6 + (_P,),
    # K4-2D: u, out, mband, kband, a (q,), b, q, m, p, stream
    "spirk_stencil_apply_2d": (_P, _P, _P, _P, _P, _F, _I, _I, _I, _P),
    # K5 (the march): u, mu, ku, mband, kband, q, m, chunk, p, stream
    "spirk_mass_stiffness_apply": (_P,) * 5 + (_I,) * 4 + (_P,),
    # K5-2D: u, mu, ku, mband, kband, q, m, p, stream
    "spirk_mass_stiffness_apply_2d": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    # K9b: ..., q, m, nzl, z_off, chunk, p, stream
    "spirk_mass_stiffness_apply_halo": (_P,) * 5 + (_I,) * 6 + (_P,),
    # K8 (the march's pair form): d, r, x, mdiag, kdiag, r_out, d_out, x_out, mband,
    # kband, a, b, c1a, c2a, c1b, c2b, q, m, tile height, chunk, p, stream
    "spirk_cheb_pair_dg": (_P,) * 11 + (_F,) + (_P,) * 4 + (_I,) * 5 + (_P,),
    # K1 (the march): u, out, mband, kband, mw, q, m, tile height, chunk, p, stream
    "spirk_ms_mix_apply": (_P,) * 5 + (_I,) * 5 + (_P,),
    # K1's route: v, u, out, mband, kband, tau, q, m, chunk, p, stream
    "spirk_ms_mix_apply_split": (_P,) * 5 + (_F,) + (_I,) * 4 + (_P,),
    # W, out, mat, q_out, q_in, n, stream
    "spirk_stage_mix": (_P, _P, _P, _I, _I, ctypes.c_longlong, _P),
    # K10 (csrc/transfer.cu): fine, other, out, run starts, run weights, q,
    # m_f, m_c, run width, chunk, stream (ops/cuda/transfer.py)
    "spirk_transfer_restrict": (_P,) * 5 + (_I,) * 5 + (_P,),
    "spirk_transfer_prolong": (_P,) * 5 + (_I,) * 5 + (_P,),
}

# diagnostics that no path launches (no LAUNCHES count): the arms of K3,
# K3dg, K4, K5 and K1, each the arguments of its kernel's entry point with
# the arm before the stream
DIAGNOSTICS = {
    name + "_arm": SIGNATURES[name][:-1] + (_I, _P)
    for name in ("spirk_cheb_iter", "spirk_cheb_iter_dg", "spirk_stencil_apply",
                 "spirk_mass_stiffness_apply", "spirk_ms_mix_apply")
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
    The compilers' reports (registers, shared memory, spills from
    ``-Xptxas -v``) are kept beside the library as ``.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", obj]
            jobs.append((src.name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )))
        log, failed = [], []
        for name, _obj, proc in jobs:
            text = proc.communicate()[0]
            log.append(f"== {name}\n{text}")
            if proc.returncode != 0:
                failed.append(f"{name} ({proc.returncode}):\n{text[-4000:]}")
        out.with_suffix(".log").write_text("".join(log))
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        lib = os.path.join(tmp, out.name)
        proc = subprocess.run(
            [nvcc, "-shared", "-o", lib, *(obj for _n, obj, _p in jobs)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
        os.replace(lib, out)
    return out


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in (SIGNATURES | DIAGNOSTICS).items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.spirk_error_string.argtypes = [ctypes.c_int]
        lib.spirk_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
