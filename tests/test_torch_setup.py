"""Host setup of the PyTorch port against the JAX package: tables, 1D
bands and transfers, configuration, problem data (u0, load, errors), and
the rule that the port never imports JAX or the JAX package.

The IRK tables come from one of two routes in each package, the native
C++ core or numpy, whose complex eigenvectors differ by O(1) (each
normalises and phases them its own way) and whose real tables differ in
the last digits.  ``tables_route`` puts both packages on the same route,
and ``same_tables_route``, a module fixture that every port test file
comparing runs with the JAX package imports, holds each module's runs on
the native route where the port builds its library: a JAX package whose
library load lost a build race then no longer meets a port that won it.
The port's own build is held by a race of six processes."""

import contextlib
import ctypes
import dataclasses
import glob
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dealii_spirk_tpu.config as jcfg
import dealii_spirk_tpu.fem.grid as jgrid
import dealii_spirk_tpu.native as jnative
import dealii_spirk_tpu.problem as jprob
import dealii_spirk_tpu.tables as jtab
import dealii_spirk_tpu_torch.config as tcfg
import dealii_spirk_tpu_torch.fem.grid as tgrid
import dealii_spirk_tpu_torch.native as tnative
import dealii_spirk_tpu_torch.problem as tprob
import dealii_spirk_tpu_torch.tables as ttab

ATOL = 1e-14
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def tables_route(route: str):
    """Both packages' IRK tables on ``route``: "native" points each
    package's native core at the port's complete library (built under its
    lock), "numpy" sets both to None; the tables' caches are cleared on
    entry and on exit, and the cores are restored on exit."""
    saved = jnative._core, tnative._core
    if route == "native":
        tcore = tnative.core()
        if tcore is None:
            pytest.skip("no C++ compiler: the native route cannot be built")
        cores = jnative.NativeCore(ctypes.CDLL(str(tnative.library_path()))), tcore
    elif route == "numpy":
        cores = None, None
    else:
        raise ValueError(f"route: native or numpy, got {route!r}")
    try:
        jnative._core, tnative._core = cores
        jtab.irk_tables.cache_clear()
        ttab.irk_tables.cache_clear()
        yield
    finally:
        jnative._core, tnative._core = saved
        jtab.irk_tables.cache_clear()
        ttab.irk_tables.cache_clear()


@pytest.fixture(scope="module", autouse=True)
def same_tables_route():
    """The module's runs of both packages on the native route (numpy where
    no C++ compiler builds the port's library)."""
    with tables_route("native" if tnative.core() is not None else "numpy"):
        yield


@pytest.mark.parametrize("route", ["native", "numpy"])
@pytest.mark.parametrize("q", [2, 3, 4, 5])
def test_irk_tables_match(q, route):
    with tables_route(route):
        jt, tt = jtab.irk_tables(q), ttab.irk_tables(q)
    for f in dataclasses.fields(jt):
        a, b = getattr(jt, f.name), getattr(tt, f.name)
        np.testing.assert_allclose(b, a, rtol=0, atol=ATOL, err_msg=f.name)


# one racer: waits for the start file, then loads the port's native core
# from an empty build directory and prints whether it loaded, any warning
# and a digest of irk_tables(5)'s bytes
_RACER = """
import dataclasses, hashlib, os, sys, time, warnings
from pathlib import Path
import numpy as np
import dealii_spirk_tpu_torch.native as n
from dealii_spirk_tpu_torch import tables
n.BUILD_DIR = Path(sys.argv[1])
while not os.path.exists(sys.argv[2]):
    time.sleep(0.001)
with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter("always")
    core = n.core()
    t = tables.irk_tables(5)
h = hashlib.sha256()
for f in dataclasses.fields(t):
    h.update(np.asarray(getattr(t, f.name)).tobytes())
print(core is not None, len(caught), h.hexdigest())
"""


def test_native_build_race(tmp_path):
    """Six processes load the port's native core at once from an empty
    build directory: each loads the library (no numpy fallback, no
    warning), and their irk_tables(5) are equal bit for bit; the
    directory holds the library and its lock, no temporary file."""
    build_dir, start = tmp_path / "build", tmp_path / "start"
    procs = [subprocess.Popen([sys.executable, "-c", _RACER, str(build_dir), str(start)],
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    start.touch()
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), [err[-2000:] for _out, err in outs]
    lines = [out.split() for out, _err in outs]
    assert all(line[:2] == ["True", "0"] for line in lines), lines
    assert len({line[2] for line in lines}) == 1, lines
    assert sorted(f.name for f in build_dir.iterdir()) == [
        "libspirk_fem.lock", tnative.library_path().name]


@pytest.mark.parametrize("dim,p,ref", [(3, 1, 4), (3, 2, 3), (2, 3, 3)])
def test_space_bands_and_transfers_match(dim, p, ref):
    js, ts = jgrid.make_space(dim, p, ref), tgrid.make_space(dim, p, ref)
    assert len(js.levels) == len(ts.levels)
    for jl, tl in zip(js.levels, ts.levels):
        for name in ("x", "mass_band", "stiff_band", "mass_diag", "stiff_diag"):
            np.testing.assert_allclose(
                getattr(tl, name), getattr(jl, name), rtol=0, atol=ATOL, err_msg=name
            )
    for jP, tP in zip(js.prolongations, ts.prolongations):
        np.testing.assert_allclose(tP, jP, rtol=0, atol=ATOL)
    for name in ("rhs_eval", "rhs_wq", "err_eval", "err_wq", "err_xq"):
        np.testing.assert_allclose(
            getattr(ts, name), getattr(js, name), rtol=0, atol=ATOL, err_msg=name
        )


def test_json_configs_parse_identically():
    for path in sorted(glob.glob(os.path.join(REPO, "json", "*.json"))):
        for dim in (2, 3):
            jp = jcfg.Parameters.from_json(path, dim=dim)
            tp = tcfg.Parameters.from_json(path, dim=dim)
            assert dataclasses.asdict(jp) == dataclasses.asdict(tp), path
    with pytest.raises(KeyError):
        tcfg.Parameters.from_dict({"NoSuchKey": 1})
    with pytest.raises(ValueError):
        tcfg.Parameters.from_dict({"OperatorMode": "bogus"})


def test_operator_mode_maps_devices():
    mf32 = tcfg.Parameters.from_dict(
        {"OperatorType": "MatrixFree", "Precision": "f32", "FEDegree": 1}
    )
    assert mf32.operator_mode("cuda") == "pallas"
    assert mf32.operator_mode("cpu") == "stencil"
    mf32_2d = tcfg.Parameters.from_dict(
        {"OperatorType": "MatrixFree", "Precision": "f32", "FEDegree": 1}, dim=2
    )
    assert mf32_2d.operator_mode("cuda") == "pallas"  # K4-2D, K5-2D
    assert mf32_2d.operator_mode("cpu") == "stencil"
    p5 = tcfg.Parameters.from_dict(
        {"OperatorType": "MatrixFree", "Precision": "f32", "FEDegree": 5}, dim=2
    )
    assert p5.operator_mode("cuda") == "stencil"  # the kernels take degrees 1-4
    mf64 = tcfg.Parameters.from_dict({"OperatorType": "MatrixFree", "Precision": "f64"})
    assert mf64.operator_mode("cuda") == "stencil"
    mb = tcfg.Parameters.from_dict({"OperatorType": "MatrixBased", "Precision": "f32"})
    assert mb.operator_mode("cuda") == "dense"
    forced = tcfg.Parameters.from_dict(
        {"OperatorType": "MatrixFree", "Precision": "f32", "OperatorMode": "stencil"}
    )
    assert forced.operator_mode("cuda") == "stencil"


def _params(ref, p, dim):
    d = {"FEDegree": p, "NRefinements": ref, "Precision": "f64"}
    return jcfg.Parameters.from_dict(d, dim=dim), tcfg.Parameters.from_dict(d, dim=dim)


@pytest.mark.parametrize("dim,p,ref", [(3, 1, 4), (2, 2, 4)])
def test_problem_data_match(dim, p, ref):
    jpar, tpar = _params(ref, p, dim)
    jp, tp = jprob.HeatProblem(jpar), tprob.HeatProblem(tpar, device="cpu")
    np.testing.assert_allclose(tp.u0.numpy(), np.asarray(jp.u0), rtol=0, atol=ATOL)

    rng = np.random.default_rng(5)
    tf = rng.uniform(-3.0, 3.0, 4)
    np.testing.assert_allclose(
        tp.stage_load(torch.as_tensor(tf)).numpy(),
        np.asarray(jp.stage_load(jnp.asarray(tf))),
        rtol=0,
        atol=ATOL,
    )
    u = rng.standard_normal(tp.u0.shape)
    for t in (0.0, 0.3):
        je = jp.errors(jnp.asarray(u), t)
        te = tp.errors(torch.as_tensor(u), t)
        np.testing.assert_allclose(te, je, rtol=1e-13, atol=ATOL)


_FORBIDDEN = ("import jax", "from jax", "dealii_spirk_tpu.")
_IMPORT_RE = re.compile(r"^\s*(import|from)\s+(jax|dealii_spirk_tpu)\b", re.M)


def test_port_sources_never_import_jax():
    files = glob.glob(os.path.join(REPO, "dealii_spirk_tpu_torch", "**", "*.py"), recursive=True)
    files.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(files) > 20
    for path in files:
        src = open(path).read()
        for word in _FORBIDDEN:
            assert word not in src, f"{path} contains {word!r}"
        assert not _IMPORT_RE.search(src), path


def test_port_import_loads_no_jax_and_pins_f32():
    code = (
        "import sys, torch, dealii_spirk_tpu_torch.runner, chip_smoke;"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'dealii_spirk_tpu.'))"
        " or m == 'dealii_spirk_tpu' for m in sys.modules), 'jax loaded';"
        "assert not torch.backends.cuda.matmul.allow_tf32;"
        "assert not torch.backends.cudnn.allow_tf32;"
        "assert torch.get_float32_matmul_precision() == 'highest'"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_ci_installs_torch():
    """The CI workflow installs torch beside JAX, so the port's tests
    import there."""
    with open(os.path.join(REPO, ".github", "workflows", "tests.yml")) as f:
        installs = [line.split() for line in f if "pip install" in line]
    assert any("torch" in words and "jax" in words for words in installs)
