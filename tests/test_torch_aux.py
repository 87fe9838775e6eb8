"""The port's auxiliary modules against the JAX package's, on the CPU:

* ``solvers/gcr.py``: ``gcr`` on ``tests/test_aux.py``'s systems (a
  diagonally dominant random 40 x 40 system; a 30 x 30 diagonal one, plain
  and Jacobi-preconditioned; and a warm start) takes JAX's iteration count
  and reaches its x to 1e-12;
* ``utils/vtk.py``: ``write_vtr`` and ``ParaviewSeries`` write the JAX
  package's files byte for byte for the same arrays (2D and 3D; the port's
  series from a torch tensor, f64 and f32);
* ``tables.py``: a table file written by either package reads back in the
  other equal, and both write the same bytes;
* ``runner.run_config`` with ``DoOutputParaview``: a 2D ``irk_batched`` run
  through both runners, each into its own directory, writes the same file
  names, and every step's payload within 1e-10 relative of JAX's.
"""

import base64
import os
import re
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# one intra-op thread: the tests run beside other test processes
torch.set_num_threads(1)

import dealii_spirk_tpu.runner as jrunner
from dealii_spirk_tpu import tables as jtables
from dealii_spirk_tpu.config import Parameters as JParameters
from dealii_spirk_tpu.solvers.gcr import gcr as jgcr
from dealii_spirk_tpu.utils import vtk as jvtk
from dealii_spirk_tpu_torch import tables as ttables
from dealii_spirk_tpu_torch.config import Parameters as TParameters
from dealii_spirk_tpu_torch.runner import run_config as trun_config
from dealii_spirk_tpu_torch.solvers import gcr as tgcr
from dealii_spirk_tpu_torch.utils import vtk as tvtk
from test_torch_setup import same_tables_route  # noqa: F401 (autouse: one tables route)


def _systems():
    """(A, b, preconditioner diagonal or None, x0 or None, reltol), the
    systems of ``tests/test_aux.py:13`` and ``:25``."""
    rng = np.random.default_rng(0)
    n = 40
    A1 = np.eye(n) * 4 + 0.4 * rng.standard_normal((n, n))
    b1 = rng.standard_normal(n)
    A2 = np.diag(np.linspace(1, 100, 30))
    b2 = np.ones(30)
    x0 = np.random.default_rng(2).standard_normal(n)
    return {
        "random": (A1, b1, None, None, 1e-10),
        "diagonal": (A2, b2, None, None, 1e-8),
        "diagonal, Jacobi": (A2, b2, np.diag(A2).copy(), None, 1e-8),
        "random, x0": (A1, b1, None, x0, 1e-10),
    }


@pytest.mark.parametrize("case", list(_systems()))
def test_gcr_matches_jax(case):
    A, b, diag, x0, reltol = _systems()[case]
    jA, tA = jnp.asarray(A), torch.as_tensor(A)
    jkw = dict(maxiter=40, reltol=reltol)
    tkw = dict(maxiter=40, reltol=reltol)
    if diag is not None:
        jkw["M"] = lambda r: r / jnp.asarray(diag)
        tkw["M"] = lambda r: r / torch.as_tensor(diag)
    if x0 is not None:
        jkw["x0"], tkw["x0"] = jnp.asarray(x0), torch.as_tensor(x0)
    j = jgcr(lambda x: jA @ x, jnp.asarray(b), **jkw)
    t = tgcr(lambda x: tA @ x, torch.as_tensor(b), **tkw)
    assert t.n_iterations == int(j.n_iterations) > 0
    want = np.asarray(j.x)
    np.testing.assert_allclose(t.x.numpy(), want, rtol=0, atol=1e-12 * np.abs(want).max())
    np.testing.assert_allclose(t.x.numpy(), np.linalg.solve(A, b), atol=1e-6)


def _fields(dim: int):
    rng = np.random.default_rng(dim)
    m = 7 if dim == 3 else 15
    x = np.sort(rng.uniform(0, 1, m))
    return x, rng.standard_normal((m,) * dim)


@pytest.mark.parametrize("dim", [2, 3])
def test_write_vtr_bytes_equal_jax(tmp_path, dim):
    x, u = _fields(dim)
    coords = [np.concatenate([[0.0], x, [1.0]])] * dim
    vals = np.pad(u, 1)
    jvtk.write_vtr(str(tmp_path / "j.vtr"), coords, vals, name="V")
    tvtk.write_vtr(str(tmp_path / "t.vtr"), coords, vals, name="V")
    assert (tmp_path / "t.vtr").read_bytes() == (tmp_path / "j.vtr").read_bytes()


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("dim", [2, 3])
def test_paraview_series_bytes_equal_jax(tmp_path, dim, dtype):
    x, u = _fields(dim)
    u = u.astype(np.float64 if dtype == "f64" else np.float32)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    js, ts = jvtk.ParaviewSeries(str(tmp_path / "j")), tvtk.ParaviewSeries(str(tmp_path / "t"))
    for step, t in enumerate((0.0, 0.1, 0.30000000000000004)):
        js.write(jnp.asarray(u * (step + 1)), x, t, step)
        ts.write(torch.as_tensor(u * (step + 1)), x, t, step)
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t")) == [
        "result.pvd", "result_0000.vtr", "result_0001.vtr", "result_0002.vtr"]
    for name in names:
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()


@pytest.mark.parametrize("shape", [(3, 3), (1, 4), (5,)])
def test_table_files_cross_read(tmp_path, shape):
    data = np.random.default_rng(sum(shape)).standard_normal(shape) * 10.0 ** np.arange(shape[-1])
    jpath, tpath = str(tmp_path / "j.txt"), str(tmp_path / "t.txt")
    jtables.save_table_file(jpath, data)
    ttables.save_table_file(tpath, data)
    assert open(tpath, "rb").read() == open(jpath, "rb").read()
    want = data.ravel() if data.ndim == 1 or data.shape[0] == 1 else data
    for read in (ttables.load_table_file(jpath), jtables.load_table_file(tpath)):
        assert read.shape == want.shape
        np.testing.assert_array_equal(read, want)


def _payloads(directory) -> dict:
    """The point data of every .vtr file in ``directory``, by name."""
    out = {}
    for name in sorted(os.listdir(directory)):
        if name.endswith(".vtr"):
            text = open(os.path.join(directory, name)).read()
            raw = base64.b64decode(text.split('format="binary">')[1].split("<")[0])
            (nbytes,) = struct.unpack("<I", raw[:4])
            out[name] = np.frombuffer(raw[4 : 4 + nbytes], dtype="<f8")
    return out


def test_runner_paraview_series_matches_jax(tmp_path):
    """2D ``irk_batched`` q=3 refinement 4, dt 0.1 to 0.3, f64, through
    both runners into their own directories."""
    cfg = {"FEDegree": 1, "NRefinements": 4, "TimeIntegrationScheme": "irk_batched",
           "IRKStages": 3, "TimeStepSize": 0.1, "EndTime": 0.3,
           "OperatorType": "MatrixFree", "BlockPreconditionerType": "GMG",
           "DoOutputParaview": True}
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jdir.mkdir()
    tdir.mkdir()
    j = jrunner.run_config(JParameters.from_dict(cfg, dim=2), verbose=False,
                           output_dir=str(jdir))
    t = trun_config(TParameters.from_dict(cfg, dim=2), device="cpu", verbose=False,
                    output_dir=str(tdir))
    assert t["n_timesteps"] == j["n_timesteps"] == 3
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir)) == ["result.pvd"] + [
        f"result_{i:04d}.vtr" for i in range(4)]
    tpvd, jpvd = (open(d / "result.pvd").read() for d in (tdir, jdir))
    assert re.findall(r'file="([^"]+)"', tpvd) == re.findall(r'file="([^"]+)"', jpvd)
    jp, tp = _payloads(jdir), _payloads(tdir)
    for name, want in jp.items():
        np.testing.assert_allclose(tp[name], want, rtol=0, atol=1e-10 * np.abs(want).max())
    # the last file is the run's final field with its zero boundary
    np.testing.assert_array_equal(tp["result_0003.vtr"],
                                  np.pad(t["u"].numpy(), 1).ravel(order="F"))
