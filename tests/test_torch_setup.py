"""Host setup of the PyTorch port against the JAX package: tables, 1D
bands and transfers, configuration, problem data (u0, load, errors), and
the rule that the port never imports JAX or the JAX package."""

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
import dealii_spirk_tpu.problem as jprob
import dealii_spirk_tpu.tables as jtab
import dealii_spirk_tpu_torch.config as tcfg
import dealii_spirk_tpu_torch.fem.grid as tgrid
import dealii_spirk_tpu_torch.problem as tprob
import dealii_spirk_tpu_torch.tables as ttab

ATOL = 1e-14
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("q", [2, 3, 4, 5])
def test_irk_tables_match(q):
    jt, tt = jtab.irk_tables(q), ttab.irk_tables(q)
    for f in dataclasses.fields(jt):
        a, b = getattr(jt, f.name), getattr(tt, f.name)
        np.testing.assert_allclose(b, a, rtol=0, atol=ATOL, err_msg=f.name)


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
    assert mf32_2d.operator_mode("cuda") == "stencil"  # the kernels are 3D only
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
    jp, tp = jprob.HeatProblem(jpar), tprob.HeatProblem(tpar)
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
