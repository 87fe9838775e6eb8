"""The port's MatrixBased ("dense") route (``ops/mass_laplace.py``) and
``json/ost.json`` through the port's CLI, against the stencil route and the
JAX package, on the CPU at f64:

* every plain operator (``apply_mass``, ``apply_stiffness``,
  ``apply_shifted``, their batched forms, ``apply_complex``) gives the
  same result on a level built ``with_dense`` (which takes the dense
  route) as on the banded level, 2D and 3D, degrees 1-4; a z slab of such a level
  (``slab_ops``) too, through its dense block;
* ``vcycle`` and ``gmg_reinit`` by the dense route equal the stencil
  route's;
* ``apply_complex`` equals the JAX package's (``tests/test_operators.py:105``);
* MatrixBased ``irk`` and ``complex_irk_batched`` equal their MatrixFree
  runs (``tests/test_schemes.py:91``) and the JAX package's MatrixBased
  counts and L2; MatrixBased ``spirk`` on a (2, 2) mesh of CPU slots equals
  MatrixBased ``irk``;
* ``json/ost.json`` (MatrixBased + AMG, Q4) at NRefinements 2 through
  ``__main__.main(["--device", "cpu", ...])`` takes the JAX CLI's CG count
  and L2.
"""

import json
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# one intra-op thread: the tests run beside other test processes
torch.set_num_threads(1)

import dealii_spirk_tpu.__main__ as jmain
from dealii_spirk_tpu.config import Parameters as JParameters
from dealii_spirk_tpu.fem.grid import make_level as jmake_level
from dealii_spirk_tpu.ops.mass_laplace import apply_complex as japply_complex
from dealii_spirk_tpu.ops.mass_laplace import level_ops as jlevel_ops
from dealii_spirk_tpu.runner import run_config as jrun_config
import dealii_spirk_tpu_torch.__main__ as tmain
from dealii_spirk_tpu_torch.config import Parameters as TParameters
from dealii_spirk_tpu_torch.fem.grid import make_level, make_space
from dealii_spirk_tpu_torch.ops import mass_laplace as ml
from dealii_spirk_tpu_torch.ops.cuda import stencil as tst
from dealii_spirk_tpu_torch.runner import run_config as trun_config
from dealii_spirk_tpu_torch.solvers.gmg import build_gmg_data, gmg_reinit, vcycle
from test_torch_setup import same_tables_route  # noqa: F401 (autouse: one tables route)

RTOL = 1e-10
BASE = {
    "FEDegree": 1,
    "NRefinements": 4,
    "IRKStages": 3,
    "TimeStepSize": 0.1,
    "EndTime": 0.2,
    "OperatorType": "MatrixFree",
    "BlockPreconditionerType": "GMG",
    "InnerTolerance": 0.0,
    "DoOutputParaview": False,
}


def _close(got, want, rtol=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("degree", [1, 2, 3, 4])
def test_dense_route_equals_stencil(dim, degree):
    ref = 3 if dim == 3 or degree > 2 else 4
    level = make_level(ref, degree)
    ops, banded = ml.level_ops(level, with_dense=True), ml.level_ops(level)
    assert ops.mode == "dense" and banded.mode == "stencil"
    rng = np.random.default_rng(10 * dim + degree)
    q = 3
    W = torch.as_tensor(rng.standard_normal((q,) + (ops.m,) * dim))
    a = torch.as_tensor(rng.uniform(0.5, 2.0, q))
    _close(ml.apply_mass(ops, W, dim), ml.apply_mass(banded, W, dim))
    _close(ml.apply_stiffness(ops, W, dim), ml.apply_stiffness(banded, W, dim))
    _close(ml.apply_shifted(ops, 1.3, 0.2, W[0], dim),
           ml.apply_shifted(banded, 1.3, 0.2, W[0], dim))
    _close(ml.apply_shifted_batched(ops, a, 0.2, W, dim),
           ml.apply_shifted_batched(banded, a, 0.2, W, dim))
    for got, want in zip(ml.apply_mass_stiffness_batched(ops, W, dim),
                         ml.apply_mass_stiffness_batched(banded, W, dim)):
        _close(got, want)
    _close(ml.apply_complex(ops, 1.3, 0.7, 0.1, W[:2], dim),
           ml.apply_complex(banded, 1.3, 0.7, 0.1, W[:2], dim))


@pytest.mark.parametrize("degree", [1, 2])
def test_dense_slab_equals_stencil_slab(degree):
    """A z slab of a dense level applies its dense block along z: equal to
    the banded slab and to the whole field's planes."""
    level = make_level(3 if degree == 2 else 4, degree)
    ops, banded = ml.level_ops(level, with_dense=True), ml.level_ops(level)
    m, p = ops.m, ops.p
    u = torch.as_tensor(np.random.default_rng(degree).standard_normal((2, m, m, m)))
    a = torch.tensor([1.1, 0.6], dtype=torch.float64)
    whole = tst.stencil_apply_ref(banded, a, 0.3, u)
    for z0, nzl in ((0, m // 2), (m // 2, m - m // 2)):
        sops = ml.slab_ops(ops, z0, nzl)
        assert sops.mode == "dense" and sops.z_mass_dense.shape == (nzl + 2 * p,) * 2
        u_h = torch.zeros((2, nzl + 2 * p, m, m), dtype=torch.float64)
        lo, hi = max(z0 - p, 0), min(z0 + nzl + p, m)
        u_h[:, lo - (z0 - p) : hi - (z0 - p)] = u[:, lo:hi]
        dense = tst.stencil_apply_halo_ref(sops, a, 0.3, u_h)
        _close(dense, whole[:, z0 : z0 + nzl])
        _close(dense, tst.stencil_apply_halo_ref(ml.slab_ops(banded, z0, nzl), a, 0.3, u_h))


def test_vcycle_and_reinit_dense_equal_stencil():
    """The V-cycle and the Lanczos estimates of ``gmg_reinit`` on a
    hierarchy built ``with_dense`` (each level by the dense route) equal
    those on the banded one."""
    space = make_space(3, 2, 3)
    gmgs = {True: build_gmg_data(space, with_dense=True), False: build_gmg_data(space)}
    assert [o.mode for o in gmgs[True].level_ops] == ["dense"] * len(gmgs[True].level_ops)
    a = torch.tensor([1.0, 2.5], dtype=torch.float64)
    precs = {k: gmg_reinit(g, a, 0.1, 3) for k, g in gmgs.items()}
    for t_d, t_s in zip(precs[True].thetas, precs[False].thetas, strict=True):
        _close(t_d, t_s, 1e-10)
    m = space.fine.m
    r = torch.as_tensor(np.random.default_rng(5).standard_normal((2, m, m, m)))
    got, want = (vcycle(gmgs[k], precs[k], a, 0.1, r, 3, kernels=False) for k in (True, False))
    _close(got, want, 1e-9)


@pytest.mark.parametrize("dim", [2, 3])
def test_apply_complex_matches_jax(dim):
    lev = jmake_level(2, 1)
    jops = jlevel_ops(lev, jnp.float64, with_dense=True)
    z = np.random.default_rng(3).standard_normal((2,) + (lev.m,) * dim)
    for mode in ("stencil", "dense"):
        tops = ml.level_ops(make_level(2, 1), with_dense=mode == "dense")
        assert tops.mode == mode
        want = np.asarray(japply_complex(jops, 1.3, 0.7, 0.1, jnp.asarray(z), dim, mode))
        _close(ml.apply_complex(tops, 1.3, 0.7, 0.1, torch.as_tensor(z), dim), want)


@pytest.mark.parametrize("scheme", ["irk", "complex_irk_batched"])
def test_matrix_based_equals_matrix_free_and_jax(scheme):
    cfg = {**BASE, "TimeIntegrationScheme": scheme, "OuterTolerance": 1e-8}
    free = trun_config(TParameters.from_dict(cfg, dim=2), device="cpu", verbose=False)
    based_cfg = {**cfg, "OperatorType": "MatrixBased"}
    based = trun_config(TParameters.from_dict(based_cfg, dim=2), device="cpu", verbose=False)
    assert based["scheme"].mode == "dense" and based["scheme"].kernels is False
    assert all(o.mode == "dense" for o in based["scheme"].gmg.level_ops)
    j = jrun_config(JParameters.from_dict(based_cfg, dim=2), verbose=False)
    assert j["scheme"].mode == "dense"
    for run in (free, j):
        assert (based["n_outer"], based["n_inner"]) == (run["n_outer"], run["n_inner"])
        np.testing.assert_allclose(based["error_L2"], run["error_L2"], rtol=RTOL)
    want = np.asarray(j["u"])
    np.testing.assert_allclose(based["u"].numpy(), want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


def test_matrix_based_spirk_on_a_mesh_matches_irk():
    cfg = {**BASE, "IRKStages": 2, "OperatorType": "MatrixBased", "OuterTolerance": 1e-8}
    irk = trun_config(TParameters.from_dict({**cfg, "TimeIntegrationScheme": "irk"}, dim=3),
                      device="cpu", verbose=False)
    sp = trun_config(TParameters.from_dict({**cfg, "TimeIntegrationScheme": "spirk"}, dim=3),
                     device="cpu", verbose=False, slots=4)
    level = sp["scheme"].fine_level
    assert sp["scheme"].mesh.shape == {"stage": 2, "space": 2}
    assert all(o.z_mass_dense is not None for row in level.ops for o in row)
    assert (sp["n_outer"], sp["n_inner"]) == (irk["n_outer"], irk["n_inner"])
    np.testing.assert_allclose(sp["error_L2"], irk["error_L2"], rtol=RTOL)


def _recorded(module, monkeypatch):
    """Each run_config result of a CLI run of ``module``."""
    runs, run = [], module.run_config

    def recording(*args, **kwargs):
        runs.append(run(*args, **kwargs))
        return runs[-1]

    monkeypatch.setattr(module, "run_config", recording)
    return runs


def test_ost_json_through_the_cli(tmp_path, monkeypatch, capsys):
    """``json/ost.json`` as shipped (Q4, MatrixBased + AMG, dt 0.1 to 0.5)
    at NRefinements 2, through both packages' CLIs."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "json", "ost.json")) as f:
        cfg = json.load(f)
    assert "OperatorType" not in cfg and "BlockPreconditionerType" not in cfg
    path = tmp_path / "ost.json"
    path.write_text(json.dumps({**cfg, "NRefinements": 2}))
    truns, jruns = _recorded(tmain, monkeypatch), _recorded(jmain, monkeypatch)
    monkeypatch.chdir(tmp_path)  # both CLIs write the config's paraview files here
    assert tmain.main(["--device", "cpu", str(path)]) == 0
    text = capsys.readouterr().out
    assert "error_L2" in text
    # the port's CLI wrote step 0 and every step, and the collection lists them
    written = [f"result_{i:04d}.vtr" for i in range(truns[0]["n_timesteps"] + 1)]
    assert sorted(os.listdir(tmp_path)) == sorted(["ost.json", "result.pvd"] + written)
    assert re.findall(r'file="([^"]+)"', (tmp_path / "result.pvd").read_text()) == written
    assert jmain.main([str(path)]) == 0
    (t,), (j,) = truns, jruns
    scheme = t["scheme"]
    assert (scheme.mode, scheme.params.block_preconditioner_type) == ("dense", "AMG")
    assert t["n_timesteps"] == j["n_timesteps"] == 5
    assert t["n_outer"] == j["n_outer"] > 0
    np.testing.assert_allclose(t["error_L2"], j["error_L2"], rtol=RTOL)
    np.testing.assert_allclose(t["error_Linf"], j["error_Linf"], rtol=RTOL)
