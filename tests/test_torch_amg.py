"""The port's plain-aggregation AMG (``solvers/amg.py``) against the JAX
package's, on the CPU at f64:

* ``aggregation_prolongator`` and ``dense_to_band`` equal JAX's (and
  ``dense_to_band`` refuses entries outside the band);
* ``build_amg_data``'s bands, diagonals, dense matrices, prolongations and
  coarse matrices equal JAX's to round-off at (dim, degree, refinement)
  (2, 1, 5), (3, 1, 3) and (2, 2, 4), the JAX hierarchy carried across by
  ``interop.gmg_data_from_numpy``;
* AMG-preconditioned CG (``tests/test_amg.py``'s solve) takes JAX's
  iteration count and reaches its solution;
* ``irk_batched`` with AMG (2D refinement 7: the levels 127 and 64
  smoothed, the 32^2 one solved densely) takes JAX's counts and L2, through
  the kernel wrappers (their plain versions on CPU tensors) and the plain
  operators alike;
* ``spirk`` with AMG on a (q, 2) mesh of CPU slots (3D refinement 5: the
  31 and 16 levels z-split, the aggregation transfers as z plans) equals
  the port's ``irk`` with AMG;
* the Lanczos start vector on the even level shapes of AMG is JAX's draw
  bit for bit;
* the z march's plan covers every plane of the AMG levels that ``chip_smoke``
  launches the kernels on (P13's m = 127, 64, 32, 16 and AMG_CASES).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# one intra-op thread: the tests run beside other test processes
torch.set_num_threads(1)

from dealii_spirk_tpu.config import Parameters as JParameters
from dealii_spirk_tpu.fem.grid import make_space as jmake_space
from dealii_spirk_tpu.ops.mass_laplace import apply_shifted as japply_shifted
from dealii_spirk_tpu.runner import run_config as jrun_config
from dealii_spirk_tpu.solvers import amg as jamg
from dealii_spirk_tpu.solvers.gmg import gmg_reinit as jgmg_reinit
from dealii_spirk_tpu.solvers.gmg import vcycle as jvcycle
from dealii_spirk_tpu.solvers.krylov import pcg as jpcg
from dealii_spirk_tpu_torch.config import Parameters as TParameters
from dealii_spirk_tpu_torch.fem.grid import make_level as tmake_level
from dealii_spirk_tpu_torch.fem.grid import make_space as tmake_space
from dealii_spirk_tpu_torch.interop import gmg_data_from_numpy
from dealii_spirk_tpu_torch.ops.cuda import stencil as tst
from dealii_spirk_tpu_torch.ops.mass_laplace import apply_shifted_batched
from dealii_spirk_tpu_torch.runner import run_config as trun_config
from dealii_spirk_tpu_torch.solvers import amg as tamg
from dealii_spirk_tpu_torch.solvers.gmg import default_start, gmg_reinit, vcycle
from dealii_spirk_tpu_torch.solvers.krylov import pcg

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
from test_torch_setup import same_tables_route  # noqa: E402, F401 (autouse: one tables route)

HIERARCHIES = [(2, 1, 5), (3, 1, 3), (2, 2, 4)]
BASE = {
    "FEDegree": 1,
    "IRKStages": 3,
    "TimeStepSize": 0.1,
    "EndTime": 0.2,
    "OperatorType": "MatrixFree",
    "BlockPreconditionerType": "AMG",
    "InnerTolerance": 0.0,
    "OuterTolerance": 1e-8,
    "Precision": "f64",
    "DoOutputParaview": False,
}


@pytest.mark.parametrize("m", [1, 2, 7, 8, 127])
def test_aggregation_prolongator_matches_jax(m):
    P = tamg.aggregation_prolongator(m)
    np.testing.assert_array_equal(P, jamg.aggregation_prolongator(m))
    np.testing.assert_array_equal(P.sum(axis=1), 1.0)


@pytest.mark.parametrize("degree", [1, 2, 3, 4])
def test_dense_to_band_matches_jax(degree):
    lev = tmake_level(4, degree)
    P = tamg.aggregation_prolongator(lev.m)
    for A in (lev.mass_dense, lev.stiff_dense, P.T @ lev.stiff_dense @ P):
        np.testing.assert_array_equal(tamg.dense_to_band(A, degree),
                                      jamg.dense_to_band(A, degree))
    np.testing.assert_array_equal(tamg.dense_to_band(lev.mass_dense, degree), lev.mass_band)
    wide = np.ones((5, 5))
    with pytest.raises(ValueError, match="outside the band"):
        tamg.dense_to_band(wide, 1)


def _jax_arrays(amg):
    levels = [
        tuple(np.asarray(x) for x in (o.mass_band, o.stiff_band, o.mass_diag, o.stiff_diag,
                                      o.mass_dense, o.stiff_dense))
        for o in amg.level_ops
    ]
    return levels, [np.asarray(P) for P in amg.prolongs]


@pytest.mark.parametrize("dim,degree,ref", HIERARCHIES)
def test_build_amg_data_matches_jax(dim, degree, ref):
    jd = jamg.build_amg_data(jmake_space(dim, degree, ref), dtype=jnp.float64, with_dense=True)
    td = tamg.build_amg_data(tmake_space(dim, degree, ref), torch.float64, "cpu", with_dense=True)
    levels, prolongs = _jax_arrays(jd)
    carried = gmg_data_from_numpy(levels, prolongs, np.asarray(jd.coarse_mass),
                                  np.asarray(jd.coarse_stiff))
    assert len(td.level_ops) == len(jd.level_ops) and len(td.prolongs) == len(jd.prolongs)
    for got in (td, carried):
        for t, j in zip(got.level_ops, levels, strict=True):
            names = ("mass_band", "stiff_band", "mass_diag", "stiff_diag", "mass_dense",
                     "stiff_dense")
            for name, want in zip(names, j, strict=True):
                np.testing.assert_allclose(getattr(t, name).numpy(), want, rtol=1e-14,
                                           atol=1e-14 * np.abs(want).max())
            assert t.kernel_bands is False and t.mode == "dense"  # f64, dense route
        for t, j in zip(got.prolongs, prolongs, strict=True):
            np.testing.assert_array_equal(t.numpy(), j)
        for name in ("coarse_mass", "coarse_stiff"):
            want = np.asarray(getattr(jd, name))
            np.testing.assert_allclose(getattr(got, name).numpy(), want, rtol=1e-14,
                                       atol=1e-14 * np.abs(want).max())
    # f32 bands for the kernels: contiguous, so kernel_bands holds
    f32 = tamg.build_amg_data(tmake_space(dim, degree, ref), torch.float32, "cpu")
    assert all(o.kernel_bands and o.mass_dense is None for o in f32.level_ops)


@pytest.mark.parametrize("dim,degree,ref", HIERARCHIES)
def test_amg_pcg_matches_jax(dim, degree, ref):
    """``tests/test_amg.py``'s AMG-preconditioned CG: a = 1, b = 0.1, a
    random rhs, reltol 1e-10."""
    a, b = 1.0, 0.1
    jd = jamg.build_amg_data(jmake_space(dim, degree, ref), dtype=jnp.float64)
    jprec = jgmg_reinit(jd, a, b, dim, "stencil")
    jfine = jd.level_ops[-1]
    rhs = np.random.default_rng(0).standard_normal((jfine.m,) * dim)
    jres = jpcg(lambda u: japply_shifted(jfine, a, b, u, dim, "stencil"), jnp.asarray(rhs),
                M=lambda r: jvcycle(jd, jprec, a, b, r, dim, "stencil"), maxiter=200,
                reltol=1e-10)

    td = tamg.build_amg_data(tmake_space(dim, degree, ref), torch.float64, "cpu")
    one = torch.ones(1, dtype=torch.float64)
    prec = gmg_reinit(td, one, b, dim)
    fine = td.level_ops[-1]
    res = pcg(lambda u: apply_shifted_batched(fine, one, b, u, dim),
              torch.as_tensor(rhs)[None],
              M=lambda r: vcycle(td, prec, one, b, r, dim, kernels=False),
              maxiter=200, reltol=1e-10)
    assert res.n_iterations == int(jres.n_iterations) < 60
    want = np.asarray(jres.x)
    np.testing.assert_allclose(res.x[0].numpy(), want, rtol=1e-8, atol=1e-8 * np.abs(want).max())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("dim", [2, 3])
def test_default_start_on_amg_shapes(dim, dtype):
    """``gmg.default_start`` (JAX's threefry draw) on the aggregation levels'
    even m, as ``gmg_reinit`` draws it for every AMG level."""
    for m in (2, 4, 8, 16, 32, 64):
        shape = (m,) * dim
        got = default_start(shape, dtype)
        want = np.asarray(jax.random.uniform(jax.random.PRNGKey(42), shape, dtype=dtype))
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.fixture(scope="module")
def jax_irk_batched():
    cfg = {**BASE, "NRefinements": 7, "TimeIntegrationScheme": "irk_batched",
           "OperatorMode": "stencil"}
    return jrun_config(JParameters.from_dict(cfg, dim=2), verbose=False)


@pytest.mark.parametrize("kernels", [True, False])
def test_irk_batched_amg_matches_jax(jax_irk_batched, kernels):
    tst.reset_launches()
    out = trun_config(TParameters.from_dict({**BASE, "NRefinements": 7,
                                             "TimeIntegrationScheme": "irk_batched"}, dim=2),
                      device="cpu", verbose=False, kernels=kernels)
    assert tst.LAUNCHES == {k: 0 for k in tst.LAUNCHES}
    j = jax_irk_batched
    assert [o.m for o in out["scheme"].gmg.level_ops] == [32, 64, 127]
    assert [o.m for o in j["scheme"].gmg.level_ops] == [32, 64, 127]
    assert (out["n_outer"], out["n_inner"]) == (j["n_outer"], j["n_inner"])
    np.testing.assert_array_equal(out["scheme"].n_inner_stage,
                                  np.asarray(j["scheme"].n_inner_stage))
    np.testing.assert_allclose(out["error_L2"], j["error_L2"], rtol=1e-10)
    np.testing.assert_allclose(out["error_Linf"], j["error_Linf"], rtol=1e-10)


def test_spirk_amg_on_a_mesh_matches_irk():
    cfg = {**BASE, "NRefinements": 5, "IRKStages": 2}
    irk = trun_config(TParameters.from_dict({**cfg, "TimeIntegrationScheme": "irk"}, dim=3),
                      device="cpu", verbose=False)
    sp = trun_config(TParameters.from_dict({**cfg, "TimeIntegrationScheme": "spirk"}, dim=3),
                     device="cpu", verbose=False, slots=4)
    scheme = sp["scheme"]
    assert scheme.mesh.shape == {"stage": 2, "space": 2}
    prec = scheme.prec_state(cfg["TimeStepSize"])
    # the aggregation levels 16 and 31 run z-split, their transfers as z plans
    assert [lv is not None for lv in prec.levels] == [False, True, True]
    assert [lv.m for lv in prec.levels[1:]] == [16, 31]
    assert (sp["n_outer"], sp["n_inner"]) == (irk["n_outer"], irk["n_inner"])
    np.testing.assert_array_equal(scheme.n_inner_stage, irk["scheme"].n_inner_stage)
    np.testing.assert_allclose(sp["error_L2"], irk["error_L2"], rtol=1e-10)


def test_chip_smoke_expected_launches_of_p13(monkeypatch):
    """``chip_smoke.expected_launches`` of P13's structure (``irk_batched``
    with AMG, K1 vmults, K2 maps, the V-cycle's K3 and K4 on every
    aggregation level) against the wrappers' calls of a kernel-structured
    run on the CPU, cut to refinement 5 (levels 31 and 16 smoothed)."""
    from test_torch_ost import count_wrappers

    calls = count_wrappers(monkeypatch)
    dim, cfg, _n_levels = chip_smoke.PATHS["P13"]
    cfg = {**cfg, "NRefinements": 5, "Precision": "f64"}
    out = trun_config(TParameters.from_dict(cfg, dim=dim), device="cpu", verbose=False,
                      kernels=True)
    assert [o.m for o in out["scheme"].gmg.level_ops] == [8, 16, 31]
    want = chip_smoke.expected_launches(out)
    assert calls == want
    assert all(want[k] > 0 for k in ("ms_mix_apply", "stage_mix", "cheb_iter", "stencil_apply"))


def _amg_level_shapes():
    shapes = {f"P13 m={m}": (4, m) for m in (127, 64, 32, 16)}
    shapes |= {f"AMG_CASES q={q} p={p} m={m}": (q, m) for q, p, _r, m in chip_smoke.AMG_CASES}
    return shapes


AMG_SHAPES = _amg_level_shapes()


@pytest.mark.parametrize("where", sorted(AMG_SHAPES))
def test_march_plan_covers_the_amg_levels(where):
    q, m = AMG_SHAPES[where]
    chunk, grid = tst.march_plan(q, m, m)
    ty, tx = tst.MARCH_TILE
    assert (grid[0] - 1) * tx < m <= grid[0] * tx and (grid[1] - 1) * ty < m <= grid[1] * ty
    seen = {}
    for bz in range(grid[2]):
        stage, z0, z1 = tst.march_planes(m, chunk, bz)
        for z in range(z0, z1):
            seen[stage, z] = seen.get((stage, z), 0) + 1
    assert seen == {(i, z): 1 for i in range(q) for z in range(m)}


def test_chip_smoke_amg_levels_exist():
    """Each AMG_CASES level is a level of its hierarchy, and P13's
    hierarchy is the one the path docstring names."""
    for q, p, ref, m in chip_smoke.AMG_CASES:
        amg = tamg.build_amg_data(tmake_space(3, p, ref), torch.float32, "cpu")
        assert m in [o.m for o in amg.level_ops[1:]], (p, ref, m)
    dim, cfg, n_levels = chip_smoke.PATHS["P13"]
    amg = tamg.build_amg_data(tmake_space(dim, cfg["FEDegree"], cfg["NRefinements"]),
                              torch.float32, "cpu")
    assert [o.m for o in amg.level_ops] == [8, 16, 32, 64, 127]
    assert len(amg.level_ops) - 1 == n_levels
