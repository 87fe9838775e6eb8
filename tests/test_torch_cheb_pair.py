"""K8, the pair Chebyshev step (two smoother steps per pass), and the
pair-smoothed V-cycle of the port:

* ``cheb_pair_dg_ref`` (the plain version of K8, ``ops/cuda/stencil.py``)
  against the JAX package's ``fused_cheb_pair_canon`` in interpret mode
  (y-blocked, ``force_yb=8``) with its ``cheb_diag_tables`` /
  ``cheb2_tables``: refinement 4 at p = 1 and refinement 3 at p = 2, q = 2,
  f32, each output to 1e-5 of its max|ref|.  The JAX package holds its
  pair kernel to its own two single steps at atol 4e-5 (same summation
  order, ``tests/test_pallas.py``); the plain version sums in another
  order, and with these inputs d and x reach 50-120, where f32 steps
  differ by 1.2e-4 (2.5e-6 of the scale; r, of scale 2.5, by 5.7e-6);
* ``chebyshev_apply`` with the pair step against the JAX package's
  ``_chebyshev_canon(pair_tables=...)`` at degree 4 (one pair and one odd
  trailing single step) and 5 (two pairs), f32, to 3e-5 max|ref|;
* the level rule ``gmg.cheb_pair_level`` equal to JAX's ``cheb2_supported``
  with its switch on, on every level of refinements 3-8 at p = 1-4;
* a ``cheb_pair`` V-cycle (the K3dg threshold lowered so small levels take
  the pair step) calls K8 on exactly the levels of the rule, and equals
  the single-step V-cycle to f64 round-off; the mesh V-cycle ignores the
  option; the schemes thread it, defaulting to ``SPIRK_CHEB_PAIR``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# one intra-op thread: the tests run beside other test processes, and small
# tensors lose far more to thread contention than they gain (the counts do
# not depend on it)
torch.set_num_threads(1)

from dealii_spirk_tpu.fem.grid import make_level
from dealii_spirk_tpu.ops.mass_laplace import level_ops as jlevel_ops
from dealii_spirk_tpu.ops.pallas import stencil as jst
from dealii_spirk_tpu.solvers.gmg import _chebyshev_canon
import dealii_spirk_tpu_torch.config as tconfig
import dealii_spirk_tpu_torch.solvers.gmg as tgmg
from dealii_spirk_tpu_torch.config import Parameters as TParameters
from dealii_spirk_tpu_torch.fem.grid import make_space as tmake_space
from dealii_spirk_tpu_torch.interop import level_ops_from_numpy, sharded_block_to_numpy
from dealii_spirk_tpu_torch.ops.cuda import stencil as tst
from dealii_spirk_tpu_torch.parallel.mesh import make_mesh
from dealii_spirk_tpu_torch.parallel.sharding import scatter
from dealii_spirk_tpu_torch.problem import HeatProblem
from dealii_spirk_tpu_torch.runner import run_config as trun_config
from dealii_spirk_tpu_torch.schemes import make_scheme
from dealii_spirk_tpu_torch.solvers.chebyshev import chebyshev_apply
from test_torch_setup import same_tables_route  # noqa: F401 (autouse: one tables route)

REL_PAIR = 1e-5
REL_SMOOTH = 3e-5


def _setup(ref, p, q, seed):
    lev = make_level(ref, p)
    sp = (lev.m,) * 3
    jops = jlevel_ops(lev, jnp.float32, with_dense=False)
    tops = level_ops_from_numpy(
        lev.mass_band, lev.stiff_band, lev.mass_diag, lev.stiff_diag, dtype=torch.float32
    )
    rng = np.random.default_rng(seed)

    def field():
        return rng.standard_normal((q,) + sp).astype(np.float32)

    return sp, jops, tops, field


@pytest.mark.parametrize("p,ref", [(1, 4), (2, 3)])
def test_k8_plain_version_matches_pallas(p, ref):
    q = 2
    sp, jops, tops, field = _setup(ref, p, q, 7 + p)
    d, r, x = field(), field(), field()
    a = np.asarray([1.3, 0.8], np.float32)
    b = 0.21
    c1a, c2a, c1b, c2b = 0.7, 0.4, 0.55, 0.3
    pc = lambda u: jst.pad_canon(jnp.asarray(u), sp, p, 3)
    want = jst.fused_cheb_pair_canon(
        jops, jnp.asarray(a), b, c1a, c2a, c1b, c2b, pc(d), pc(r), pc(x), 3,
        diag_tables=jst.cheb_diag_tables(jops, sp, p, 3),
        pair_tables=jst.cheb2_tables(jops, sp, p, 3), interpret=True, force_yb=8,
    )
    t = torch.as_tensor
    got = tst.cheb_pair_dg_ref(tops, t(a), b, c1a, c2a, c1b, c2b, t(d), t(r), t(x))
    for g, w in zip(got, want):
        w = np.asarray(jst.unpad_canon(w, sp, 3))
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=REL_PAIR * np.abs(w).max())


@pytest.mark.parametrize("degree", [4, 5])
def test_pair_smoother_matches_jax(degree):
    """Degree 4: one pair and the odd trailing single step; 5: two pairs."""
    p, ref, q = 1, 4, 2
    sp, jops, tops, field = _setup(ref, p, q, 11)
    r = field()
    a = np.asarray([1.5, 4.0], np.float32)
    b = 0.1
    theta, delta = np.asarray([2.0, 2.4], np.float32), np.asarray([1.1, 1.3], np.float32)
    want = _chebyshev_canon(
        jops, jnp.asarray(a), b, None, jnp.asarray(theta), jnp.asarray(delta),
        jst.pad_canon(jnp.asarray(r), sp, p, 3), 3, degree=degree, interpret=True,
        diag_tables=jst.cheb_diag_tables(jops, sp, p, 3),
        pair_tables=jst.cheb2_tables(jops, sp, p, 3),
    )
    want = np.asarray(jst.unpad_canon(want, sp, 3))
    t = torch.as_tensor
    ta = t(a)
    diag = tst.cheb_diag(tops, ta, b, t(r))
    calls = {"pair": 0, "single": 0}

    def single(c1, c2, d, rr, x):
        calls["single"] += 1
        return tst.cheb_iter_dg_ref(tops, ta, b, c1, c2, d, rr, x)

    def pair(c1a, c2a, c1b, c2b, d, rr, x):
        calls["pair"] += 1
        return tst.cheb_pair_dg_ref(tops, ta, b, c1a, c2a, c1b, c2b, d, rr, x)

    got = chebyshev_apply(
        lambda u: tst.stencil_apply_ref(tops, ta, b, u), single, lambda u: u / diag,
        t(theta), t(delta), t(r), degree=degree, cheb_pair=pair,
    )
    assert calls == {"pair": (degree - 1) // 2, "single": (degree - 1) % 2}
    np.testing.assert_allclose(got.numpy(), want, atol=REL_SMOOTH * np.abs(want).max())


@pytest.mark.parametrize("p", [1, 2, 3, 4])
def test_pair_level_rule_matches_jax(p, monkeypatch):
    """Every level of the GMG chains of refinements 3-8 (3D), with the JAX
    package's switch on; K8 is 3D only."""
    monkeypatch.setattr(jst, "_CHEB_PAIR", True)
    picked = 0
    for ref in range(3, 9):
        for lev in tmake_space(3, p, ref).levels:
            sp = (lev.m,) * 3
            want = jst.cheb2_supported(sp, p, 3, 6)
            assert tgmg.cheb_pair_level(lev.m, 3, p) == want, (ref, lev.m)
            picked += want
    assert picked > 0
    assert not tgmg.cheb_pair_level(1023, 2, p)


def _vcycle_setup(ref, seed, a):
    space = tmake_space(3, 1, ref)
    gmg = tgmg.build_gmg_data(space)
    a = torch.tensor(a, dtype=torch.float64)
    prec = tgmg.gmg_reinit(gmg, a, 0.1, 3)
    r = torch.as_tensor(
        np.random.default_rng(seed).standard_normal((len(a),) + space.shape))
    return gmg, a, prec, r


def _spy(monkeypatch, name):
    calls = []
    real = getattr(tst, name)

    def spy(ops, *args):
        calls.append(ops.m)
        return real(ops, *args)

    monkeypatch.setattr(tst, name, spy)
    return calls


def test_vcycle_pair_arm_on_the_rule_levels(monkeypatch):
    """With the K3dg threshold lowered, refinement 5 smooths m = 31 and 15
    with K3dg; a ``cheb_pair`` V-cycle takes both levels' steps two at a
    time (2 smooths x 2 pair calls each), no single K3dg step, and equals
    the single-step V-cycle to f64 round-off."""
    monkeypatch.setattr(tgmg, "CHEB_DIAG_MIN_POINTS", 1000)
    gmg, a, prec, r = _vcycle_setup(5, 4, [1.5, 4.0])
    smoothed = [ops.m for ops in gmg.level_ops[1:]]
    assert smoothed == [15, 31]
    want = tgmg.vcycle(gmg, prec, a, 0.1, r, 3, kernels=True)
    pairs, singles = _spy(monkeypatch, "cheb_pair_dg"), _spy(monkeypatch, "cheb_iter_dg")
    got = tgmg.vcycle(gmg, prec, a, 0.1, r, 3, kernels=True, cheb_pair=True)
    rule = [m for m in smoothed if tgmg.cheb_pair_level(m, 3, 1)]
    assert rule == smoothed
    assert sorted(pairs) == sorted(rule * 4) and singles == []
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-12 * float(want.abs().max()))
    # the plain arm and the default leave it alone
    pairs.clear()
    tgmg.vcycle(gmg, prec, a, 0.1, r, 3, kernels=False, cheb_pair=True)
    tgmg.vcycle(gmg, prec, a, 0.1, r, 3, kernels=True)
    assert pairs == []


def test_mesh_vcycle_ignores_cheb_pair(monkeypatch):
    """On a (3, 2) slot mesh the V-cycle takes single steps (K9d on the
    lowered-threshold levels) whatever ``cheb_pair`` says, as the JAX
    package keeps single steps on a mesh; the result is the same."""
    monkeypatch.setattr(tgmg, "CHEB_DIAG_MIN_POINTS", 1000)
    gmg, a, prec, r = _vcycle_setup(4, 5, [1.5, 4.0, 2.5])
    mesh = make_mesh(3, devices=["cpu"] * 6)
    mp = tgmg.scatter_prec(gmg, prec, a, 3, mesh)
    rb = scatter(r, mesh, kind=None)
    pairs = _spy(monkeypatch, "cheb_pair_dg")
    halo_dg = _spy(monkeypatch, "cheb_iter_dg_halo")
    got = tgmg.vcycle(gmg, mp, a, 0.1, rb, 3, kernels=True, mesh=mesh, cheb_pair=True)
    assert pairs == [] and len(halo_dg) == 8 * mesh.slot_ids.size
    want = tgmg.vcycle(gmg, mp, a, 0.1, rb, 3, kernels=True, mesh=mesh)
    np.testing.assert_array_equal(sharded_block_to_numpy(got), sharded_block_to_numpy(want))


def test_schemes_thread_cheb_pair(monkeypatch):
    """``run_config(cheb_pair=True)`` reaches the V-cycles of a scheme (the
    same counts and solution as without it, at f64); the default is read
    from ``SPIRK_CHEB_PAIR`` once, in ``config``."""
    monkeypatch.setattr(tgmg, "CHEB_DIAG_MIN_POINTS", 1000)
    cfg = {
        "FEDegree": 1, "NRefinements": 4, "TimeIntegrationScheme": "complex_irk_batched",
        "IRKStages": 3, "TimeStepSize": 0.1, "EndTime": 0.2, "OperatorType": "MatrixFree",
        "BlockPreconditionerType": "GMG", "InnerTolerance": 0.0, "OuterTolerance": 1e-8,
        "Precision": "f64", "DoOutputParaview": False,
    }
    params = TParameters.from_dict(cfg, dim=3)
    single = trun_config(params, device="cpu", verbose=False, kernels=True)
    pairs = _spy(monkeypatch, "cheb_pair_dg")
    paired = trun_config(params, device="cpu", verbose=False, kernels=True, cheb_pair=True)
    assert pairs and set(pairs) == {15}
    assert paired["scheme"].step_log == single["scheme"].step_log
    np.testing.assert_allclose(paired["u"].numpy(), single["u"].numpy(), rtol=0,
                               atol=1e-11 * float(single["u"].abs().max()))
    problem = HeatProblem(params, device="cpu")
    assert make_scheme(problem, params).cheb_pair is tconfig.CHEB_PAIR
    monkeypatch.setattr(tconfig, "CHEB_PAIR", True)
    assert make_scheme(problem, params).cheb_pair is True
    assert make_scheme(problem, params, cheb_pair=False).cheb_pair is False


def test_k8_wrapper_runs_plain_version_on_cpu():
    q = 3
    _sp, _jops, tops, field = _setup(3, 1, q, 5)
    t = torch.as_tensor
    d, r, x = t(field()), t(field()), t(field())
    a = t(np.asarray([0.5, 1.0, 2.0], np.float32))
    tst.reset_launches()
    for g, w in zip(
        tst.cheb_pair_dg(tops, a, 0.1, 0.5, 0.2, 0.6, 0.3, d, r, x),
        tst.cheb_pair_dg_ref(tops, a, 0.1, 0.5, 0.2, 0.6, 0.3, d, r, x),
    ):
        assert torch.equal(g, w)
    assert tst.LAUNCHES == {k: 0 for k in tst.LAUNCHES}
