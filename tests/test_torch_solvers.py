"""The port's solvers (Krylov, Chebyshev, GMG) against the JAX package's
at f64 on the same numpy inputs: iteration counts exactly equal, iterates
to round-off (rtol 1e-10).  The JAX package's GMG hierarchies, their
states and V-cycles are built once per module (``functools.cache``) and
shared by the tests that take the same inputs."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dealii_spirk_tpu.solvers.chebyshev as jcheb
import dealii_spirk_tpu.solvers.gmg as jgmg
import dealii_spirk_tpu.solvers.krylov as jkry
from dealii_spirk_tpu.fem.grid import make_level, make_space
from dealii_spirk_tpu.ops.mass_laplace import (
    apply_mass_stiffness_batched as japply_ms,
    apply_shifted_batched as japply_shifted,
    level_ops as jlevel_ops,
)
from dealii_spirk_tpu.tables import irk_tables
import dealii_spirk_tpu_torch.solvers.chebyshev as tcheb
import dealii_spirk_tpu_torch.solvers.gmg as tgmg
import dealii_spirk_tpu_torch.solvers.krylov as tkry
from dealii_spirk_tpu_torch.interop import (
    gmg_data_from_numpy,
    gmg_prec_from_numpy,
    level_ops_from_numpy,
)
from dealii_spirk_tpu_torch.ops.cuda import stencil as tst
from dealii_spirk_tpu_torch.ops.mass_laplace import apply_shifted_batched as tapply_shifted
from test_torch_setup import same_tables_route  # noqa: F401 (autouse: one tables route)

RTOL = 1e-10
Q = 4


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * float(np.abs(want).max()))


def _level(ref, p=1):
    lev = make_level(ref, p)
    jops = jlevel_ops(lev, jnp.float64, with_dense=False)
    tops = level_ops_from_numpy(lev.mass_band, lev.stiff_band, lev.mass_diag, lev.stiff_diag)
    return lev, jops, tops


def _shifted_pair(ref):
    """The stage-batched SPD operators a_i M + b K of an IRK solve on one
    level, in both packages, with their inverse Jacobi diagonals."""
    lev, jops, tops = _level(ref)
    a = irk_tables(Q).D
    b = 0.1
    from dealii_spirk_tpu.ops.mass_laplace import operator_diagonal

    jinvd = 1.0 / jax.vmap(lambda ai: operator_diagonal(jops, ai, b, 3))(jnp.asarray(a))
    tinvd = torch.as_tensor(np.array(jinvd))
    jA = lambda u: japply_shifted(jops, jnp.asarray(a), b, u, 3, "stencil")
    tA = lambda u: tapply_shifted(tops, torch.as_tensor(a), b, u, 3)
    return lev, (jops, jA, jinvd), (tops, tA, tinvd), a, b


@pytest.mark.parametrize("batch", [False, True])
def test_pcg_matches(batch):
    lev, (_j, jA, jinvd), (_t, tA, tinvd), _a, _b = _shifted_pair(4)
    rhs = np.random.default_rng(1).standard_normal((Q,) + (lev.m,) * 3)
    kw = dict(maxiter=200, abstol=1e-30, reltol=1e-9, batch=batch)
    jr = jkry.pcg(jA, jnp.asarray(rhs), M=lambda r: jinvd * r, **kw)
    tr = tkry.pcg(tA, torch.as_tensor(rhs), M=lambda r: tinvd * r, **kw)
    if batch:
        np.testing.assert_array_equal(tr.n_iterations.numpy(), np.asarray(jr.n_iterations))
    else:
        assert tr.n_iterations == int(jr.n_iterations)
    _close(tr.x, jr.x)


@pytest.mark.parametrize("batch", [False, True])
def test_lanczos_eigs_match(batch):
    lev, (_j, jA, jinvd), (_t, tA, tinvd), _a, _b = _shifted_pair(4)
    rhs = np.random.default_rng(2).uniform(0, 1, (Q,) + (lev.m,) * 3)
    jl = jkry.cg_lanczos_extremal_eigs(jA, jnp.asarray(rhs), M=lambda r: jinvd * r, batch=batch)
    tl = tkry.cg_lanczos_extremal_eigs(tA, torch.as_tensor(rhs), M=lambda r: tinvd * r, batch=batch)
    for t, j in zip(tl, jl):
        _close(t, j)


def _coupled(ref):
    """The non-symmetric coupled IRK system (A^-1 (x) M + tau I (x) K) and a
    stateful Jacobi-block preconditioner that counts its calls."""
    lev, jops, tops = _level(ref)
    tabs = irk_tables(Q)
    tau = 0.1
    Ainv = tabs.A_inv

    def jA(W):
        MW, KW = japply_ms(jops, W, 3, "stencil")
        return (jnp.asarray(Ainv) @ MW.reshape(Q, -1)).reshape(W.shape) + tau * KW

    def tA(W):
        return tst.ms_mix_apply_ref(tops, torch.as_tensor(Ainv), tau, W)

    _l, (_j, _jA, jinvd), (_t, _tA, tinvd), _a, _b = _shifted_pair(ref)
    jM = lambda v, c: (jinvd * v, c + 1)
    tM = lambda v, c: (tinvd * v, c + 1)
    return lev, jA, tA, jM, tM


@pytest.mark.parametrize("restart", [28, 3])
def test_gmres_matches(restart):
    lev, jA, tA, jM, tM = _coupled(4)
    rhs = np.random.default_rng(3).standard_normal((Q,) + (lev.m,) * 3)
    kw = dict(maxiter=300, abstol=1e-20, reltol=1e-9, restart=restart)
    jr = jkry.gmres(jA, jnp.asarray(rhs), M=jM, M_carry=jnp.zeros(Q, jnp.int32), **kw)
    tr = tkry.gmres(tA, torch.as_tensor(rhs), M=tM, M_carry=np.zeros(Q, np.int64), **kw)
    assert tr.n_iterations == int(jr.n_iterations)
    np.testing.assert_array_equal(tr.M_carry, np.asarray(jr.M_carry))
    if restart == 3:
        assert tr.n_restarts > 0  # the restart path really ran
    _close(tr.x, jr.x)
    _close(tr.residual, jr.residual, rtol=1e-6)


@pytest.mark.parametrize("with_x0", [False, True])
def test_chebyshev_apply_matches(with_x0):
    lev, (jops, jA, jinvd), (tops, tA, tinvd), a, b = _shifted_pair(4)
    rng = np.random.default_rng(4)
    rhs = rng.standard_normal((Q,) + (lev.m,) * 3)
    x0 = rng.standard_normal(rhs.shape) if with_x0 else None
    theta = rng.uniform(1.0, 2.0, Q)
    delta = rng.uniform(0.3, 0.9, Q)
    want = jcheb.chebyshev_apply(
        jA, jinvd, jnp.asarray(theta), jnp.asarray(delta), jnp.asarray(rhs),
        x0=None if x0 is None else jnp.asarray(x0), batch=True,
    )
    ta = torch.as_tensor(a)
    got = tcheb.chebyshev_apply(
        lambda u: tst.stencil_apply(tops, ta, b, u),
        lambda c1, c2, d, r, x: tst.cheb_iter(tops, ta, b, c1, c2, d, r, x, tinvd),
        lambda r: tinvd * r, torch.as_tensor(theta), torch.as_tensor(delta),
        torch.as_tensor(rhs),
        x0=None if x0 is None else torch.as_tensor(x0),
    )
    _close(got, want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("dim", [2, 3])
def test_default_start_is_jax_uniform(dim, dtype):
    """The Lanczos start vector is bitwise ``jax.random.uniform(PRNGKey(42),
    shape, dtype)`` at every level shape of refinements 2-7."""
    for ref in range(2, 8):
        shape = (2**ref - 1,) * dim
        got = tgmg.default_start(shape, dtype)
        want = np.asarray(jax.random.uniform(jax.random.PRNGKey(42), shape, dtype=dtype))
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


@functools.cache
def _gmg_pair(ref, dim=3):
    space = make_space(dim, 1, ref)
    jg = jgmg.build_gmg_data(space, jnp.float64, with_dense=False)
    tg = gmg_data_from_numpy(
        [tuple(np.asarray(x) for x in (o.mass_band, o.stiff_band, o.mass_diag, o.stiff_diag))
         for o in jg.level_ops],
        [np.asarray(P) for P in jg.prolongs],
        np.asarray(jg.coarse_mass),
        np.asarray(jg.coarse_stiff),
    )
    return space, jg, tg


@pytest.mark.parametrize("ref", [4, 5])
def test_build_gmg_data_and_reinit_match(ref):
    space, jg, tg = _gmg_pair(ref)
    own = tgmg.build_gmg_data(space)
    assert [o.m for o in own.level_ops] == [o.m for o in jg.level_ops]
    assert own.level_ops[0].m == 7  # COARSE_SIZE_LIMIT truncation: 7^3 <= 1024 < 15^3
    _close(own.coarse_mass, jg.coarse_mass, rtol=1e-14)
    _close(own.coarse_stiff, jg.coarse_stiff, rtol=1e-14)
    d, jp, _tp = _prec_pair(ref, 0.1, 3)
    tp = tgmg.gmg_reinit(own, torch.as_tensor(d), 0.1, 3)
    for name in ("inv_diags", "thetas", "deltas"):
        for t, j in zip(getattr(tp, name), getattr(jp, name)):
            _close(t, j)
    _close(tp.coarse_inv, jp.coarse_inv)


@pytest.mark.parametrize("ref", [4, 5])
@pytest.mark.parametrize("kernels", [True, False])
def test_vcycle_matches(ref, kernels):
    _space, _jg, tg = _gmg_pair(ref)
    tau = 0.1
    d, _jp, tp = _prec_pair(ref, tau, 3)
    r, want = _jax_vcycle(ref, tau)
    got = tgmg.vcycle(tg, tp, torch.as_tensor(d), tau, torch.as_tensor(r), 3, kernels=kernels)
    _close(got, want)


def _prec_pair(ref, tau, dim):
    """The IRK stage diagonal D, JAX's GMG state of ``_gmg_pair(ref, dim)``
    (built once per module) and the port's copy of it."""
    d, jp = _jax_prec(ref, tau, dim)
    tp = gmg_prec_from_numpy(
        [np.asarray(x) for x in jp.inv_diags],
        [np.asarray(x) for x in jp.thetas],
        [np.asarray(x) for x in jp.deltas],
        np.asarray(jp.coarse_inv),
    )
    return d, jp, tp


@functools.cache
def _jax_prec(ref, tau, dim):
    d = irk_tables(Q).D
    jg = _gmg_pair(ref, dim)[1]
    return d, jgmg.gmg_reinit(jg, jnp.asarray(d), tau, dim, "stencil", batch=True)


@functools.cache
def _jax_vcycle(ref, tau):
    """A 3D right-hand side (seed 6) and JAX's batched V-cycle of it."""
    space, jg, _tg = _gmg_pair(ref)
    d, jp = _jax_prec(ref, tau, 3)
    r = np.random.default_rng(6).standard_normal((Q,) + space.shape)
    want = jax.jit(
        lambda rr: jgmg.vcycle(jg, jp, jnp.asarray(d), tau, rr, 3, "stencil", batch=True)
    )(jnp.asarray(r))
    return r, np.asarray(want)


@functools.cache
def _jax_vcycle_2d(tau):
    """A 2D right-hand side (seed 7) on refinement 6 and JAX's batched
    V-cycle of it."""
    space, jg, _tg = _gmg_pair(6, dim=2)
    d, jp = _jax_prec(6, tau, 2)
    r = np.random.default_rng(7).standard_normal((Q,) + space.shape)
    want = jgmg.vcycle(jg, jp, jnp.asarray(d), tau, jnp.asarray(r), 2, "stencil", batch=True)
    return r, np.asarray(want)


@pytest.mark.parametrize("kernels", [True, False])
def test_vcycle_2d_matches(kernels):
    """2D: the Chebyshev step is the elementwise chain over the apply
    (K4-2D with kernels), as the JAX package smooths 2D."""
    _space, _jg, tg = _gmg_pair(6, dim=2)
    assert len(tg.level_ops) == 2  # 63^2 smoothed, 31^2 solved densely
    tau = 0.1
    d, _jp, tp = _prec_pair(6, tau, 2)
    r, want = _jax_vcycle_2d(tau)
    got = tgmg.vcycle(tg, tp, torch.as_tensor(d), tau, torch.as_tensor(r), 2, kernels=kernels)
    _close(got, want)


@functools.cache
def _jax_stage_vcycle(tau, i):
    """A one-stage right-hand side (seed 8) on refinement 4 and JAX's
    non-batched V-cycle of it with stage ``i``'s state."""
    space, jg, _tg = _gmg_pair(4)
    d, jp = _jax_prec(4, tau, 3)
    r = np.random.default_rng(8).standard_normal(space.shape)
    jpi = jax.tree_util.tree_map(lambda x: x[i], jp)
    return r, np.asarray(jgmg.vcycle(jg, jpi, d[i], tau, jnp.asarray(r), 3, "stencil"))


@pytest.mark.parametrize("kernels", [True, False])
def test_stage_vcycle_matches(kernels):
    """One stage of the batched state (``stage_prec``, leading axis 1)
    against JAX's non-batched V-cycle on ``tree_map(x[i])`` of it — the
    sequential ``irk``'s per-stage preconditioner."""
    _space, _jg, tg = _gmg_pair(4)
    tau = 0.1
    d, _jp, tp = _prec_pair(4, tau, 3)
    i = 2
    r, want = _jax_stage_vcycle(tau, i)
    tpi = tgmg.stage_prec(tp, i)
    assert all(x.shape[0] == 1 for x in tpi.inv_diags + tpi.thetas + (tpi.coarse_inv,))
    got = tgmg.vcycle(
        tg, tpi, torch.as_tensor(d[i : i + 1]), tau, torch.as_tensor(r[None]), 3,
        kernels=kernels,
    )
    _close(got[0], want)
