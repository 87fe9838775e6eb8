"""The port's plain operators (ops/banded, ops/transfer, ops/mass_laplace)
against the JAX package's "stencil" mode at f64, on the same numpy
inputs (rtol 1e-12: the same operation order, other summation kernels)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dealii_spirk_tpu.ops.banded as jband
import dealii_spirk_tpu.ops.mass_laplace as jml
import dealii_spirk_tpu.ops.transfer as jtr
from dealii_spirk_tpu.fem.grid import make_level, make_space
import dealii_spirk_tpu_torch.ops.banded as tband
import dealii_spirk_tpu_torch.ops.mass_laplace as tml
import dealii_spirk_tpu_torch.ops.transfer as ttr
from dealii_spirk_tpu_torch.interop import level_ops_from_numpy

RTOL = 1e-12


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got.numpy(), want, rtol=RTOL, atol=RTOL * float(np.abs(want).max())
    )


def _ops(dim, p, ref):
    lev = make_level(ref, p)
    jops = jml.level_ops(lev, jnp.float64, with_dense=False)
    tops = level_ops_from_numpy(
        lev.mass_band, lev.stiff_band, lev.mass_diag, lev.stiff_diag
    )
    return lev, jops, tops


CASES = [(3, 1, 4), (3, 2, 3), (2, 1, 5), (2, 3, 3)]


@pytest.mark.parametrize("dim,p,ref", CASES)
def test_single_field_operators(dim, p, ref):
    lev, jops, tops = _ops(dim, p, ref)
    u = np.random.default_rng(1).standard_normal((lev.m,) * dim)
    ju, tu = jnp.asarray(u), torch.as_tensor(u)
    _close(tml.apply_mass(tops, tu, dim), jml.apply_mass(jops, ju, dim, "stencil"))
    _close(
        tml.apply_stiffness(tops, tu, dim), jml.apply_stiffness(jops, ju, dim, "stencil")
    )
    _close(
        tml.apply_shifted(tops, 1.7, 0.03, tu, dim),
        jml.apply_shifted(jops, 1.7, 0.03, ju, dim, "stencil"),
    )
    _close(
        tml.operator_diagonal(tops, 1.7, 0.03, dim),
        jml.operator_diagonal(jops, 1.7, 0.03, dim),
    )


@pytest.mark.parametrize("dim,p,ref", CASES)
def test_batched_operators(dim, p, ref):
    lev, jops, tops = _ops(dim, p, ref)
    rng = np.random.default_rng(2)
    q = 4
    W = rng.standard_normal((q,) + (lev.m,) * dim)
    a = rng.uniform(0.5, 3.0, q)
    jW, tW = jnp.asarray(W), torch.as_tensor(W)
    _close(
        tml.apply_shifted_batched(tops, torch.as_tensor(a), 0.05, tW, dim),
        jml.apply_shifted_batched(jops, jnp.asarray(a), 0.05, jW, dim, "stencil"),
    )
    tm, tk = tml.apply_mass_stiffness_batched(tops, tW, dim)
    jm, jk = jml.apply_mass_stiffness_batched(jops, jW, dim, "stencil")
    _close(tm, jm)
    _close(tk, jk)
    jdiag = np.stack(
        [np.asarray(jml.operator_diagonal(jops, ai, 0.05, dim)) for ai in a]
    )
    _close(tml.operator_diagonal(tops, torch.as_tensor(a), 0.05, dim), jdiag)


@pytest.mark.parametrize("axis", [0, 1, 2, -1])
def test_band_and_dense_1d(axis):
    lev = make_level(4, 2)
    u = np.random.default_rng(3).standard_normal((lev.m, lev.m, lev.m))
    _close(
        tband.apply_band(torch.as_tensor(lev.stiff_band), torch.as_tensor(u), axis),
        jband.apply_band(jnp.asarray(lev.stiff_band), jnp.asarray(u), axis),
    )
    mat = np.random.default_rng(4).standard_normal((7, lev.m))
    _close(
        tband.apply_dense_1d(torch.as_tensor(mat), torch.as_tensor(u), axis),
        jband.apply_dense_1d(jnp.asarray(mat), jnp.asarray(u), axis),
    )


@pytest.mark.parametrize("dim", [2, 3])
def test_transfers(dim):
    sp = make_space(dim, 1, 4)
    P = sp.prolongations[-1]
    rng = np.random.default_rng(5)
    uc = rng.standard_normal((3,) + (P.shape[1],) * dim)
    uf = rng.standard_normal((3,) + (P.shape[0],) * dim)
    got = ttr.prolong(torch.as_tensor(P), torch.as_tensor(uc), dim)
    assert got.is_contiguous()
    _close(got, jtr.prolong(jnp.asarray(P), jnp.asarray(uc), dim))
    got = ttr.restrict(torch.as_tensor(P), torch.as_tensor(uf), dim)
    assert got.is_contiguous()
    _close(got, jtr.restrict(jnp.asarray(P), jnp.asarray(uf), dim))
