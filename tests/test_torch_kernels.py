"""The plain versions of the port's kernels K1-K5, 3D and 2D (``*_ref``
in ``dealii_spirk_tpu_torch/ops/cuda/stencil.py``) against the JAX
package's Pallas kernels, run in interpret mode on the canonical layout
(K5 also on the compact layout, ``fused_mass_stiffness_apply``), at f32.

Same numpy inputs for both; the port works on the compact (q, m, m, m)
layout, JAX on the canonical one (``pad_canon``/``unpad_canon``).
Tolerance: ``max|diff| <= 1e-5 * max|ref|`` — f32 sums taken in another
order.  Also: the public wrappers run the plain version on CPU tensors
and launch nothing.  The CUDA kernels themselves run only on the card
(``chip_smoke.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dealii_spirk_tpu.fem.grid import make_level
from dealii_spirk_tpu.ops.mass_laplace import level_ops as jlevel_ops
from dealii_spirk_tpu.ops.pallas import stencil as jst
from dealii_spirk_tpu_torch.interop import level_ops_from_numpy
from dealii_spirk_tpu_torch.ops.cuda import build as tbuild
from dealii_spirk_tpu_torch.ops.cuda import stencil as tst

REL = 1e-5
SHAPES = [(3, 4), (4, 4), (3, 5), (4, 5)]  # (q, refinement): m = 15, 31


SHAPES_K5 = [(1, 4), (4, 5), (5, 4)]  # q in {1, 4, 5}
SHAPES_2D = [(1, 4), (4, 5), (5, 6)]  # m = 15, 31, 63


def _setup(q, ref, seed, dim=3):
    lev = make_level(ref, 1)
    sp = (lev.m,) * dim
    jops = jlevel_ops(lev, jnp.float32, with_dense=False)
    tops = level_ops_from_numpy(
        lev.mass_band, lev.stiff_band, lev.mass_diag, lev.stiff_diag,
        dtype=torch.float32,
    )
    rng = np.random.default_rng(seed)

    def field(lo=-1.0, hi=1.0):
        return rng.uniform(lo, hi, (q,) + sp).astype(np.float32)

    return sp, jops, tops, rng, field


def _pad(u, sp):
    return jst.pad_canon(jnp.asarray(u), sp, 1, len(sp))


def _check(got, want_c, sp):
    want = np.asarray(jst.unpad_canon(want_c, sp, len(sp)))
    assert got.shape == want.shape
    err = np.abs(got.numpy() - want).max()
    assert err <= REL * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("q,ref", SHAPES)
def test_k1_ms_mix_matches_pallas(q, ref):
    sp, jops, tops, rng, field = _setup(q, ref, 1)
    u = field()
    ainv = rng.uniform(-2, 2, (q, q)).astype(np.float32)
    tau = 0.0371
    want = jst.fused_ms_mix_apply_canon(
        jops, jnp.asarray(ainv), tau, _pad(u, sp), 3, interpret=True
    )
    got = tst.ms_mix_apply_ref(tops, torch.as_tensor(ainv), tau, torch.as_tensor(u))
    _check(got, want, sp)


@pytest.mark.parametrize("q,ref", SHAPES)
def test_k2_stage_mix_matches_pallas(q, ref):
    sp, _jops, _tops, rng, field = _setup(q, ref, 2)
    W = field()
    mat = rng.uniform(-1, 1, (q, q)).astype(np.float32)
    want = jst.stage_mix_canon(jnp.asarray(mat), _pad(W, sp), interpret=True)
    got = tst.stage_mix_ref(torch.as_tensor(mat), torch.as_tensor(W))
    _check(got, want, sp)


@pytest.mark.parametrize("q,ref", SHAPES)
def test_k3_cheb_iter_matches_pallas(q, ref):
    sp, jops, tops, rng, field = _setup(q, ref, 3)
    d, r, x = field(), field(), field()
    invd = field(0.5, 1.5)
    a = rng.uniform(0.5, 2.0, q).astype(np.float32)
    c1 = rng.uniform(0.2, 0.9, q).astype(np.float32)
    c2 = rng.uniform(0.1, 0.5, q).astype(np.float32)
    b = 0.043
    want = jst.fused_cheb_iter_canon(
        jops, jnp.asarray(a), b, jnp.asarray(c1), jnp.asarray(c2),
        _pad(d, sp), _pad(r, sp), _pad(x, sp), _pad(invd, sp), 3, interpret=True,
    )
    t = torch.as_tensor
    got = tst.cheb_iter_ref(tops, t(a), b, t(c1), t(c2), t(d), t(r), t(x), t(invd))
    for g, w in zip(got, want):
        _check(g, w, sp)


@pytest.mark.parametrize("q,ref", SHAPES)
def test_k4_stencil_apply_matches_pallas(q, ref):
    sp, jops, tops, rng, field = _setup(q, ref, 4)
    u = field()
    a = rng.uniform(0.5, 2.0, q).astype(np.float32)
    b = 0.043
    want = jst.fused_stencil_apply_canon(
        jops, jnp.asarray(a), b, _pad(u, sp), 3, interpret=True
    )
    got = tst.stencil_apply_ref(tops, torch.as_tensor(a), b, torch.as_tensor(u))
    _check(got, want, sp)


@pytest.mark.parametrize("dim,q,ref", [(3, *s) for s in SHAPES_K5] + [(2, *s) for s in SHAPES_2D])
def test_k5_mass_stiffness_matches_pallas(dim, q, ref):
    sp, jops, tops, _rng, field = _setup(q, ref, 6, dim)
    u = field()
    want = jst.fused_mass_stiffness_apply_canon(jops, _pad(u, sp), dim, interpret=True)
    got = tst.mass_stiffness_apply_ref(tops, torch.as_tensor(u))
    for g, w in zip(got, want):
        _check(g, w, sp)


@pytest.mark.parametrize("dim,q,ref", [(3, *s) for s in SHAPES_K5] + [(2, *s) for s in SHAPES_2D])
def test_k5_mass_stiffness_matches_compact_pallas(dim, q, ref):
    """The compact-layout kernel the JAX package's ``irk`` vmult reaches
    (K6b, ``fused_mass_stiffness_apply``): K5 is its counterpart."""
    sp, jops, tops, _rng, field = _setup(q, ref, 7, dim)
    u = field()
    want = jst.fused_mass_stiffness_apply(jops, jnp.asarray(u), dim, interpret=True)
    got = tst.mass_stiffness_apply_ref(tops, torch.as_tensor(u))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g.numpy() - w).max() <= REL * np.abs(w).max()


@pytest.mark.parametrize("q,ref", SHAPES_2D)
def test_k4_2d_stencil_apply_matches_pallas(q, ref):
    sp, jops, tops, rng, field = _setup(q, ref, 8, dim=2)
    u = field()
    a = rng.uniform(0.5, 2.0, q).astype(np.float32)
    b = 0.043
    want = jst.fused_stencil_apply_canon(
        jops, jnp.asarray(a), b, _pad(u, sp), 2, interpret=True
    )
    got = tst.stencil_apply_ref(tops, torch.as_tensor(a), b, torch.as_tensor(u))
    _check(got, want, sp)


def test_wrappers_run_plain_version_on_cpu():
    q, ref = 4, 3
    _sp, _jops, tops, rng, field = _setup(q, ref, 5)
    t = lambda arr: torch.as_tensor(arr)
    u, d, r, x, invd = (t(field()) for _ in range(5))
    a = t(rng.uniform(0.5, 2.0, q).astype(np.float32))
    mat = t(rng.uniform(-1, 1, (q, q)).astype(np.float32))
    tst.reset_launches()
    pairs = [
        (tst.ms_mix_apply(tops, mat, 0.1, u), tst.ms_mix_apply_ref(tops, mat, 0.1, u)),
        (tst.stage_mix(mat, u), tst.stage_mix_ref(mat, u)),
        (tst.stencil_apply(tops, a, 0.1, u), tst.stencil_apply_ref(tops, a, 0.1, u)),
        (tst.stencil_apply(tops, a, 0.1, u[:, 0]), tst.stencil_apply_ref(tops, a, 0.1, u[:, 0])),
    ]
    pairs += list(zip(tst.mass_stiffness_apply(tops, u), tst.mass_stiffness_apply_ref(tops, u)))
    pairs += list(zip(
        tst.cheb_iter(tops, a, 0.1, 0.5, 0.2, d, r, x, invd),
        tst.cheb_iter_ref(tops, a, 0.1, 0.5, 0.2, d, r, x, invd),
    ))
    for got, want in pairs:
        assert torch.equal(got, want)
    assert tst.LAUNCHES == {k: 0 for k in tst.LAUNCHES}


def test_coefficient_table_and_device_checks():
    # the (q,) tables every march launch (K8's five too) reads by pointer
    tabs = [tst._stage_coefs(c, 3, torch.device("cpu"))
            for c in (torch.tensor([1.0, 2.0, 3.0]), 0.5, torch.tensor(7.0))]
    for tab in tabs:
        assert tab.dtype == torch.float32 and tab.shape == (3,) and tab.is_contiguous()
    np.testing.assert_array_equal(
        torch.stack(tabs, dim=1).numpy(), [[1.0, 0.5, 7.0], [2.0, 0.5, 7.0], [3.0, 0.5, 7.0]]
    )
    meta = torch.empty((2, 3, 3, 3), device="meta")
    with pytest.raises(ValueError, match="CPU or all on CUDA"):
        tst._on_cpu(torch.zeros(2), meta)
    # one LAUNCHES key per entry point: 3D and 2D blocks count apart
    assert tst._entry("stencil_apply", meta) == "stencil_apply"
    assert tst._entry("mass_stiffness_apply", meta[0]) == "mass_stiffness_apply_2d"
    assert set(tst.LAUNCHES) == {
        name.removeprefix("spirk_") for name in tbuild.SIGNATURES
    }


def test_block_checks():
    """What the CUDA wrappers accept before a launch: (q, m, m, m) and
    (q, m, m) f32 contiguous blocks of the level's m, degrees 1-4."""
    lev = make_level(3, 1)
    ops = level_ops_from_numpy(
        lev.mass_band, lev.stiff_band, lev.mass_diag, lev.stiff_diag, dtype=torch.float32
    )
    m = lev.m
    assert tst._check_block(ops, torch.zeros((4, m, m, m)), "u") == (4, m, 1)
    assert tst._check_block(ops, torch.zeros((5, m, m)), "u") == (5, m, 1)
    with pytest.raises(ValueError, match="stage blocks"):
        tst._check_block(ops, torch.zeros((m, m)), "u")
    with pytest.raises(ValueError, match="expected shape"):
        tst._check_block(ops, torch.zeros((4, m, m + 1)), "u")
    with pytest.raises(TypeError, match="float32"):
        tst._check_block(ops, torch.zeros((4, m, m), dtype=torch.float64), "u")
    with pytest.raises(ValueError, match="contiguous"):
        tst._check_block(ops, torch.zeros((4, m, m)).transpose(1, 2), "u")
