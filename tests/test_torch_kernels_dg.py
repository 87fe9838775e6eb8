"""K3dg and the compact/padded TPU kernels whose counterparts are K3/K4.

* ``cheb_iter_dg_ref`` (the plain version of the port's K3dg,
  ``ops/cuda/stencil.py``) against the JAX package's
  ``fused_cheb_iter_canon(..., diag_tables=cheb_diag_tables(...))`` in
  interpret mode, whole-plane and y-blocked (``force_yb``), p = 1 and 2,
  at f32: ``max|diff| <= 1e-6 * max|ref|`` (f32 sums in another order);
* the port's K3dg level rule (``gmg.cheb_diag_level``) against the JAX
  package's ``cheb_diag_supported`` on every level of refinements 3-8 at
  p = 1-4;
* the kernel V-cycle's K3dg arm (the rule lowered so small levels take
  it) against its D^-1 arm at f64;
* K6a ``fused_stencil_apply`` (compact layout, 2D and 3D), K7a
  ``fused_stencil_apply_padded`` and K7b ``fused_cheb_iter_padded`` (the
  halo-block padded layout) in interpret mode against the port's K4/K3
  plain versions on the compact layout, at f32 to ``1e-5 * max|ref|``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dealii_spirk_tpu.fem.grid import make_level, make_space
from dealii_spirk_tpu.ops.mass_laplace import level_ops as jlevel_ops
from dealii_spirk_tpu.ops.pallas import stencil as jst
import dealii_spirk_tpu_torch.solvers.gmg as tgmg
from dealii_spirk_tpu_torch.fem.grid import make_space as tmake_space
from dealii_spirk_tpu_torch.interop import level_ops_from_numpy
from dealii_spirk_tpu_torch.ops.cuda import stencil as tst

REL_DG = 1e-6
REL = 1e-5


def _setup(ref, p, q, seed, dim=3):
    lev = make_level(ref, p)
    sp = (lev.m,) * dim
    jops = jlevel_ops(lev, jnp.float32, with_dense=False)
    tops = level_ops_from_numpy(
        lev.mass_band, lev.stiff_band, lev.mass_diag, lev.stiff_diag, dtype=torch.float32
    )
    rng = np.random.default_rng(seed)

    def field(lo=-1.0, hi=1.0):
        return rng.uniform(lo, hi, (q,) + sp).astype(np.float32)

    def vec(lo, hi):
        return rng.uniform(lo, hi, q).astype(np.float32)

    return sp, jops, tops, field, vec


def _close(got, want, rel):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("p,ref,force_yb", [(1, 4, 0), (1, 4, 8), (2, 3, 0), (2, 3, 8)])
def test_k3dg_matches_pallas(p, ref, force_yb):
    q = 3
    sp, jops, tops, field, vec = _setup(ref, p, q, 10 + p)
    d, r, x = field(), field(), field()
    a, c1, c2 = vec(0.5, 2.0), vec(0.2, 0.9), vec(0.1, 0.5)
    b = 0.043
    pc = lambda u: jst.pad_canon(jnp.asarray(u), sp, p, 3)
    want = jst.fused_cheb_iter_canon(
        jops, jnp.asarray(a), b, jnp.asarray(c1), jnp.asarray(c2), pc(d), pc(r), pc(x),
        None, 3, interpret=True, force_yb=force_yb,
        diag_tables=jst.cheb_diag_tables(jops, sp, p, 3),
    )
    t = torch.as_tensor
    got = tst.cheb_iter_dg_ref(tops, t(a), b, t(c1), t(c2), t(d), t(r), t(x))
    for g, w in zip(got, want):
        _close(g, jst.unpad_canon(w, sp, 3), REL_DG)


@pytest.mark.parametrize("p", [1, 2, 3, 4])
def test_k3dg_level_rule_matches_jax(p):
    """Every level of the GMG chains of refinements 3-8 (3D; the coarsest
    level never smooths, the rule is asked of all)."""
    for ref in range(3, 9):
        for lev in tmake_space(3, p, ref).levels:
            sp = (lev.m,) * 3
            assert tgmg.cheb_diag_level(lev.m, 3) == jst.cheb_diag_supported(sp, p, 3), (ref, lev.m)
    assert not tgmg.cheb_diag_level(1023, 2)  # K3dg is 3D only


def test_vcycle_k3dg_arm_matches_invd_arm(monkeypatch):
    """The kernel V-cycle with K3dg on every smoothed level (the rule
    lowered; on CPU tensors the wrappers run their plain versions) equals
    the D^-1 arm to f64 round-off: dividing by the diagonal instead of
    multiplying by its inverse."""
    space = tmake_space(3, 1, 4)
    gmg = tgmg.build_gmg_data(space)
    a = torch.tensor([1.5, 4.0, 2.5], dtype=torch.float64)
    prec = tgmg.gmg_reinit(gmg, a, 0.1, 3)
    r = torch.as_tensor(np.random.default_rng(4).standard_normal((3,) + space.shape))
    want = tgmg.vcycle(gmg, prec, a, 0.1, r, 3, kernels=True)
    calls = []
    real = tst.cheb_iter_dg
    monkeypatch.setattr(tst, "cheb_iter_dg", lambda *args: calls.append(1) or real(*args))
    monkeypatch.setattr(tgmg, "CHEB_DIAG_MIN_POINTS", 1000)
    got = tgmg.vcycle(gmg, prec, a, 0.1, r, 3, kernels=True)
    assert len(calls) == 8 * (len(gmg.level_ops) - 1)
    _close(got, want, 1e-12)


def test_k3dg_wrapper_runs_plain_version_on_cpu():
    q = 4
    _sp, _jops, tops, field, vec = _setup(3, 1, q, 5)
    t = torch.as_tensor
    d, r, x = t(field()), t(field()), t(field())
    a = t(vec(0.5, 2.0))
    tst.reset_launches()
    for g, w in zip(
        tst.cheb_iter_dg(tops, a, 0.1, 0.5, 0.2, d, r, x),
        tst.cheb_iter_dg_ref(tops, a, 0.1, 0.5, 0.2, d, r, x),
    ):
        assert torch.equal(g, w)
    assert tst.LAUNCHES == {k: 0 for k in tst.LAUNCHES}


# (TPU kernel, dim, p, refinement)
COUNTERPARTS = [
    ("K6a", 3, 1, 4),
    ("K6a", 3, 2, 3),
    ("K6a", 2, 1, 5),
    ("K7a", 3, 1, 4),
    ("K7a", 3, 2, 3),
    ("K7a", 2, 1, 5),
    ("K7b", 3, 1, 4),
    ("K7b", 3, 2, 3),
]


@pytest.mark.parametrize("kernel,dim,p,ref", COUNTERPARTS)
def test_compact_and_padded_kernels_match_k4_k3(kernel, dim, p, ref):
    q = 3
    sp, jops, tops, field, vec = _setup(ref, p, q, 20 + ref + p, dim)
    a = vec(0.5, 2.0)
    b = 0.043
    t = torch.as_tensor
    pad = lambda u: jst.pad_field(jnp.asarray(u), sp, p, dim)
    unpad = lambda u: jst.unpad_field(u, sp, p, dim)
    if kernel == "K7b":
        d, r, x, invd = field(), field(), field(), field(0.5, 1.5)
        c1, c2 = vec(0.2, 0.9), vec(0.1, 0.5)
        want = jst.fused_cheb_iter_padded(
            jops, jnp.asarray(a), b, jnp.asarray(c1), jnp.asarray(c2),
            pad(d), pad(r), pad(x), pad(invd), sp, dim, interpret=True,
        )
        got = tst.cheb_iter_ref(tops, t(a), b, t(c1), t(c2), t(d), t(r), t(x), t(invd))
        for g, w in zip(got, want):
            _close(g, unpad(w), REL)
        return
    u = field()
    if kernel == "K6a":
        want = jst.fused_stencil_apply(jops, jnp.asarray(a), b, jnp.asarray(u), dim,
                                       interpret=True)
    else:
        want = unpad(jst.fused_stencil_apply_padded(jops, jnp.asarray(a), b, pad(u), sp, dim,
                                                    interpret=True))
    _close(tst.stencil_apply_ref(tops, t(a), b, t(u)), want, REL)
