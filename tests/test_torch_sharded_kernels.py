"""The port's space-sharded kernel layer (``ops/cuda/sharded.py`` over the
``*_halo_ref`` plain versions of the halo kernels K9a-K9d) on a (4, 2) mesh
of CPU slots, at f32, against

* the JAX package's ``sharded_*_canon(..., interpret=True)`` on its (4, 2)
  mesh of virtual CPU devices, same numpy inputs (the port on its compact
  layout, JAX on the canonical one): ``max|diff| <= 1e-5 * max|ref|``, the
  tolerance ``test_torch_kernels.py`` states — f32 sums in another order;
* the port's own unsharded ``*_ref`` on the whole field: exactly equal,
  which is what keeps iteration counts independent of the partition.

Also: ``transfer_z_plan`` and ``canon_shardable`` equal to the JAX
package's, and one V-cycle on the mesh against the JAX package's V-cycle
(f64, round-off) with its exchange counters equal to the structure and no
message above p (h) planes on a sharded level (the JAX V-cycle built once
per module and shared by both arms).  The CUDA halo kernels run only on
the card (``chip_smoke.py``)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import dealii_spirk_tpu.solvers.gmg as jgmg
from dealii_spirk_tpu.fem.grid import make_level, make_space
from dealii_spirk_tpu.ops.mass_laplace import level_ops as jlevel_ops, operator_diagonal
from dealii_spirk_tpu.ops.pallas import sharded as jsh
from dealii_spirk_tpu.ops.pallas import stencil as jst
from dealii_spirk_tpu.parallel.mesh import make_mesh as jmake_mesh
from dealii_spirk_tpu.tables import irk_tables
import dealii_spirk_tpu_torch.solvers.gmg as tgmg
from dealii_spirk_tpu_torch.interop import (
    gmg_data_from_numpy,
    gmg_prec_from_numpy,
    level_ops_from_numpy,
    mesh_prec_from_numpy,
    sharded_block_from_numpy,
    sharded_block_to_numpy,
)
from dealii_spirk_tpu_torch.ops.cuda import sharded as tsh
from dealii_spirk_tpu_torch.ops.cuda import stencil as tst
from dealii_spirk_tpu_torch.parallel import sharding as tshard
from dealii_spirk_tpu_torch.parallel.mesh import make_mesh as tmake_mesh
from test_torch_setup import same_tables_route  # noqa: F401 (autouse: one tables route)

REL = 1e-5
Q = 4
D_VEC = np.asarray([1.0, 2.5, 4.0, 8.0], np.float32)
TAU = 0.3
REF = {1: 4, 2: 3}  # refinement per degree: m = 15 both (z slabs of 8 + 7 planes)


def _setup(p, seed):
    """The level in both packages, the two (4, 2) meshes and a field maker."""
    lev = make_level(REF[p], p)
    sp = (lev.m,) * 3
    jops = jlevel_ops(lev, jnp.float32)
    tops = level_ops_from_numpy(
        lev.mass_band, lev.stiff_band, lev.mass_diag, lev.stiff_diag, dtype=torch.float32
    )
    jmesh = jmake_mesh(4)
    tmesh = tmake_mesh(4, devices=["cpu"] * 8)
    assert jst.canon_shardable(sp, p, 3, 2) and tshard.canon_shardable(sp, p, 3, 2)
    rng = np.random.default_rng(seed)
    spec = NamedSharding(jmesh, P("stage", "space", None, None))

    def field(lo=-1.0, hi=1.0):
        u = rng.uniform(lo, hi, (Q,) + sp).astype(np.float32)
        return u, jax.device_put(jst.pad_canon(jnp.asarray(u), sp, p, 3), spec), \
            sharded_block_from_numpy(u, tmesh, dtype=torch.float32)

    return sp, jops, tops, jmesh, tsh.shard_level(tops, tmesh), field


def _check(got_block, want_c, whole, sp):
    """Sharded port result: close to JAX's sharded one, equal to the
    port's unsharded plain version."""
    got = sharded_block_to_numpy(got_block)
    want = np.asarray(jst.unpad_canon(want_c, sp, 3))
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= REL * np.abs(want).max(), (err, np.abs(want).max())
    np.testing.assert_array_equal(got, whole.numpy())


@pytest.mark.parametrize("p", [1, 2])
def test_k9a_sharded_stencil_apply(p):
    sp, jops, tops, jmesh, level, field = _setup(p, 1)
    u, u_j, u_t = field()
    want = jsh.sharded_stencil_apply_canon(jops, jnp.asarray(D_VEC), TAU, u_j, jmesh,
                                           interpret=True)
    got = tsh.sharded_stencil_apply(level, torch.as_tensor(D_VEC), TAU, u_t, kernels=True)
    whole = tst.stencil_apply_ref(tops, torch.as_tensor(D_VEC), TAU, torch.as_tensor(u))
    _check(got, want, whole, sp)


@pytest.mark.parametrize("p", [1, 2])
def test_k9b_sharded_mass_stiffness(p):
    sp, jops, tops, jmesh, level, field = _setup(p, 2)
    u, u_j, u_t = field()
    want = jsh.sharded_mass_stiffness_apply_canon(jops, u_j, jmesh, interpret=True)
    got = tsh.sharded_mass_stiffness_apply(level, u_t, kernels=True)
    whole = tst.mass_stiffness_apply_ref(tops, torch.as_tensor(u))
    for g, w, wh in zip(got, want, whole):
        _check(g, w, wh, sp)


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("diag_tables", [False, True])
def test_k9cd_sharded_cheb_iter(p, diag_tables):
    sp, jops, tops, jmesh, level, field = _setup(p, 3)
    (d, d_j, d_t), (r, r_j, r_t), (x, x_j, x_t) = field(), field(), field()
    c1 = np.asarray([0.4, 0.5, 0.6, 0.7], np.float32)
    c2 = np.asarray([1.7, 1.1, 0.9, 0.3], np.float32)
    co_j = [jnp.asarray(D_VEC), TAU, jnp.asarray(c1), jnp.asarray(c2)]
    co_t = [torch.as_tensor(D_VEC), TAU, torch.as_tensor(c1), torch.as_tensor(c2)]
    whole_in = [torch.as_tensor(v) for v in (d, r, x)]
    if diag_tables:
        # the JAX kernel takes the diagonal tables on its y-blocked variant
        want = jsh.sharded_cheb_iter_canon(
            jops, *co_j, d_j, r_j, x_j, None, jmesh, interpret=True,
            diag_tables=jst.cheb_diag_tables(jops, sp, p, 3), force_yb=8,
        )
        got = tsh.sharded_cheb_iter(level, *co_t, d_t, r_t, x_t, None, kernels=True)
        whole = tst.cheb_iter_dg_ref(tops, *co_t, *whole_in)
    else:
        invd = np.asarray(
            jax.vmap(lambda ai: 1.0 / operator_diagonal(jops, ai, TAU, 3))(jnp.asarray(D_VEC))
        )
        spec = NamedSharding(jmesh, P("stage", "space", None, None))
        invd_j = jax.device_put(jst.pad_canon(jnp.asarray(invd), sp, p, 3), spec)
        invd_t = sharded_block_from_numpy(invd, level.mesh, dtype=torch.float32)
        want = jsh.sharded_cheb_iter_canon(jops, *co_j, d_j, r_j, x_j, invd_j, jmesh,
                                           interpret=True)
        got = tsh.sharded_cheb_iter(level, *co_t, d_t, r_t, x_t, invd_t, kernels=True)
        whole = tst.cheb_iter_ref(tops, *co_t, *whole_in, torch.as_tensor(invd))
    for g, w, wh in zip(got, want, whole):
        _check(g, w, wh, sp)


def test_halo_wrappers_check_and_count_nothing_on_cpu():
    """On CPU tensors the halo wrappers run their plain versions and
    launch nothing; a slab operand needs its slab operators."""
    sp, _jops, tops, _jmesh, level, field = _setup(1, 4)
    _u, _uj, u_t = field()
    tst.reset_launches()
    tshard.reset_exchange()
    u_h = tsh.exchange_z(u_t, 1)
    assert u_h[0][0].shape == (1, 8 + 2, 15, 15) and u_h[0][1].shape == (1, 7 + 2, 15, 15)
    assert float(u_h[0][0][:, 0].abs().max()) == 0.0  # domain ends: exact zeros
    assert float(u_h[0][1][:, -1].abs().max()) == 0.0
    np.testing.assert_array_equal(u_h[0][0][:, -1], u_t.parts[0][1][:, 0])
    np.testing.assert_array_equal(u_h[0][1][:, 0], u_t.parts[0][0][:, -1])
    # 4 stage rows, 2 messages of one 15 x 15 f32 plane each
    assert tshard.EXCHANGE["halo"] == 4 * 2 * 15 * 15 * 4
    assert tshard.HALO_MAX_PLANES["planes"] == 1
    a = torch.as_tensor(D_VEC[:1])
    got = tst.stencil_apply_halo(level.ops[0][1], a, TAU, u_h[0][1])
    want = tst.stencil_apply_halo_ref(level.ops[0][1], a, TAU, u_h[0][1])
    np.testing.assert_array_equal(got, want)
    assert tst.LAUNCHES == {k: 0 for k in tst.LAUNCHES}
    with pytest.raises(ValueError, match="slab"):
        tst._check_slab(tops, u_h[0][1], "u_h")
    with pytest.raises(ValueError, match="leave"):
        tst._check_slab(level.ops[0][1], torch.zeros(1, 12, 15, 15), "u_h")


@pytest.mark.parametrize("ref,p,nsp", [(4, 1, 2), (5, 1, 2), (5, 1, 4), (3, 2, 2), (6, 1, 4)])
def test_transfer_z_plan_matches_jax(ref, p, nsp):
    """The canonical-embedded 1D prolongation and restriction between two
    levels: same plan (or None) as the JAX package's."""
    space = make_space(3, p, ref)
    P1 = np.asarray(space.prolongations[-1], np.float64)
    n_f, n_c = tshard.canon_nz(P1.shape[0]), tshard.canon_nz(P1.shape[1])
    emb = np.zeros((n_f, n_c))
    emb[: P1.shape[0], : P1.shape[1]] = P1
    for mat in (emb, emb.T):
        want, got = jsh.transfer_z_plan(mat, nsp), tsh.transfer_z_plan(mat, nsp)
        assert (want is None) == (got is None)
        if want is not None:
            assert want[1] == got[1]
            np.testing.assert_array_equal(want[0], got[0])


@pytest.mark.parametrize("nsp", [1, 2, 4])
@pytest.mark.parametrize("p", [1, 2, 3, 4])
def test_canon_shardable_matches_jax(p, nsp):
    for dim, refs in ((3, range(3, 9)), (2, range(3, 11))):
        for ref in refs:
            sp = (p * 2**ref - 1,) * dim
            assert tshard.canon_shardable(sp, p, dim, nsp) == jst.canon_shardable(
                sp, p, dim, nsp
            ), (sp, p, nsp)
    assert tshard.z_partition(127, 2) == [(0, 64), (64, 127)]
    assert tshard.z_partition(15, 2) == [(0, 8), (8, 15)]


@functools.cache
def _jax_vcycle_r5():
    """Refinement 5 in the JAX package, once per module: its GMG hierarchy
    (and the port's copy), its state at the IRK stage diagonal D, a
    right-hand side (seed 6) and its batched V-cycle."""
    space = make_space(3, 1, 5)
    jg = jgmg.build_gmg_data(space, jnp.float64, with_dense=False)
    d = irk_tables(Q).D
    jp = jgmg.gmg_reinit(jg, jnp.asarray(d), TAU, 3, "stencil", batch=True)
    r = np.random.default_rng(6).standard_normal((Q,) + space.shape)
    want = np.asarray(jgmg.vcycle(jg, jp, jnp.asarray(d), TAU, jnp.asarray(r), 3, "stencil",
                                  batch=True))
    return jg, d, jp, r, want


@pytest.mark.parametrize("kernels", [True, False])
def test_mesh_vcycle_matches_jax_and_counts_its_exchanges(kernels):
    """Refinement 5 on a (4, 2) mesh: the 31 level is sharded, the 15 level
    (16 / 2 = 8 planes per slot) too, the coarse 7 level is gathered onto
    each stage row's first slot.  Against the JAX package's V-cycle with
    its own state (f64, rtol 1e-10: the sharded transfers sum in another
    order), and against the port's unsharded V-cycle."""
    jg, d, jp, r, want = _jax_vcycle_r5()
    tg = gmg_data_from_numpy(
        [tuple(np.asarray(x) for x in (o.mass_band, o.stiff_band, o.mass_diag, o.stiff_diag))
         for o in jg.level_ops],
        [np.asarray(Pm) for Pm in jg.prolongs],
        np.asarray(jg.coarse_mass),
        np.asarray(jg.coarse_stiff),
    )
    mesh = tmake_mesh(4, devices=["cpu"] * 8)
    state = [[np.asarray(x) for x in f] for f in (jp.inv_diags, jp.thetas, jp.deltas)]
    mp = mesh_prec_from_numpy(tg, *state, np.asarray(jp.coarse_inv), d, 3, mesh)
    assert [lv is not None for lv in mp.levels] == [False, True, True]
    tst.reset_launches()
    tshard.reset_exchange()
    a = torch.as_tensor(d)
    got = tgmg.vcycle(tg, mp, a, TAU, sharded_block_from_numpy(r, mesh), 3,
                      kernels=kernels, mesh=mesh)
    ex, planes = dict(tshard.EXCHANGE), tshard.HALO_MAX_PLANES["planes"]
    got = sharded_block_to_numpy(got)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10 * np.abs(want).max())
    whole = tgmg.vcycle(tg, gmg_prec_from_numpy(*state, np.asarray(jp.coarse_inv)), a, TAU,
                        torch.as_tensor(r), 3, kernels=kernels)
    np.testing.assert_allclose(got, whole.numpy(), rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
    # the structure: per sharded level 8 Chebyshev steps and 2 applies, each
    # one p-plane message up and one down per stage (f64: 8 bytes); the two
    # transfers per level pair one h-plane exchange each, on the level they
    # read; the 7^3 level gathered and scattered (3 of its 7 planes move)
    hr = [t.h for t in mp.restricts]
    hp = [t.h for t in mp.prolongs]
    halo = 0
    for l, m in ((1, 15), (2, 31)):
        m_c = 7 if l == 1 else 15
        halo += Q * 2 * 8 * (10 * m * m + hr[l - 1] * m * m + hp[l - 1] * m_c * m_c)
    assert ex == {"halo": halo, "mix": 0, "coarse_gather": Q * 2 * 3 * 7 * 7 * 8, "state": 0}
    assert planes == max(1, *hr, *hp) and planes <= 2
    assert tst.LAUNCHES == {k: 0 for k in tst.LAUNCHES}
