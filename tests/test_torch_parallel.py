"""The port's slot mesh (``dealii_spirk_tpu_torch/parallel``) and its
``spirk`` against the JAX package's, all slots on the CPU:

* mesh shapes, trimming, padding and adjacency equal to
  ``dealii_spirk_tpu.parallel.mesh`` on its 8 virtual CPU devices;
* the ring mix == the all-gather mix == ``mat @ W`` (f64, round-off);
* ``spirk`` in 2D (refinement 4, q = 4, f64; the fine level does not split
  over the space axis, so the (4, 2) mesh narrows to (4, 1) with a warning)
  against the JAX package's ``spirk`` on its (4, 2) mesh: outer and
  per-stage inner counts exactly equal, L2 to 1e-9 relative, for
  InnerTolerance 0 and 1e-2 and both stage mixers; and equal to the port's
  own ``irk`` / ``irk_batched``.

The 3D runs are in ``test_torch_parallel_3d.py``."""

import jax
import numpy as np
import pytest
import torch

from dealii_spirk_tpu.config import Parameters as JParameters
from dealii_spirk_tpu.parallel import mesh as jmesh
from dealii_spirk_tpu.runner import run_config as jrun_config
from dealii_spirk_tpu_torch.config import Parameters as TParameters
from dealii_spirk_tpu_torch.parallel import mesh as tmesh
from dealii_spirk_tpu_torch.parallel import sharding as tshard
from dealii_spirk_tpu_torch.parallel.ring import allgather_stage_mix, ring_stage_mix
from dealii_spirk_tpu_torch.runner import run_config as trun_config
from test_torch_setup import same_tables_route  # noqa: F401 (autouse: one tables route)

BASE = {
    "FEDegree": 1,
    "NRefinements": 4,
    "TimeIntegrationScheme": "spirk",
    "IRKStages": 4,
    "TimeStepSize": 0.1,
    "EndTime": 0.2,
    "OperatorType": "MatrixFree",
    "BlockPreconditionerType": "GMG",
    "InnerTolerance": 0.0,
    "OuterTolerance": 1e-8,
    "Precision": "f64",
    "DoOutputParaview": False,
}
DIM = 2


def jax_spirk(dim, inner_tol, use_sm):
    cfg = {**BASE, "InnerTolerance": inner_tol, "UseSharedMemory": use_sm,
           "OperatorMode": "stencil"}
    return jrun_config(JParameters.from_dict(cfg, dim=dim), verbose=False)


def torch_run(dim, scheme, inner_tol, use_sm=False, **kw):
    cfg = {**BASE, "TimeIntegrationScheme": scheme, "InnerTolerance": inner_tol,
           "UseSharedMemory": use_sm}
    return trun_config(TParameters.from_dict(cfg, dim=dim), device="cpu", verbose=False, **kw)


def assert_same_run(t, j):
    """Counts exactly equal, L2 to 1e-9 relative."""
    assert t["n_timesteps"] == j["n_timesteps"]
    assert (t["n_outer"], t["n_inner"]) == (j["n_outer"], j["n_inner"])
    np.testing.assert_array_equal(
        np.asarray(t["scheme"].n_inner_stage), np.asarray(j["scheme"].n_inner_stage)
    )
    np.testing.assert_allclose(t["error_L2"], j["error_L2"], rtol=1e-9)


@pytest.mark.parametrize(
    "stage,kw",
    [
        (4, {}),
        (2, {"max_ranks": 4}),  # MaxRanks trimming (reference main.cc:3647-3658)
        (3, {}),  # 2 slots dropped
        (4, {"do_row_major": False}),
        (2, {"do_row_major": False}),
        (3, {"padding": 4}),  # nodes {0..3}, {4..7}: the first 3 of each
        (4, {"padding": -1}),
        (2, {"padding": 0}),  # one host holds all 8
        (2, {"max_ranks": 6, "padding": 3}),
    ],
)
def test_mesh_matches_jax(stage, kw):
    want = jmesh.make_mesh(stage, devices=jax.devices(), **kw)
    got = tmesh.make_mesh(stage, devices=["cpu"] * 8, **kw)
    assert got.shape == dict(want.shape)
    np.testing.assert_array_equal(got.slot_ids, np.vectorize(lambda d: d.id)(want.devices))
    assert all(d == torch.device("cpu") for row in got.devices for d in row)
    if kw.get("do_row_major", True):
        # each space column holds consecutive slots along the stage axis
        for col in got.slot_ids.T:
            assert list(col) == list(range(col[0], col[0] + len(col)))


def test_mesh_shapes_and_errors():
    for n, s in ((8, 4), (8, 2), (8, 3)):
        assert tmesh.stage_space_shape(n, s) == jmesh.stage_space_shape(n, s)
    assert tmesh.stage_space_shape(8, 2, max_ranks=4) == (2, 2)
    with pytest.raises(ValueError, match="cannot host"):
        tmesh.stage_space_shape(2, 4)
    with pytest.raises(ValueError, match="at least as large"):
        tmesh.make_mesh(4, devices=["cpu"] * 8, padding=2)
    assert tmesh.pad_devices(list(range(8)), 3, 4) == [0, 1, 2, 4, 5, 6]
    col = tmesh.make_mesh(4, devices=["cpu"] * 8).first_space_column()
    assert col.shape == {"stage": 4, "space": 1}
    np.testing.assert_array_equal(col.slot_ids[:, 0], [0, 1, 2, 3])


@pytest.mark.parametrize("stage", [4, 2])
def test_stage_mixers_agree(stage):
    """out_i = sum_j mat[i, j] W_j: ring (one stage per row) and all-gather
    (also two stages per row) against the plain product, and what each
    moves: the ring q - 1 neighbour copies of every slot's block, the
    all-gather every other row's block to every slot."""
    q, m = 4, 15
    mesh = tmesh.make_mesh(stage, devices=["cpu"] * 8)
    rng = np.random.default_rng(3)
    W = rng.standard_normal((q, m, m, m))
    mat = torch.as_tensor(rng.standard_normal((q, q)))
    want = (mat.numpy() @ W.reshape(q, -1)).reshape(W.shape)
    block = tshard.scatter(torch.as_tensor(W), mesh, kind=None)
    nbytes = W.size * 8
    mixers = [allgather_stage_mix] + ([ring_stage_mix] if stage == q else [])
    for mixer in mixers:
        tshard.reset_exchange()
        got = tshard.gather(mixer(mat, block), kind="state").numpy()
        np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13)
        assert tshard.EXCHANGE["mix"] == (stage - 1) * nbytes
        assert tshard.EXCHANGE["halo"] == tshard.EXCHANGE["coarse_gather"] == 0
    if stage != q:
        with pytest.raises(ValueError, match="stage axis == q"):
            ring_stage_mix(mat, block)


def test_sharded_block_vector_operations():
    """What the Krylov solvers ask of a block: arithmetic with numbers and
    per-stage coefficients from either side, per-lane and whole dots, the
    one-lane view, masked selection."""
    q, m = 4, 15
    mesh = tmesh.make_mesh(2, devices=["cpu"] * 8)  # (2, 4): 2 stages per row
    assert mesh.shape == {"stage": 2, "space": 4}
    mesh = tmesh.make_mesh(2, devices=["cpu"] * 4)
    rng = np.random.default_rng(4)
    A, B = (torch.as_tensor(rng.standard_normal((q, m, m, m))) for _ in range(2))
    a, b = (tshard.scatter(t, mesh, kind=None) for t in (A, B))
    assert a.shape == (q, m, m, m) and a[None].shape == (1, q, m, m, m) and a[None][0] is not a
    c = torch.as_tensor(rng.standard_normal(q))
    cb = c.reshape(q, 1, 1, 1)
    back = lambda blk: tshard.gather(blk, kind="state")
    torch.testing.assert_close(back(cb * a - 2.0 * b + a / cb), cb * A - 2.0 * B + A / cb)
    torch.testing.assert_close(back(1.0 - a), 1.0 - A)
    torch.testing.assert_close(a.dot(b, True), (A * B).sum(dim=(1, 2, 3)))
    torch.testing.assert_close(a.dot(b, False), (A * B).sum())
    torch.testing.assert_close(a[None].dot(b[None], True), (A * B).sum().reshape(1))
    mask = torch.tensor([True, False, True, False]).reshape(q, 1, 1, 1)
    torch.testing.assert_close(back(a.select(mask, b)), torch.where(mask, A, B))
    assert float(back(a.zeros_like()).abs().max()) == 0.0
    with pytest.raises(ValueError, match="per-stage"):
        a * torch.ones(3)


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's ``spirk`` on its (4, 2) mesh, once per module: each
    InnerTolerance with one of the two mixers (they give the same counts)."""
    return {0.0: jax_spirk(DIM, 0.0, True), 1e-2: jax_spirk(DIM, 1e-2, False)}


@pytest.mark.parametrize("use_sm", [False, True])
@pytest.mark.parametrize("inner_tol", [0.0, 1e-2])
def test_spirk_2d_matches_jax(jax_runs, inner_tol, use_sm):
    with pytest.warns(RuntimeWarning, match="first space column"):
        out = torch_run(DIM, "spirk", inner_tol, use_sm, slots=8)
    assert out["scheme"].mesh.shape == {"stage": 4, "space": 1}
    assert_same_run(out, jax_runs[inner_tol])
    row = out["table"].rows[-1]
    assert (row["n_procs"], row["n_procs_global"], row["n_procs_row"],
            row["n_procs_column"]) == (8, 4, 4, 1)


@pytest.mark.parametrize("inner_tol", [0.0, 1e-2])
def test_spirk_2d_matches_own_irk(inner_tol):
    """One answer, three schemes: the stage-parallel run against the
    sequential and (InnerTolerance 0) the batched one."""
    par = torch_run(DIM, "spirk", inner_tol)
    seq = torch_run(DIM, "irk", inner_tol)
    assert par["scheme"].mesh.shape == {"stage": 4, "space": 1}
    assert (par["n_outer"], par["n_inner"]) == (seq["n_outer"], seq["n_inner"])
    np.testing.assert_allclose(par["error_L2"], seq["error_L2"], rtol=1e-9)
    if inner_tol == 0.0:
        bat = torch_run(DIM, "irk_batched", inner_tol)
        assert par["n_outer"] == bat["n_outer"]
        np.testing.assert_allclose(par["error_L2"], bat["error_L2"], rtol=1e-9)
