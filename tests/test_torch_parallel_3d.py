"""The port's ``spirk`` in 3D (refinement 4, q = 4, f64) on a (4, 2) mesh
of CPU slots — the 15^3 level split into z slabs of 8 + 7 planes and run
through the space-sharded layer, the 7^3 level gathered per stage row —
against the JAX package's ``spirk`` on its (4, 2) mesh of virtual CPU
devices: outer and per-stage inner counts exactly equal, L2 to 1e-9
relative, for InnerTolerance 0 and 1e-2 and both stage mixers; equal to the
port's own ``irk`` / ``irk_batched``; and the exchanges of a run are halos,
stage mixes and the coarse level only, none above one plane."""

import numpy as np
import pytest

from dealii_spirk_tpu_torch.ops.cuda import stencil as tst
from dealii_spirk_tpu_torch.parallel import sharding as tshard
from dealii_spirk_tpu_torch.parallel.mesh import make_mesh
from test_torch_parallel import assert_same_run, jax_spirk, torch_run
from test_torch_setup import same_tables_route  # noqa: F401 (autouse: one tables route)

DIM = 3


@pytest.fixture(scope="module")
def jax_runs():
    """Once per module: each InnerTolerance with one of the two mixers."""
    return {0.0: jax_spirk(DIM, 0.0, False), 1e-2: jax_spirk(DIM, 1e-2, True)}


@pytest.mark.parametrize("use_sm", [False, True])
@pytest.mark.parametrize("inner_tol", [0.0, 1e-2])
def test_spirk_3d_matches_jax(jax_runs, inner_tol, use_sm):
    tst.reset_launches()
    tshard.reset_exchange()
    out = torch_run(DIM, "spirk", inner_tol, use_sm, slots=8)
    assert out["scheme"].mesh.shape == {"stage": 4, "space": 2}
    assert_same_run(out, jax_runs[inner_tol])
    assert tst.LAUNCHES == {k: 0 for k in tst.LAUNCHES}  # CPU slots: no launches
    ex = tshard.EXCHANGE
    assert min(ex.values()) > 0 and tshard.HALO_MAX_PLANES["planes"] == 1
    # per step: the right-hand side out and the solution back
    assert ex["state"] == out["n_timesteps"] * 2 * 4 * 15**3 * 8


@pytest.mark.parametrize("inner_tol", [0.0, 1e-2])
def test_spirk_3d_matches_own_irk(inner_tol):
    par = torch_run(DIM, "spirk", inner_tol, slots=8)
    seq = torch_run(DIM, "irk", inner_tol)
    assert (par["n_outer"], par["n_inner"]) == (seq["n_outer"], seq["n_inner"])
    np.testing.assert_array_equal(par["scheme"].n_inner_stage, seq["scheme"].n_inner_stage)
    np.testing.assert_allclose(par["error_L2"], seq["error_L2"], rtol=1e-9)
    if inner_tol == 0.0:
        bat = torch_run(DIM, "irk_batched", inner_tol)
        assert par["n_outer"] == bat["n_outer"]
        np.testing.assert_allclose(par["error_L2"], bat["error_L2"], rtol=1e-9)


def test_spirk_kernel_and_plain_arms_agree():
    """``kernels=False`` runs the same sharded layer over the plain
    versions: on CPU slots the two arms are the same arithmetic."""
    a = torch_run(DIM, "spirk", 0.0, slots=8, kernels=True)
    b = torch_run(DIM, "spirk", 0.0, slots=8, kernels=False)
    assert a["scheme"].step_log == b["scheme"].step_log
    np.testing.assert_array_equal(a["u"].numpy(), b["u"].numpy())


def test_spirk_two_stages_per_row():
    """A (2, 2) mesh under q = 4: two stages per stage row, the all-gather
    mixer whatever UseSharedMemory says."""
    par = torch_run(DIM, "spirk", 0.0, slots=4)
    ref = torch_run(DIM, "spirk", 0.0, slots=8)
    two = torch_run(DIM, "spirk", 0.0, mesh=make_mesh(2, devices=["cpu"] * 4))
    assert two["scheme"].mesh.shape == {"stage": 2, "space": 2}
    assert par["scheme"].mesh.shape == {"stage": 4, "space": 1}
    for out in (par, two):
        assert (out["n_outer"], out["n_inner"]) == (ref["n_outer"], ref["n_inner"])
        np.testing.assert_allclose(out["error_L2"], ref["error_L2"], rtol=1e-9)
