"""The port's ``complex_spirk`` (PRESB) and ``complex_spirk_batched`` on a
slot mesh of CPU slots, the pair axis on the stage rows, against the JAX
package's on its 8 virtual devices (its (ceil(q/2), space) mesh), f64, Q1,
"stencil" mode:

* outer, per-pair outer and inner counts exactly equal, the solution and
  the L2 errors to 1e-9 relative, in 2D (the mesh narrows to (n2, 1) with
  a warning) and 3D, q = 3 and 5, InnerTolerance 0 and 1e-2, on meshes of
  one and two space columns; one step's pair solve per pair (outer and
  (re, im) inner counts) against JAX's;
* equal to the port's own unsharded ``complex_irk(_batched)``, as the JAX
  package holds its own (``tests/test_parallel.py``), in both arms;
* the exchanges: halos (none above one plane), the coarse gather and the
  right-hand side and solution, never a stage mix; the pair vmult against
  JAX's, with no message along the stage axis.
"""

import contextlib
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# one intra-op thread: the tests run beside other test processes, and small
# tensors lose far more to thread contention than they gain (the counts do
# not depend on it)
torch.set_num_threads(1)

from dealii_spirk_tpu.config import Parameters as JParameters
from dealii_spirk_tpu.runner import run_config as jrun_config
from dealii_spirk_tpu_torch.config import Parameters as TParameters
from dealii_spirk_tpu_torch.interop import pair_block_from_numpy, sharded_block_to_numpy
from dealii_spirk_tpu_torch.ops.cuda import stencil as tst
from dealii_spirk_tpu_torch.parallel import sharding as tshard
from dealii_spirk_tpu_torch.parallel.mesh import make_mesh
from dealii_spirk_tpu_torch.problem import HeatProblem
from dealii_spirk_tpu_torch.runner import run_config as trun_config
from dealii_spirk_tpu_torch.schemes import make_scheme
from test_torch_setup import same_tables_route  # noqa: F401 (autouse: one tables route)

RTOL = 1e-9
BASE = {
    "FEDegree": 1,
    "TimeStepSize": 0.1,
    "EndTime": 0.2,
    "OperatorType": "MatrixFree",
    "BlockPreconditionerType": "GMG",
    "OuterTolerance": 1e-8,
    "Precision": "f64",
    "DoOutputParaview": False,
}
# (scheme, dim, q, refinement, InnerTolerance, the port's slots, its mesh)
CASES = [
    ("complex_spirk_batched", 3, 5, 4, 0.0, 6, (3, 2)),  # z slabs of 8 + 7 planes
    ("complex_spirk", 2, 3, 4, 1e-2, 4, (2, 1)),  # 2D: one space column
    ("complex_spirk", 3, 5, 4, 0.0, 6, (3, 2)),
    ("complex_spirk", 3, 3, 4, 1e-2, 4, (2, 2)),
    ("complex_spirk_batched", 2, 5, 4, 1e-2, 6, (3, 1)),
]
IDS = [f"{c[0]}-{c[1]}D-q{c[2]}-tol{c[4]:g}" for c in CASES]
# against the JAX package (its runs take most of this file's time): both
# schemes, 2D and 3D, q = 3 and 5, InnerTolerance 0 and 1e-2, the sharded
# PRESB path on two space columns; every case against the port's own
# unsharded scheme
JAX_CASES, JAX_IDS = CASES[:4], IDS[:4]


def _cfg(scheme, dim, q, ref, inner, *_):
    return {**BASE, "TimeIntegrationScheme": scheme, "IRKStages": q, "NRefinements": ref,
            "InnerTolerance": inner}


@functools.cache
def _jax(case):
    params = JParameters.from_dict({**_cfg(*case), "OperatorMode": "stencil"}, dim=case[1])
    return jrun_config(params, verbose=False)


def _narrowing(narrow: bool):
    """The warning of a mesh that narrows to its first space column."""
    if narrow:
        return pytest.warns(RuntimeWarning, match="first space column")
    return contextlib.nullcontext()


def _port(case, *, narrow=None, over=None, **kw):
    params = TParameters.from_dict({**_cfg(*case), **(over or {})}, dim=case[1])
    with _narrowing(case[-1][1] == 1 if narrow is None else narrow):
        return trun_config(params, device="cpu", verbose=False, **kw)


@pytest.mark.parametrize("case", JAX_CASES, ids=JAX_IDS)
def test_complex_spirk_matches_jax(case):
    j = _jax(case)
    tst.reset_launches()
    tshard.reset_exchange()
    t = _port(case, slots=case[5])
    ts = t["scheme"]
    assert ts.mesh.shape == {"stage": case[-1][0], "space": case[-1][1]}
    assert tst.LAUNCHES == {k: 0 for k in tst.LAUNCHES}  # CPU slots: no launches
    assert t["n_timesteps"] == j["n_timesteps"] == 2
    assert (t["n_outer"], t["n_inner"]) == (j["n_outer"], j["n_inner"])
    np.testing.assert_array_equal(ts.n_inner_stage, np.asarray(j["scheme"].n_inner_stage))
    want = np.asarray(j["u"])
    np.testing.assert_allclose(t["u"].numpy(), want, rtol=RTOL, atol=RTOL * np.abs(want).max())
    for (tl2, _), (jl2, _) in zip(t["errors"], j["errors"]):
        np.testing.assert_allclose(tl2, jl2, rtol=RTOL)
    ex = tshard.EXCHANGE
    # per step the 2 n2 mapped right-hand-side lanes out and back
    n2, dim = ts.n_pairs, case[1]
    assert ex["state"] == 2 * 2 * 2 * n2 * ts.fine.m**dim * 8
    assert ex["mix"] == 0
    if case[-1][1] > 1:
        assert ex["halo"] > 0 and ex["coarse_gather"] > 0
        assert tshard.HALO_MAX_PLANES["planes"] == 1
    else:
        assert ex["halo"] == ex["coarse_gather"] == 0


@pytest.mark.parametrize("case", JAX_CASES, ids=JAX_IDS)
def test_pair_solve_matches_jax_per_pair(case):
    """One step's pair solve on the same right-hand side: per-pair outer and
    (re, im) inner counts exactly equal, W to 1e-9."""
    js = _jax(case)["scheme"]
    params = TParameters.from_dict(_cfg(*case), dim=case[1])
    mesh = make_mesh(case[-1][0], devices=["cpu"] * case[5])
    with _narrowing(case[-1][1] == 1):
        ts = make_scheme(HeatProblem(params, device="cpu"), params, mesh=mesh)
    tau = jnp.asarray(0.1, jnp.float64)
    W_rhs = js._rhs_jit(js.problem.initial_condition(), tau, tau)
    jW, j_outer, j_inner = js._solve_jit(W_rhs, js.prec_state(0.1), tau)
    tW, res = ts.solve_fn(torch.as_tensor(np.array(W_rhs)), ts.prec_state(0.1), 0.1)
    np.testing.assert_array_equal(res.n_iterations, np.asarray(j_outer))
    np.testing.assert_array_equal(res.M_carry, np.asarray(j_inner))
    want = np.asarray(jW)
    np.testing.assert_allclose(tW.numpy(), want, rtol=RTOL, atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_complex_spirk_matches_own_complex_irk(case):
    """One answer, two layouts: the mesh run against the port's unsharded
    scheme, step by step (per-pair outer and inner counts, sweeps,
    restarts), in the kernel-structured arm (on CPU slots the wrappers run
    their plain versions) and the plain arm."""
    unsharded = case[0].replace("spirk", "irk")
    for kernels in (True, False):
        par = _port(case, slots=case[5], kernels=kernels)
        seq = _port(case, narrow=False, kernels=kernels,
                    over={"TimeIntegrationScheme": unsharded})
        assert par["scheme"].mesh is not None and seq["scheme"].mesh is None
        assert par["scheme"].step_log == seq["scheme"].step_log
        np.testing.assert_allclose(par["error_L2"], seq["error_L2"], rtol=RTOL)


def test_pair_vmult_matches_jax_and_sends_no_stage_message():
    """The 2x2 real-block apply on a (3, 2) mesh: K9b per slot and the
    row-local pair block, against JAX's unsharded pair vmult; its only
    messages are one-plane z halos, 2 n2 lanes x 2 directions per cut."""
    case = CASES[0]
    js = _jax(case)["scheme"]
    params = TParameters.from_dict(_cfg(*case), dim=3)
    mesh = make_mesh(3, devices=["cpu"] * 6)
    ts = make_scheme(HeatProblem(params, device="cpu"), params, mesh=mesh)
    m = ts.fine.m
    Z = np.random.default_rng(8).standard_normal((3, 2, m, m, m))
    want = np.asarray(js._cpx_vmult(jnp.asarray(Z), jnp.asarray(0.1, jnp.float64)))
    tshard.reset_exchange()
    got = ts.pair_vmult(pair_block_from_numpy(Z, mesh), 0.1)
    assert got.shape == Z.shape
    np.testing.assert_allclose(sharded_block_to_numpy(got), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
    assert tshard.EXCHANGE == {"halo": 6 * 2 * m * m * 8, "mix": 0, "coarse_gather": 0,
                               "state": 0}
    assert tshard.HALO_MAX_PLANES["planes"] == 1
