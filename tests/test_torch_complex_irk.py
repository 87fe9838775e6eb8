"""The complex-diagonalised schemes of the port (``complex_irk`` with
PRESB, ``complex_irk_batched`` with the block V-cycle) against the JAX
package's ``run_config`` in "stencil" mode at f64, 3D, Q1: q = 3 and 5,
refinements 3 and 4, InnerTolerance 0 and 1e-2 (absolute, PRESB's inner
CG; the batched scheme ignores it).  Outer, per-pair outer and inner
counts exactly equal; the solution and the L2/Linf errors within rtol
1e-10.  The port runs its kernel-structured path (on CPU tensors the
wrappers run their plain versions) and its plain path.

Also: one step's pair solve against JAX's, per pair; the port's batched
GMRES against JAX's ``gmres(batch=True)`` with lanes that converge at
different iterations; the entry points' device defaults."""

import functools
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dealii_spirk_tpu.solvers.krylov as jkry
from dealii_spirk_tpu.config import Parameters as JParameters
from dealii_spirk_tpu.runner import run_config as jrun_config
import dealii_spirk_tpu_torch.__main__ as tmain_mod
import dealii_spirk_tpu_torch.solvers.krylov as tkry
from dealii_spirk_tpu_torch.config import Parameters as TParameters
from dealii_spirk_tpu_torch.ops.cuda import stencil as tst
from dealii_spirk_tpu_torch.problem import HeatProblem
from dealii_spirk_tpu_torch.runner import run_config as trun_config
from dealii_spirk_tpu_torch.schemes import make_scheme
from test_torch_setup import same_tables_route  # noqa: F401 (autouse: one tables route)

RTOL = 1e-10
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
# (scheme, q, refinement, InnerTolerance)
CASES = [
    ("complex_irk_batched", 3, 3, 0.0),
    ("complex_irk_batched", 5, 4, 1e-2),
    ("complex_irk", 5, 4, 0.0),
    ("complex_irk", 3, 3, 1e-2),
]


def _cfg(scheme, q, ref, inner):
    return {**BASE, "TimeIntegrationScheme": scheme, "IRKStages": q, "NRefinements": ref,
            "InnerTolerance": inner}


@functools.cache
def _jax(case):
    params = JParameters.from_dict({**_cfg(*case), "OperatorMode": "stencil"}, dim=3)
    return jrun_config(params, verbose=False)


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_complex_scheme_matches_jax(case, kernels):
    j = _jax(case)
    tst.reset_launches()
    t = trun_config(
        TParameters.from_dict(_cfg(*case), dim=3), device="cpu", verbose=False, kernels=kernels
    )
    assert tst.LAUNCHES == {k: 0 for k in tst.LAUNCHES}  # CPU: no launches
    assert t["n_timesteps"] == j["n_timesteps"] == 2
    assert (t["n_outer"], t["n_inner"]) == (j["n_outer"], j["n_inner"])
    # per-pair outer counts (the per-group attribution counters)
    np.testing.assert_array_equal(
        t["scheme"].n_inner_stage, np.asarray(j["scheme"].n_inner_stage)
    )
    want = np.asarray(j["u"])
    np.testing.assert_allclose(
        t["u"].numpy(), want, rtol=RTOL, atol=RTOL * np.abs(want).max()
    )
    for (tl2, tli), (jl2, jli) in zip(t["errors"], j["errors"]):
        np.testing.assert_allclose(tl2, jl2, rtol=RTOL)
        np.testing.assert_allclose(tli, jli, rtol=RTOL)
    for s in t["scheme"].step_log:
        assert s["n_outer"] == sum(s["n_outer_pair"])
        assert s["n_inner"] == sum(map(sum, s["n_inner_pair"]))


@pytest.mark.parametrize("case", [CASES[1], CASES[3]])
def test_pair_solve_matches_jax_per_pair(case):
    """One step's pair solve on the same right-hand side: per-pair outer
    and (re, im) inner counts exactly equal, W within rtol 1e-10."""
    j = _jax(case)
    js = j["scheme"]
    params = TParameters.from_dict(_cfg(*case), dim=3)
    ts = make_scheme(HeatProblem(params, device="cpu"), params)
    tau = jnp.asarray(0.1, jnp.float64)
    u0 = js.problem.initial_condition()
    W_rhs = js._rhs_jit(u0, tau, tau)
    jW, j_outer, j_inner = js._solve_jit(W_rhs, js.prec_state(0.1), tau)
    tW, res = ts.solve_fn(torch.as_tensor(np.array(W_rhs)), ts.prec_state(0.1), 0.1)
    np.testing.assert_array_equal(res.n_iterations, np.asarray(j_outer))
    np.testing.assert_array_equal(res.M_carry, np.asarray(j_inner))
    want = np.asarray(jW)
    np.testing.assert_allclose(tW.numpy(), want, rtol=RTOL, atol=RTOL * np.abs(want).max())


def _lane_system(lanes, n, seed, zero_lane):
    """Per-lane nonsymmetric systems whose spectra spread differently, so
    the lanes converge at different iterations; optionally one lane with
    a zero right-hand side (done before the first iteration)."""
    rng = np.random.default_rng(seed)
    mats = []
    for lane in range(lanes):
        spread = 1.0 + 4.0 * lane
        d = np.linspace(1.0, spread, n)
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        mats.append(Q @ np.diag(d) @ Q.T + 0.2 * rng.standard_normal((n, n)) / np.sqrt(n))
    mats = np.stack(mats)
    b = rng.standard_normal((lanes, n))
    if zero_lane:
        b[1] = 0.0
    pre = 1.0 / np.einsum("lii->li", mats)  # Jacobi
    return mats, b, pre


@pytest.mark.parametrize("zero_lane", [False, True])
def test_batched_gmres_matches_jax(zero_lane):
    """Masked lanes: per-lane iteration counts, the per-lane carry of a
    stateful preconditioner (frozen lanes stop counting) and the iterates
    equal JAX's, through restarts (restart 5)."""
    mats, b, pre = _lane_system(4, 40, 3, zero_lane)
    kw = dict(maxiter=80, abstol=1e-20, reltol=1e-10, restart=5)

    def jM(v, c):
        return jnp.asarray(pre) * v, c + 1

    j = jkry.gmres(
        lambda x: jnp.einsum("lij,lj->li", jnp.asarray(mats), x), jnp.asarray(b),
        M=jM, M_carry=jnp.zeros((4, 2), jnp.int32), batch=True, **kw,
    )
    tm, tp = torch.as_tensor(mats), torch.as_tensor(pre)
    t = tkry.gmres(
        lambda x: torch.einsum("lij,lj->li", tm, x), torch.as_tensor(b),
        M=lambda v, c: (tp * v, c + 1), M_carry=np.zeros((4, 2), np.int64), batch=True,
        **kw,
    )
    j_it = np.asarray(j.n_iterations)
    np.testing.assert_array_equal(t.n_iterations, j_it)
    assert len(set(j_it.tolist())) > 2  # the lanes really converge apart
    assert t.n_restarts > 0 and t.n_sweeps >= j_it.max()
    np.testing.assert_array_equal(t.M_carry, np.asarray(j.M_carry))
    want = np.asarray(j.x)
    np.testing.assert_allclose(t.x.numpy(), want, rtol=1e-9, atol=1e-9 * np.abs(want).max())
    if zero_lane:
        assert j_it[1] == t.n_iterations[1] == 0 and np.all(t.x.numpy()[1] == 0)


def test_entry_points_default_to_the_gpu(monkeypatch, capsys):
    """``run_config`` and the CLI run on ``cuda`` unless asked for the CPU,
    and without a CUDA device they fail with a clear message before any
    work; ``device="cpu"`` still runs."""
    assert inspect.signature(trun_config).parameters["device"].default == "cuda"
    assert tmain_mod.build_parser().get_default("device") == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = TParameters.from_dict(_cfg("complex_irk_batched", 3, 2, 0.0), dim=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trun_config(params, verbose=False)
    with pytest.raises(SystemExit) as exc:
        tmain_mod.main(["json/complex_irk.json"])
    assert exc.value.code == 2 and "no CUDA device" in capsys.readouterr().err
    out = trun_config(params, device="cpu", verbose=False)
    assert out["u"].device.type == "cpu" and np.isfinite(out["error_L2"])
