"""The port's slice as a whole: ``run_config`` of ``irk_batched`` (3D,
Q1, refinement 4, q=4, dt 0.1, EndTime 0.2, GMG, InnerTolerance 0, f64)
against the JAX package's ``run_config`` in "stencil" mode, with the same
tables and the same Lanczos start vectors: outer and inner counts exactly
equal, the solution and the L2/Linf errors within rtol 1e-10.  The port
runs both its kernel-structured path (the kernel wrappers on CPU tensors
run their plain versions) and its plain path."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dealii_spirk_tpu.config import Parameters as JParameters
from dealii_spirk_tpu.runner import run_config as jrun_config
from dealii_spirk_tpu.tables import irk_tables as jirk_tables
from dealii_spirk_tpu_torch.__main__ import main as tmain
from dealii_spirk_tpu_torch.config import Parameters as TParameters
from dealii_spirk_tpu_torch.interop import irk_tables_from_numpy
from dealii_spirk_tpu_torch.ops.cuda import stencil as tst
from dealii_spirk_tpu_torch.problem import HeatProblem
from dealii_spirk_tpu_torch.runner import run_config as trun_config
from dealii_spirk_tpu_torch.schemes import make_scheme

RTOL = 1e-10
BASE = {
    "FEDegree": 1,
    "NRefinements": 4,
    "TimeIntegrationScheme": "irk_batched",
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


def _jax_start(shape):
    return np.asarray(jax.random.uniform(jax.random.PRNGKey(42), shape, dtype=jnp.float64))


@pytest.fixture(scope="module")
def jax_run():
    params = JParameters.from_dict({**BASE, "OperatorMode": "stencil"}, dim=3)
    return jrun_config(params, verbose=False)


@pytest.mark.parametrize("kernels", [True, False])
def test_irk_batched_slice_matches_jax(jax_run, kernels):
    jt = jirk_tables(4)
    tables = irk_tables_from_numpy(
        4,
        **{f.name: np.asarray(getattr(jt, f.name))
           for f in dataclasses.fields(jt) if f.name != "n_stages"},
    )
    tst.reset_launches()
    out = trun_config(
        TParameters.from_dict(BASE, dim=3), verbose=False,
        kernels=kernels, tables=tables, start=_jax_start,
    )
    assert tst.LAUNCHES == {k: 0 for k in tst.LAUNCHES}  # CPU: no launches
    assert out["n_timesteps"] == jax_run["n_timesteps"] == 2
    assert out["n_outer"] == jax_run["n_outer"]
    assert out["n_inner"] == jax_run["n_inner"]
    np.testing.assert_array_equal(
        out["scheme"].n_inner_stage, np.asarray(jax_run["scheme"].n_inner_stage)
    )
    want = np.asarray(jax_run["u"])
    np.testing.assert_allclose(
        out["u"].numpy(), want, rtol=RTOL, atol=RTOL * np.abs(want).max()
    )
    for (tl2, tli), (jl2, jli) in zip(out["errors"], jax_run["errors"]):
        np.testing.assert_allclose(tl2, jl2, rtol=RTOL)
        np.testing.assert_allclose(tli, jli, rtol=RTOL)
    for s in out["scheme"].step_log:
        # left preconditioning: one V-cycle per iteration plus the start
        assert s["n_inner"] == s["n_outer"] + 1 + s["n_restarts"]
    row = out["table"].rows[-1]
    assert row["n_outer_avg"] == round(jax_run["n_outer"], 2)


def test_irk_batched_2d_matches_jax():
    """2D runs the plain path (the CUDA kernels are 3D only); same
    parity rules, degree 2."""
    cfg = {**BASE, "NRefinements": 4, "FEDegree": 2}
    j = jrun_config(JParameters.from_dict({**cfg, "OperatorMode": "stencil"}, dim=2),
                    verbose=False)
    t = trun_config(TParameters.from_dict(cfg, dim=2), verbose=False, start=_jax_start)
    assert (t["n_outer"], t["n_inner"]) == (j["n_outer"], j["n_inner"])
    want = np.asarray(j["u"])
    np.testing.assert_allclose(t["u"].numpy(), want, rtol=RTOL, atol=RTOL * np.abs(want).max())
    np.testing.assert_allclose(t["error_L2"], j["error_L2"], rtol=RTOL)


def test_default_start_and_tables_stay_close(jax_run):
    """Without JAX's start vector (the port draws its own from a numpy
    generator) the Chebyshev intervals differ slightly; the solve must
    still converge to the same solution."""
    out = trun_config(TParameters.from_dict(BASE, dim=3), verbose=False)
    assert abs(out["n_outer"] - jax_run["n_outer"]) <= 1
    np.testing.assert_allclose(out["error_L2"], jax_run["error_L2"], rtol=1e-6)


@pytest.mark.parametrize("scheme", ["ost", "irk", "spirk", "complex_irk_batched"])
def test_unported_schemes_raise(scheme):
    params = TParameters.from_dict({**BASE, "TimeIntegrationScheme": scheme}, dim=3)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_scheme(HeatProblem(params), params)


def test_cli_runs_a_json_config(tmp_path, capsys):
    import json

    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({**BASE, "NRefinements": 3, "EndTime": 0.2}))
    assert tmain(["--device", "cpu", "--dim", "3", str(cfg)]) == 0
    text = capsys.readouterr().out
    assert "error_L2" in text and "n_outer_avg" in text
