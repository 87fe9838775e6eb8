"""The sequential ``irk`` scheme of the port (one stage solve after the
other, json/irk.json's scheme) against the JAX package's ``run_config``
in "stencil" mode at f64, 3D, Q1: InnerTolerance 0 (one V-cycle per
stage) and 1e-2 (CG per stage, preconditioned by the V-cycle).  Outer and
per-stage inner counts exactly equal; the solution and the L2/Linf errors
within rtol 1e-10.  The port runs its kernel-structured path (on CPU
tensors the wrappers run their plain versions) and its plain path."""

import functools
import json
import os

import numpy as np
import pytest

from dealii_spirk_tpu.config import Parameters as JParameters
from dealii_spirk_tpu.runner import run_config as jrun_config
from dealii_spirk_tpu_torch.__main__ import main as tmain
from dealii_spirk_tpu_torch.config import Parameters as TParameters
from dealii_spirk_tpu_torch.ops.cuda import stencil as tst
from dealii_spirk_tpu_torch.runner import run_config as trun_config
from test_torch_setup import same_tables_route  # noqa: F401 (autouse: one tables route)

RTOL = 1e-10
BASE = {
    "FEDegree": 1,
    "TimeIntegrationScheme": "irk",
    "TimeStepSize": 0.1,
    "EndTime": 0.2,
    "OperatorType": "MatrixFree",
    "BlockPreconditionerType": "GMG",
    "OuterTolerance": 1e-8,
    "Precision": "f64",
    "DoOutputParaview": False,
}
# (q, refinement, InnerTolerance)
CASES = [(3, 3, 1e-2), (5, 4, 0.0)]
IRK_JSON = os.path.join(os.path.dirname(__file__), os.pardir, "json", "irk.json")


def _cfg(q, ref, inner):
    return {**BASE, "IRKStages": q, "NRefinements": ref, "InnerTolerance": inner}


@functools.cache
def _jax(case):
    params = JParameters.from_dict({**_cfg(*case), "OperatorMode": "stencil"}, dim=3)
    return jrun_config(params, verbose=False)


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_irk_matches_jax(case, kernels):
    j = _jax(case)
    tst.reset_launches()
    t = trun_config(
        TParameters.from_dict(_cfg(*case), dim=3), device="cpu", verbose=False, kernels=kernels
    )
    assert tst.LAUNCHES == {k: 0 for k in tst.LAUNCHES}  # CPU: no launches
    assert t["n_timesteps"] == j["n_timesteps"] == 2
    assert (t["n_outer"], t["n_inner"]) == (j["n_outer"], j["n_inner"])
    np.testing.assert_array_equal(
        t["scheme"].n_inner_stage, np.asarray(j["scheme"].n_inner_stage)
    )
    want = np.asarray(j["u"])
    np.testing.assert_allclose(t["u"].numpy(), want, rtol=RTOL, atol=RTOL * np.abs(want).max())
    for (tl2, tli), (jl2, jli) in zip(t["errors"], j["errors"]):
        np.testing.assert_allclose(tl2, jl2, rtol=RTOL)
        np.testing.assert_allclose(tli, jli, rtol=RTOL)
    q, _ref, inner = case
    for s in t["scheme"].step_log:
        n_prec = s["n_outer"] + 1 + s["n_restarts"]
        assert s["n_inner"] == sum(s["n_inner_stage"])
        if inner == 0.0:
            # one V-cycle per stage per preconditioner application
            assert s["n_inner_stage"] == [n_prec] * q
        else:
            assert all(n >= n_prec for n in s["n_inner_stage"])


def test_cli_runs_irk_json(tmp_path, capsys):
    """json/irk.json through the CLI, at refinement 3 and two steps (its
    widths otherwise: q=5, Q1, MatrixFree + GMG, InnerTolerance 0)."""
    with open(IRK_JSON) as f:
        cfg = json.load(f)
    assert cfg["TimeIntegrationScheme"] == "irk"
    cfg.update({"NRefinements": 3, "EndTime": 0.2, "DoOutputParaview": False})
    path = tmp_path / "irk.json"
    path.write_text(json.dumps(cfg))
    assert tmain(["--device", "cpu", "--dim", "3", str(path)]) == 0
    text = capsys.readouterr().out
    assert "error_L2" in text and "n_outer_avg" in text
