"""2D ``irk_batched`` of the port (Q1, q=4: the 2D path whose outer vmult
is K5-2D + K2 and whose V-cycle smooths over K4-2D) against the JAX
package's ``run_config`` in "stencil" mode at f64: outer and inner counts
exactly equal, the solution and the L2/Linf errors within rtol 1e-10.
The port runs its kernel-structured path (on CPU tensors the wrappers run
their plain versions) and its plain path."""

import functools

import numpy as np
import pytest

from dealii_spirk_tpu.config import Parameters as JParameters
from dealii_spirk_tpu.runner import run_config as jrun_config
from dealii_spirk_tpu_torch.config import Parameters as TParameters
from dealii_spirk_tpu_torch.ops.cuda import stencil as tst
from dealii_spirk_tpu_torch.runner import run_config as trun_config
from test_torch_setup import same_tables_route  # noqa: F401 (autouse: one tables route)

RTOL = 1e-10
BASE = {
    "FEDegree": 1,
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


@functools.cache
def _jax(ref):
    params = JParameters.from_dict({**BASE, "NRefinements": ref, "OperatorMode": "stencil"}, dim=2)
    return jrun_config(params, verbose=False)


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("ref", [5, 6])
def test_irk_batched_2d_path_matches_jax(ref, kernels):
    j = _jax(ref)
    tst.reset_launches()
    t = trun_config(
        TParameters.from_dict({**BASE, "NRefinements": ref}, dim=2),
        device="cpu", verbose=False, kernels=kernels,
    )
    assert tst.LAUNCHES == {k: 0 for k in tst.LAUNCHES}  # CPU: no launches
    assert t["scheme"].kernels is kernels
    assert (t["n_outer"], t["n_inner"]) == (j["n_outer"], j["n_inner"])
    np.testing.assert_array_equal(
        t["scheme"].n_inner_stage, np.asarray(j["scheme"].n_inner_stage)
    )
    want = np.asarray(j["u"])
    np.testing.assert_allclose(t["u"].numpy(), want, rtol=RTOL, atol=RTOL * np.abs(want).max())
    for (tl2, tli), (jl2, jli) in zip(t["errors"], j["errors"]):
        np.testing.assert_allclose(tl2, jl2, rtol=RTOL)
        np.testing.assert_allclose(tli, jli, rtol=RTOL)
    for s in t["scheme"].step_log:
        assert s["n_inner"] == s["n_outer"] + 1 + s["n_restarts"]
