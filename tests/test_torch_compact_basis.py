"""The huge-grid GMRES policy of both packages: above
``COMPACT_GRID_DOFS`` DoFs per stage GMRES restarts every
``COMPACT_BASIS`` = 12 iterations and a solve that runs past them warns.

The threshold is lowered in both packages (the test patches the name each
scheme module reads; no package file changes) so a small 2D grid takes
the compact path.  q=8 at degree 4 with dt 0.01 converges slowly enough
that OuterTolerance 4e-9 takes 15 outer iterations per step at f64 (one
restart).  The tolerance keeps the count robust: the residual estimate
crosses it with a factor of about 1.7 to spare on either side, far above
f64 round-off (at 1e-12 the restarted residual is round-off and the JAX
package's count moves with ``OMP_NUM_THREADS``).  Outer, per-stage
inner and restart counts must equal JAX's (JAX's inner counts include the
V-cycle of each restart's residual), and both packages must emit the
``RuntimeWarning`` in every step."""

import warnings

import numpy as np
import pytest

import dealii_spirk_tpu.schemes.complex_irk as jcirk
import dealii_spirk_tpu.schemes.irk as jirk
import dealii_spirk_tpu_torch.schemes.base as tbase
from dealii_spirk_tpu.config import Parameters as JParameters
from dealii_spirk_tpu.runner import run_config as jrun_config
from dealii_spirk_tpu_torch.config import Parameters as TParameters
from dealii_spirk_tpu_torch.runner import run_config as trun_config
from test_torch_setup import same_tables_route  # noqa: F401 (autouse: one tables route)

CFG = {
    "FEDegree": 4,
    "NRefinements": 3,
    "IRKStages": 8,
    "TimeStepSize": 0.01,
    "EndTime": 0.02,
    "OperatorType": "MatrixFree",
    "BlockPreconditionerType": "GMG",
    "InnerTolerance": 0.0,
    "OuterTolerance": 4e-9,
    "Precision": "f64",
    "DoOutputParaview": False,
}


def _run(run, params, **kw):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = run(params, verbose=False, **kw)
    n_warn = sum(
        issubclass(w.category, RuntimeWarning) and "compact basis" in str(w.message)
        for w in caught
    )
    return out, n_warn


@pytest.mark.parametrize("scheme", ["irk_batched", "irk"])
def test_compact_basis_restarts_match_jax(scheme, monkeypatch):
    monkeypatch.setattr(jirk, "COMPACT_GRID_DOFS", 100)
    monkeypatch.setattr(tbase, "COMPACT_GRID_DOFS", 100)
    cfg = {**CFG, "TimeIntegrationScheme": scheme}
    j, j_warn = _run(jrun_config, JParameters.from_dict({**cfg, "OperatorMode": "stencil"}, dim=2))
    t, t_warn = _run(trun_config, TParameters.from_dict(cfg, dim=2), device="cpu")
    scheme_t = t["scheme"]
    assert scheme_t.compact and scheme_t.restart == tbase.COMPACT_BASIS == 12
    assert (t["n_outer"], t["n_inner"]) == (j["n_outer"], j["n_inner"])
    np.testing.assert_array_equal(scheme_t.n_inner_stage, np.asarray(j["scheme"].n_inner_stage))
    q = CFG["IRKStages"]
    for s in scheme_t.step_log:
        assert s["n_outer"] > 12 and s["n_restarts"] == 1
        n_prec = s["n_outer"] + 1 + s["n_restarts"]
        assert s["n_inner"] == (q * n_prec if scheme == "irk" else n_prec)
    # JAX has no restart counter: its per-stage V-cycle count (the GMRES
    # carry) is n_outer + 1 + restarts, so the restarts agree as well
    j_stage = int(np.asarray(j["scheme"].n_inner_stage)[0])
    assert j_stage - int(j["n_outer"]) - 1 == scheme_t.step_log[-1]["n_restarts"]
    assert j_warn == t_warn == t["n_timesteps"] == 2


def test_complex_compact_basis_restarts_match_jax(monkeypatch):
    """``complex_irk_batched`` (q=6, degree 4, dt 0.01, OuterTolerance
    1e-10): the three pair lanes take 20, 13 and 8 iterations, so with the
    12-column basis the first two restart once and the third is frozen
    from its 8th iteration on.  Per-pair outer counts, total inner counts
    (a lane live in the restarted cycle also counts the recomputed
    residual's V-cycle) and the warnings equal JAX's."""
    monkeypatch.setattr(jcirk, "COMPACT_GRID_DOFS", 100)
    monkeypatch.setattr(tbase, "COMPACT_GRID_DOFS", 100)
    cfg = {**CFG, "TimeIntegrationScheme": "complex_irk_batched", "IRKStages": 6,
           "OuterTolerance": 1e-10}
    j, j_warn = _run(jrun_config, JParameters.from_dict({**cfg, "OperatorMode": "stencil"}, dim=2))
    t, t_warn = _run(trun_config, TParameters.from_dict(cfg, dim=2), device="cpu")
    scheme_t = t["scheme"]
    assert scheme_t.compact and scheme_t.restart == 12
    assert (t["n_outer"], t["n_inner"]) == (j["n_outer"], j["n_inner"])
    np.testing.assert_array_equal(scheme_t.n_inner_stage, np.asarray(j["scheme"].n_inner_stage))
    for s in scheme_t.step_log:
        assert s["n_outer_pair"] == [20, 13, 8] and s["n_restarts"] == 1
        assert s["n_inner_pair"] == [[22, 22], [15, 15], [10, 10]]
    np.testing.assert_allclose(t["error_L2"], j["error_L2"], rtol=1e-10)
    assert j_warn == t_warn == t["n_timesteps"] == 2
