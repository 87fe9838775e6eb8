"""The port's ``ost`` (Crank–Nicolson, ``schemes/ost.py``) against the JAX
package's, both on the CPU at f64 (the JAX package in stencil mode, or
dense for MatrixBased):

* 2D refinement 5 and 3D refinement 3 (MatrixFree + GMG), and 2D
  refinement 6 MatrixBased + AMG (the defaults of ``json/ost.json``):
  per-step CG counts exactly equal, the solution and every step's L2/Linf
  within 1e-10 relative; the port through its kernel wrappers (their plain
  versions on CPU tensors) and through the plain operators alike, with no
  launch;
* the end-time truncation: dt 0.15 to 0.2 takes a step of 0.15 and one of
  0.05, with JAX's counts and errors;
* the spatial convergence of ``tests/test_schemes.py:38-46``: O(h^2) ratios
  over refinements 3-5 at dt 0.025;
* the CG target ``1e-8 ||rhs||`` under the 32 eps floor in f32: a step
  converges instead of running to the 1000-iteration raise.
"""

import os
import sys

import numpy as np
import pytest
import torch

# one intra-op thread: the tests run beside other test processes
torch.set_num_threads(1)

import dealii_spirk_tpu.runner as jrunner
from dealii_spirk_tpu.config import Parameters as JParameters
from dealii_spirk_tpu_torch.config import Parameters as TParameters
from dealii_spirk_tpu_torch.ops.cuda import stencil as tst
from dealii_spirk_tpu_torch.runner import run_config as trun_config
from dealii_spirk_tpu_torch.schemes.ost import OneStepTheta

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
from test_torch_transfer import count_transfers  # noqa: E402

RTOL = 1e-10
BASE = {
    "FEDegree": 1,
    "NRefinements": 4,
    "TimeIntegrationScheme": "ost",
    "TimeStepSize": 0.1,
    "EndTime": 0.2,
    "OperatorType": "MatrixFree",
    "BlockPreconditionerType": "GMG",
    "DoOutputParaview": False,
}
CASES = {
    "2D r5": (2, {"NRefinements": 5}),
    "3D r3": (3, {"NRefinements": 3}),
    "2D r6 MatrixBased AMG": (2, {"NRefinements": 6, "OperatorType": "MatrixBased",
                                  "BlockPreconditionerType": "AMG"}),
    "truncation": (2, {"TimeStepSize": 0.15}),
}


def jax_run(dim: int, over: dict):
    """The JAX package's run and its per-step CG counts (read off the
    scheme's running total at the end of each step)."""
    made = []
    make = jrunner.make_scheme

    def recording(*args, **kwargs):
        scheme = make(*args, **kwargs)
        after, counts, mark = scheme.after_step, [], [0.0]

        def after_step(n):
            counts.append(int(scheme.n_outer - mark[0]))
            after(n)
            mark[0] = scheme.n_outer

        scheme.after_step = after_step
        made.append(counts)
        return scheme

    cfg = {**BASE, **over}
    if cfg["OperatorType"] == "MatrixFree":
        cfg["OperatorMode"] = "stencil"
    jrunner.make_scheme = recording
    try:
        out = jrunner.run_config(JParameters.from_dict(cfg, dim=dim), verbose=False)
    finally:
        jrunner.make_scheme = make
    return out, made[0]


@pytest.fixture(scope="module")
def jax_runs():
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = jax_run(*CASES[case])
        return cache[case]

    return get


def torch_run(dim: int, over: dict, **kw):
    return trun_config(TParameters.from_dict({**BASE, **over}, dim=dim), device="cpu",
                       verbose=False, **kw)


def count_wrappers(monkeypatch) -> dict:
    """Count each kernel wrapper's calls in a dict keyed as ``LAUNCHES``
    (on CPU tensors a wrapper runs its plain version and launches nothing)."""
    calls = dict.fromkeys(tst.LAUNCHES, 0)
    for name in ("stencil_apply", "cheb_iter", "cheb_iter_dg", "ms_mix_apply", "stage_mix",
                 "mass_stiffness_apply"):
        wrapper = getattr(tst, name)

        def counted(*args, _name=name, _wrapper=wrapper):
            calls[_name] += 1
            return _wrapper(*args)

        monkeypatch.setattr(tst, name, counted)
    count_transfers(monkeypatch, calls)
    return calls


def assert_same_run(t, j, j_counts):
    assert [s["n_outer"] for s in t["scheme"].step_log] == j_counts
    assert t["n_timesteps"] == j["n_timesteps"] and t["n_outer"] == j["n_outer"]
    want = np.asarray(j["u"])
    np.testing.assert_allclose(t["u"].numpy(), want, rtol=RTOL, atol=RTOL * np.abs(want).max())
    for (tl2, tli), (jl2, jli) in zip(t["errors"], j["errors"], strict=True):
        np.testing.assert_allclose(tl2, jl2, rtol=RTOL)
        np.testing.assert_allclose(tli, jli, rtol=RTOL)


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("case", ["2D r5", "3D r3", "2D r6 MatrixBased AMG"])
def test_ost_matches_jax(jax_runs, case, kernels):
    dim, over = CASES[case]
    if kernels and over.get("OperatorType") == "MatrixBased":
        with pytest.raises(ValueError, match="MatrixBased"):
            torch_run(dim, over, kernels=True)
        return
    tst.reset_launches()
    out = torch_run(dim, over, kernels=kernels)
    assert tst.LAUNCHES == {k: 0 for k in tst.LAUNCHES}  # CPU: no launches
    scheme = out["scheme"]
    assert isinstance(scheme, OneStepTheta) and scheme.kernels is kernels
    assert scheme.mode == ("dense" if "MatrixBased" in case else "stencil")
    j, j_counts = jax_runs(case)
    assert_same_run(out, j, j_counts)
    assert out["n_timesteps"] == 2 and all(n > 0 for n in j_counts)
    # the reference's OST reports no statistics (main.cc:539-546)
    assert "n_outer_avg" not in out["table"].rows[-1]


def test_ost_end_time_truncation(jax_runs):
    """dt 0.15 to T = 0.2: a step of 0.15, then one truncated to 0.05
    (reference main.cc:3326-3339)."""
    dim, over = CASES["truncation"]
    out = torch_run(dim, over)
    j, j_counts = jax_runs("truncation")
    assert out["n_timesteps"] == 2
    row = out["table"].rows[-1]
    assert row["final_t"] == pytest.approx(0.2) and row["dt"] == pytest.approx(0.15)
    assert_same_run(out, j, j_counts)


def test_ost_spatial_convergence():
    """O(h^2) until the temporal error floor (tests/test_schemes.py:38-46)."""
    e = [torch_run(2, {"NRefinements": r, "TimeStepSize": 0.025})["error_L2"]
         for r in (3, 4, 5)]
    assert e[0] / e[1] > 3.0
    assert e[1] / e[2] > 2.0


def test_ost_f32_cg_floor():
    """In f32 the target 1e-8 ||rhs|| lies below the attainable residual;
    ``pcg``'s 32 eps floor stops CG, and the f32 run stays at the f64
    run's counts within 1 and its L2 within 1e-4."""
    over = {"NRefinements": 5}
    f64 = torch_run(2, over)
    f32 = torch_run(2, {**over, "Precision": "f32"})
    assert f32["u"].dtype == torch.float32
    c32 = [s["n_outer"] for s in f32["scheme"].step_log]
    c64 = [s["n_outer"] for s in f64["scheme"].step_log]
    assert max(c32) < 50 and max(abs(a - b) for a, b in zip(c32, c64)) <= 1
    np.testing.assert_allclose(f32["error_L2"], f64["error_L2"], rtol=1e-4)


def test_chip_smoke_expected_launches_of_ost(monkeypatch):
    """``chip_smoke.expected_launches``' ost branch against the wrappers'
    calls of a kernel-structured run on the CPU (each wrapper counted where
    the card would launch it): per step a K4 for the rhs and one for the
    start residual, a K4 per CG iteration, and one-lane V-cycles of 8 K3
    and 2 K4 per smoothed level, one per iteration and one at the start."""
    calls = count_wrappers(monkeypatch)
    dim, cfg, n_levels = chip_smoke.PATHS["P11"]
    out = torch_run(dim, {**{k: v for k, v in cfg.items() if k != "Precision"},
                          "NRefinements": 4}, kernels=True)
    assert len(out["scheme"].gmg.level_ops) == 2  # 15 smoothed, 7 dense
    want = chip_smoke.expected_launches(out)
    assert calls == want and want["stencil_apply"] > 0 and want["cheb_iter"] > 0
