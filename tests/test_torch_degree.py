"""The degree sweep's paths of ``chip_smoke.py`` (P16-P20: Q3 and Q4 on the
kernels) in their CPU forms, f64 at 3D refinement 2 (Q3: m = 11, Q4: m =
15), against the JAX package in stencil mode:

* P16 (``irk_batched`` q=4 Q3), P17 (the same at Q4), P19 (``irk_batched``
  Q4 at ``chip_smoke.P19_STAGES`` stages, where no K1 block holds the q
  rings and the vmult takes K2 + ``ms_mix_apply_split``), P20
  (``complex_irk_batched`` q=5 Q4): outer, inner and per-stage inner counts
  exactly equal, the solution within 1e-10 relative, and every step's L2
  and Linf within 1e-10 relative or 1e-13 of max|u|;
* P18 (``spirk`` q=4 Q4 on a (4, 2) mesh of CPU slots: slabs of 8 + 7
  planes with 4-plane halos) against JAX's ``spirk`` on its 8 virtual
  devices, and against the port's own unsharded ``irk`` (P18's twin on the
  card); its bytes between slots equal ``chip_smoke.expected_exchange``;
* P21 (P19 with AMG, the path that restarts on the card);
* P19's and P21's forms with the compact GMRES threshold lowered in both
  packages (one restart per step): the restarts and the compact basis's
  RuntimeWarning as JAX's;
* ``chip_smoke.expected_launches`` for P17's, P19's and P21's forms against
  the kernel wrappers' calls, each counted where the card launches (K1 at
  Q4 as its route, K2 and ``ms_mix_apply_split``).
"""

import os
import sys
import warnings

import numpy as np
import pytest
import torch

# one intra-op thread: the tests run beside other test processes
torch.set_num_threads(1)

import dealii_spirk_tpu.schemes.irk as jirk
import dealii_spirk_tpu_torch.schemes.base as tbase
from dealii_spirk_tpu.config import Parameters as JParameters
from dealii_spirk_tpu.runner import run_config as jrun_config
from dealii_spirk_tpu_torch.config import Parameters as TParameters
from dealii_spirk_tpu_torch.ops.cuda import stencil as tst
from dealii_spirk_tpu_torch.parallel import sharding as tshard
from dealii_spirk_tpu_torch.runner import run_config as trun_config

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
from test_torch_transfer import count_transfers  # noqa: E402
from test_torch_setup import same_tables_route  # noqa: E402, F401 (autouse: one tables route)

REF = 2
RTOL = 1e-10
ROUNDOFF = 1e-13
NEW_PATHS = ("P16", "P17", "P18", "P19", "P20", "P21")
# the forms that restart the compact basis (its threshold lowered in both
# packages): P19's, dt 1e-3 and OuterTolerance 1e-8, 16 outer iterations per
# step at f64; P21's (AMG), OuterTolerance 1e-10, 14 per step; each past
# the 12 columns and far above f64 round-off
RESTART_FORMS = {"P19": {"TimeStepSize": 1e-3, "EndTime": 3e-3, "OuterTolerance": 1e-8},
                 "P21": {"OuterTolerance": 1e-10}}
WRAPPERS = ("stencil_apply", "cheb_iter", "cheb_iter_dg", "ms_mix_apply", "stage_mix",
            "mass_stiffness_apply", "stencil_apply_halo", "mass_stiffness_apply_halo",
            "cheb_iter_halo", "cheb_iter_dg_halo")


def form(name: str) -> tuple[int, dict]:
    """(dim, configuration) of a path's CPU form: refinement 2, f64."""
    dim, cfg, _levels = chip_smoke.PATHS[name]
    return dim, {**cfg, "NRefinements": REF, "Precision": "f64", **RESTART_FORMS.get(name, {})}


def count_wrappers(mp: pytest.MonkeyPatch) -> dict:
    """Each kernel wrapper's calls keyed as ``LAUNCHES``, counted where the
    card launches: a K1 call where no block holds the q rings (``mix_tile``
    0) as its route, one K2 and one ``ms_mix_apply_split`` (on CPU tensors
    the wrapper runs its plain version and calls neither)."""
    calls = dict.fromkeys(tst.LAUNCHES, 0)
    for name in WRAPPERS:
        wrapper = getattr(tst, name)

        def counted(*args, _name=name, _wrapper=wrapper):
            if _name == "ms_mix_apply" and not tst.mix_tile(args[3].shape[0], args[0].p):
                calls["stage_mix"] += 1
                calls["ms_mix_apply_split"] += 1
            else:
                calls[_name] += 1
            return _wrapper(*args)

        mp.setattr(tst, name, counted)
    count_transfers(mp, calls)
    return calls


def _compact_warnings(caught) -> int:
    return sum(issubclass(w.category, RuntimeWarning) and "compact basis" in str(w.message)
               for w in caught)


def _run_both(name: str, mp: pytest.MonkeyPatch) -> dict:
    dim, cfg = form(name)
    if name in RESTART_FORMS:
        mp.setattr(jirk, "COMPACT_GRID_DOFS", 100)
        mp.setattr(tbase, "COMPACT_GRID_DOFS", 100)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        j = jrun_config(JParameters.from_dict({**cfg, "OperatorMode": "stencil"}, dim=dim),
                        verbose=False)
    j_warn = _compact_warnings(caught)
    calls = count_wrappers(mp)
    tshard.reset_exchange()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t = trun_config(TParameters.from_dict(cfg, dim=dim), device="cpu", verbose=False,
                        kernels=True, slots=chip_smoke.SLOTS.get(name))
    return {"jax": j, "jax_warn": j_warn, "port": t, "port_warn": _compact_warnings(caught),
            "calls": dict(calls), "exchange": dict(tshard.EXCHANGE),
            "planes": tshard.HALO_MAX_PLANES["planes"]}


@pytest.fixture(scope="module")
def runs():
    """Each path's JAX run and port run, once per module, on first use."""
    cache = {}

    def get(name: str) -> dict:
        if name not in cache:
            with pytest.MonkeyPatch.context() as mp:
                cache[name] = _run_both(name, mp)
        return cache[name]

    return get


@pytest.mark.parametrize("name", NEW_PATHS)
def test_path_matches_jax(runs, name):
    r = runs(name)
    t, j = r["port"], r["jax"]
    scheme = t["scheme"]
    _dim, cfg = form(name)
    assert scheme.fine.p == cfg["FEDegree"] and scheme.fine.m == cfg["FEDegree"] * 2**REF - 1
    assert t["n_timesteps"] == j["n_timesteps"] == 3
    assert (t["n_outer"], t["n_inner"]) == (j["n_outer"], j["n_inner"])
    np.testing.assert_array_equal(np.asarray(scheme.n_inner_stage),
                                  np.asarray(j["scheme"].n_inner_stage))
    want = np.asarray(j["u"])
    np.testing.assert_allclose(t["u"].numpy(), want, rtol=RTOL, atol=RTOL * np.abs(want).max())
    # an error norm moves by at most the solutions' gap: at P20's form
    # they lie 5.8e-14 of max|u| apart (GMRES's round-off from step 2 on),
    # which is 1.06e-10 of its small Linf (4.8e-4), so the norms are held
    # to 1e-10 relative or ROUNDOFF of max|u|
    atol = ROUNDOFF * np.abs(want).max()
    for (tl2, tli), (jl2, jli) in zip(t["errors"], j["errors"], strict=True):
        np.testing.assert_allclose(tl2, jl2, rtol=RTOL, atol=atol)
        np.testing.assert_allclose(tli, jli, rtol=RTOL, atol=atol)
    assert tst.LAUNCHES == {k: 0 for k in tst.LAUNCHES}  # CPU: no launches


def test_p18_runs_on_the_slot_mesh(runs):
    """P18's form splits over a (4, 2) mesh (slabs of 8 + 7 planes, 4-plane
    halos), passes the bytes that ``expected_exchange`` implies, and equals
    the port's unsharded ``irk`` at its widths (P18's twin on the card)."""
    r = runs("P18")
    scheme = r["port"]["scheme"]
    assert scheme.mesh.shape == {"stage": 4, "space": 2} and scheme.ring
    want, planes = chip_smoke.expected_exchange(scheme)
    assert r["exchange"] == want and r["planes"] == planes
    assert min(want.values()) > 0
    dim, cfg = form("P18")
    twin = trun_config(TParameters.from_dict({**cfg, "TimeIntegrationScheme": "irk"}, dim=dim),
                       device="cpu", verbose=False)
    assert twin["scheme"].step_log == scheme.step_log
    np.testing.assert_allclose(r["port"]["error_L2"], twin["error_L2"], rtol=1e-9)


@pytest.mark.parametrize("name", sorted(RESTART_FORMS))
def test_form_restarts_as_jax(runs, name):
    """With the compact threshold lowered, P19's and P21's forms restart the
    12-column basis once per step in both packages (JAX's per-stage V-cycle
    count is n_outer + 1 + restarts) and both warn in every step."""
    r = runs(name)
    scheme = r["port"]["scheme"]
    assert scheme.compact and scheme.restart == tbase.COMPACT_BASIS == 12
    for s in scheme.step_log:
        assert s["n_outer"] > 12 and s["n_restarts"] == 1
        assert s["n_inner"] == s["n_outer"] + 1 + s["n_restarts"]
    # JAX's counters sum the steps after the first (its statistics reset
    # there); per step a stage's V-cycles are n_outer + 1 + restarts
    j = r["jax"]
    counted = r["port"]["n_timesteps"] - 1
    j_stage = int(np.asarray(j["scheme"].n_inner_stage)[0])
    assert j_stage - int(j["n_outer"]) == counted * (1 + scheme.step_log[-1]["n_restarts"])
    assert r["jax_warn"] == r["port_warn"] == r["port"]["n_timesteps"] == 3


def test_p19_takes_k1s_route():
    """P19's stage count is the fewest at Q4 for which no K1 block holds the
    q rings, so its vmult takes K2 + ``ms_mix_apply_split``; at Q4 K1 takes
    that route wherever no tile lets two Mix blocks share an SM, so P17's
    four stages take it too."""
    q = chip_smoke.P19_STAGES
    assert chip_smoke.PATHS["P19"][1]["IRKStages"] == q
    assert all(tst.march_smem_bytes(4, t, q) > tst.BLOCK_SMEM_BYTES for t in tst.MIX_TILES)
    assert any(tst.march_smem_bytes(4, t, q - 1) <= tst.BLOCK_SMEM_BYTES for t in tst.MIX_TILES)
    q17 = chip_smoke.PATHS["P17"][1]["IRKStages"]
    assert tst.mix_tile(q, 4) == 0 and tst.mix_tile(q17, 4) == 0


@pytest.mark.parametrize("name", ["P17", "P19", "P21"])
def test_chip_smoke_expected_launches(runs, name):
    """``chip_smoke.expected_launches`` against the wrappers' calls of the
    form's kernel-structured run: P17 and P19 K1's route per vmult, P21 its
    route on AMG levels with a restart per step."""
    r = runs(name)
    want = chip_smoke.expected_launches(r["port"])
    assert r["calls"] == want
    assert want["stencil_apply"] > 0 and want["cheb_iter"] > 0
    assert want["ms_mix_apply"] == 0 and want["ms_mix_apply_split"] > 0
