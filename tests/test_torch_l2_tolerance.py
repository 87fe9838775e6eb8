"""``scripts/torch_l2_tolerance.py`` in its 2D mode (P3's scheme, 2D
``irk_batched``, q=4, cut to refinement 4) on the CPU, and the K4 / K9a
wrappers' coefficient normalisation:

* the script's f64 runs at OuterTolerance 1e-4 and 1e-8 against the JAX
  package's ``irk_batched`` in stencil mode at the same configuration:
  per-step outer counts equal, L2 within 1e-10 relative;
* its plain-f32 arm runs the plain torch operators in f32, with the f64
  arm's outer counts within 1 (PARITY.md:89-96) and its L2 within 1e-4
  relative (f32 round-off of a 15^2 solve);
* ``_stage_coefs`` hands K4 and K9a a contiguous f32 (q,) table: the
  caller's tensor itself where it is one, a conversion or a fill
  otherwise; a wrong length raises.  ``LevelOps.kernel_bands``, the band
  check the kernel wrappers read, holds for f32 contiguous bands of degree
  1-4 only.  Only the CPU side: the kernels run on the card
  (``chip_smoke.py``);
* the fault that moved P3's L2 on the card, as far as the CPU can show it:
  K5-2D's x pass added each mass tap into the stiffness taps' accumulator.
  An f32 model of the two orders at P3's finest level (fused
  multiply-adds, one rounding each) on a smooth field: the old order's
  mean error against f64 leaves ``chip_smoke.smooth_bias``'s limit, the
  order the kernels now take (the taps apart) stays inside it, and the
  probe itself passes the plain versions on the CPU.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

# one intra-op thread: the tests run beside other test processes
torch.set_num_threads(1)

import dealii_spirk_tpu.runner as jrunner
from dealii_spirk_tpu.config import Parameters as JParameters
from dealii_spirk_tpu_torch.fem.grid import make_level
from dealii_spirk_tpu_torch.ops.cuda import stencil as tst
from dealii_spirk_tpu_torch.ops.mass_laplace import level_ops

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_ROOT, "scripts"))
sys.path.insert(0, _ROOT)
import chip_smoke  # noqa: E402
import torch_l2_tolerance as tl2  # noqa: E402
from test_torch_setup import same_tables_route  # noqa: E402, F401 (autouse: one tables route)

REF, STAGES = 4, 4
RUNS = "f64:1e-4,f32-plain:1e-4,f64:1e-8"


@pytest.fixture(scope="module")
def records():
    return {(r["arm"], r["outer_tolerance"]): r
            for r in tl2.run(2, REF, STAGES, ["irk_batched"], tl2.parse_runs(RUNS), "cpu")}


def _jax_run(tol: float) -> tuple[list[int], float]:
    """The JAX package's run at the script's configuration: per-step outer
    counts (read off the scheme's running total at the end of each step,
    where step 1 also clears it) and the final L2."""
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

    cfg = {**tl2._BASE, "NRefinements": REF, "IRKStages": STAGES, "OperatorMode": "stencil",
           "TimeIntegrationScheme": "irk_batched", "Precision": "f64", "OuterTolerance": tol}
    jrunner.make_scheme = recording
    try:
        out = jrunner.run_config(JParameters.from_dict(cfg, dim=2), verbose=False)
    finally:
        jrunner.make_scheme = make
    return made[0], out["error_L2"]


@pytest.mark.parametrize("tol", [1e-4, 1e-8])
def test_dim2_f64_matches_jax(records, tol):
    rec = records["f64", tol]
    outer, l2 = _jax_run(tol)
    assert rec["precision"] == "f64" and rec["kernels"] is False
    assert rec["outer"] == outer and len(outer) == 3
    np.testing.assert_allclose(rec["error_L2"], l2, rtol=1e-10)


def test_dim2_plain_f32_arm(records):
    rec, f64 = records["f32-plain", 1e-4], records["f64", 1e-4]
    assert rec["precision"] == "f32" and rec["kernels"] is False
    assert max(abs(a - b) for a, b in zip(rec["outer"], f64["outer"])) <= 1
    np.testing.assert_allclose(rec["error_L2"], f64["error_L2"], rtol=1e-4)
    # the tighter tolerance moves f64 toward the converged answer
    assert records["f64", 1e-8]["outer"] >= f64["outer"]


def test_main_prints_the_table(capsys):
    assert tl2.main(["--dim", "2", "--refinement", "3", "--device", "cpu",
                     "--runs", "f32-plain:1e-4,f64:1e-8"]) == 0
    text = capsys.readouterr().out
    assert "relative L2 distance to irk_batched" in text and "f32-plain:0.0001" in text
    with pytest.raises(ValueError, match="unknown arm"):
        tl2.parse_runs("f16:1e-4")
    with pytest.raises(ValueError, match="unknown arm"):
        tl2.parse_runs("f32-but-cheb_pair_dg:1e-4")


@pytest.mark.parametrize("name", tl2.SWAPPABLE)
def test_plain_wrapper_swaps_one_kernel(name):
    """An f32-but-<wrapper> arm runs that wrapper's plain version for the
    run and puts the kernel wrapper back after it."""
    kernel = getattr(tst, name)
    with tl2.plain_wrapper(name):
        assert getattr(tst, name) is getattr(tst, name + "_ref")
        assert all(getattr(tst, other) is not getattr(tst, other + "_ref")
                   for other in tl2.SWAPPABLE if other != name)
    assert getattr(tst, name) is kernel
    assert tl2.parse_runs(f"f32-but-{name}:1e-4") == [(f"f32-but-{name}", 1e-4)]


def _stage_coef_cases():
    base = torch.tensor([1.0, 2.0, 3.0], dtype=torch.float32)
    return {
        "f32 table": (base, [1.0, 2.0, 3.0], True),
        "f64 table": (base.double(), [1.0, 2.0, 3.0], False),
        "strided": (torch.arange(6, dtype=torch.float32)[::2], [0.0, 2.0, 4.0], False),
        "0-d tensor": (torch.tensor(1.5), [1.5] * 3, False),
        "python scalar": (0.25, [0.25] * 3, False),
        "int scalar": (2, [2.0] * 3, False),
    }


@pytest.mark.parametrize("case", list(_stage_coef_cases()))
def test_stage_coefs(case):
    a, want, same = _stage_coef_cases()[case]
    got = tst._stage_coefs(a, 3, torch.device("cpu"))
    assert got.dtype == torch.float32 and tuple(got.shape) == (3,) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got is a) == same


@pytest.mark.parametrize("a", [torch.ones(4), torch.ones(2), torch.ones(3, 1)])
def test_stage_coefs_rejects_a_wrong_length(a):
    with pytest.raises(ValueError, match=r"expected shape \(3,\)"):
        tst._stage_coefs(a, 3, "cpu")


def _band_cases():
    f32 = level_ops(make_level(3, 1), torch.float32)
    return {
        "f32 p=1": (f32, True),
        "f32 p=4": (level_ops(make_level(2, 4), torch.float32), True),
        "f64": (level_ops(make_level(3, 1), torch.float64), False),
        "p=5": (level_ops(make_level(2, 5), torch.float32), False),
        "strided": (dataclasses.replace(f32, mass_band=f32.mass_band.t().contiguous().t()),
                    False),
    }


@pytest.mark.parametrize("case", list(_band_cases()))
def test_kernel_bands(case):
    ops, want = _band_cases()[case]
    assert ops.kernel_bands is want


def _fma(w, v, acc):
    """f32 fused multiply-add: the f64 product of two f32 values is exact,
    so one rounding to f32 remains (f64 then f32: the model's only
    approximation of the card's FFMA)."""
    return (w.double() * v.double() + acc.double()).float()


def _k_u(order: str):
    """(K u in the f32 model of K5-2D's passes, K u in f64) for a smooth
    field at P3's finest level: y pass A = My u, B = Ky u; x pass
    K u = Mx B + Kx A with each tap's mass term added into the stiffness
    accumulator (``interleaved``, the order before the repair) or the two
    sums kept apart (``apart``)."""
    lev = make_level(10, 1)
    o32, o64 = level_ops(lev, torch.float32), level_ops(lev, torch.float64)
    m = o32.m
    x = torch.arange(1, m + 1, dtype=torch.float64) / (m + 1)
    u = (torch.sin(np.pi * x)[:, None] * torch.sin(2 * np.pi * x)[None, :] + 0.3)[None].float()
    mb, kb = o32.mass_band, o32.stiff_band
    up = torch.nn.functional.pad(u, (0, 0, 1, 1))
    A = B = torch.zeros_like(u)
    for j in range(3):
        A = _fma(mb[j][None, :, None], up[:, j:j + m], A)
        B = _fma(kb[j][None, :, None], up[:, j:j + m], B)
    Ap, Bp = (torch.nn.functional.pad(t, (1, 1)) for t in (A, B))
    ku, kx, mx = (torch.zeros_like(u) for _ in range(3))
    for j in range(3):
        a, b = Ap[:, :, j:j + m], Bp[:, :, j:j + m]
        if order == "interleaved":
            ku = ku + _fma(mb[j], b, kb[j] * a)
        else:
            kx, mx = _fma(kb[j], a, kx), _fma(mb[j], b, mx)
    if order == "apart":
        ku = kx + mx
    return ku, tst.mass_stiffness_apply_ref(o64, u.double())[1]


@pytest.fixture(scope="module")
def smooth_rows():
    """``chip_smoke.smooth_bias``'s 2D rows on the CPU, where every wrapper
    runs its plain version: the probe's own limits, from the plain versions."""
    rows = chip_smoke.smooth_rows(chip_smoke.smooth_cases_2d(torch.device("cpu")))
    return {r["name"]: r for r in rows}


@pytest.mark.parametrize("order", ["interleaved", "apart"])
def test_x_pass_order_against_the_smooth_field_probe(smooth_rows, order):
    ku, want = _k_u(order)
    bias = float((ku.double() - want).mean()) / float(want.abs().max())
    plain = smooth_rows["mass_stiffness_apply_2d"]["plain_mean"]
    limit = chip_smoke.SMOOTH_BIAS * abs(plain) + chip_smoke.SMOOTH_FLOOR
    assert (abs(bias) > limit) == (order == "interleaved"), (bias, limit)
