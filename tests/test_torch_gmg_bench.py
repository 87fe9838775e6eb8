"""The port's GMG microbenchmark (``dealii_spirk_tpu_torch/gmg_bench.py``)
against the JAX package's (``dealii_spirk_tpu/gmg_bench.py``), on the CPU
at f64:

* without a CUDA device the CLI's default ``--device cuda`` stops with an
  error;
* both CLIs at ``--dim 2 --min-ref 3 --max-ref 4`` and at 3D refinement 4
  print equal ``it_scalar``, ``it_fesystem8``, ``it_batched8`` and
  ``it_subgroups8`` (the JAX package runs ``subgroups8`` on its 8 virtual
  devices, the port on an (8, 1) slot mesh of CPU slots), each at most 15
  (``tests/test_gmg_bench.py``);
* ``_bench_mode`` given JAX's own right-hand side takes JAX's counts;
* ``normal_rhs`` equals ``jax.random.normal(PRNGKey(7))`` to 1e-14 of
  max|x| at f64; at f32 to 1e-5, where JAX evaluates erfinv in f32 (its
  approximation is 2.1e-6 of max|x| off the f64 value cast to f32 at
  (8, 15, 15)) and the port in f64;
* the ``dense`` op-mode (MatrixBased levels) takes the ``stencil`` counts;
* ``chip_smoke.bench_launches`` (P14's launch structure) against the
  kernel wrappers' counted calls in every mode, 2D and 3D, with K3dg
  brought down to the 31 level.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# one intra-op thread: the tests run beside other test processes
torch.set_num_threads(1)

import dealii_spirk_tpu.gmg_bench as jbench
import dealii_spirk_tpu_torch.gmg_bench as tbench
from dealii_spirk_tpu_torch.fem.grid import make_space
from dealii_spirk_tpu_torch.ops.cuda import stencil as tst
from dealii_spirk_tpu_torch.solvers import gmg as tgmg

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
from test_torch_transfer import count_transfers  # noqa: E402

CLI_CASES = {
    "2D r3-4": ["--dim", "2", "--min-ref", "3", "--max-ref", "4"],
    "3D r4": ["--dim", "3", "--min-ref", "4", "--max-ref", "4"],
}


def _rows(text: str) -> list[dict]:
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


@pytest.fixture(scope="module")
def cli_rows():
    """Each CLI case's JSON rows from both packages' CLIs."""
    import contextlib
    import io

    out = {}
    for case, argv in CLI_CASES.items():
        rows = {}
        for pkg, args in (("jax", argv), ("torch", ["--device", "cpu"] + argv)):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = (jbench if pkg == "jax" else tbench).main(args)
            assert rc == 0
            rows[pkg] = _rows(buf.getvalue())
        out[case] = rows
    return out


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_counts_match_jax(cli_rows, case):
    j, t = cli_rows[case]["jax"], cli_rows[case]["torch"]
    assert [r["refinement"] for r in t] == [r["refinement"] for r in j]
    for tr, jr in zip(t, j):
        assert tr["n_dofs"] == jr["n_dofs"]
        for mode in tbench.MODES:
            assert f"it_{mode}" in jr  # JAX ran every mode (8 virtual devices)
            assert tr[f"it_{mode}"] == jr[f"it_{mode}"], mode
            assert tr[f"t_per_it_{mode}"] > 0
        assert tr["it_scalar"] <= 15


def test_cli_refuses_cuda_without_a_card(capsys):
    """``--device cuda`` is the default, and without a CUDA device the CLI
    stops with an error instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit):
        tbench.main(["--dim", "2", "--min-ref", "3", "--max-ref", "3"])
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("label", ["scalar", "batched8", "subgroups8"])
def test_bench_mode_with_jax_rhs(cli_rows, label):
    """The port's solve on JAX's own right-hand side array: JAX's count."""
    space = make_space(3, 1, 4)
    shape = ((8,) if label != "scalar" else ()) + space.shape
    rhs = np.asarray(jax.random.normal(jax.random.PRNGKey(7), shape, dtype=jnp.float64))
    gmg = tgmg.build_gmg_data(space, torch.float64)
    res = tbench._bench_mode(space, gmg, 3, label, torch.float64, kernels=False, device="cpu",
                             rhs=rhs, repetitions=0)
    assert res.iterations == cli_rows["3D r4"]["jax"][0][f"it_{label}"]
    assert res.true_residual <= 2 * tbench.reltol_of(torch.float64)


@pytest.mark.parametrize("shape", [(8, 15, 15), (7, 7, 7), (5,)])
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_normal_rhs_is_jax_normal(shape, dtype):
    jdt, tdt, tol = {"f64": (jnp.float64, torch.float64, 1e-14),
                     "f32": (jnp.float32, torch.float32, 1e-5)}[dtype]
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(7), shape, dtype=jdt))
    got = tbench.normal_rhs(7, shape, tdt).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("label", list(tbench.MODES))
def test_dense_op_mode_equals_stencil(label):
    """MatrixBased levels (``--op-mode dense``) against the banded ones."""
    space = make_space(3, 1, 4)
    res = {}
    for dense in (False, True):
        gmg = tgmg.build_gmg_data(space, torch.float64, with_dense=dense)
        assert all((o.mode == "dense") == dense for o in gmg.level_ops)
        res[dense] = tbench._bench_mode(space, gmg, 3, label, torch.float64, kernels=False,
                                        device="cpu", repetitions=0)
    assert res[True].iterations == res[False].iterations
    assert max(r.true_residual for r in res.values()) <= 2 * tbench.reltol_of(torch.float64)


def count_wrappers(monkeypatch) -> dict:
    """Each kernel wrapper's calls, keyed as ``LAUNCHES`` (a 2D block under
    ``<key>_2d``); on CPU tensors a wrapper runs its plain version."""
    calls = dict.fromkeys(tst.LAUNCHES, 0)
    for name in ("stencil_apply", "cheb_iter", "cheb_iter_dg", "stencil_apply_halo",
                 "cheb_iter_halo", "cheb_iter_dg_halo"):
        wrapper = getattr(tst, name)

        def counted(*args, _name=name, _wrapper=wrapper):
            calls[_name + ("_2d" if args[-1].ndim == 3 else "")] += 1
            return _wrapper(*args)

        monkeypatch.setattr(tst, name, counted)
    count_transfers(monkeypatch, calls)
    return calls


@pytest.mark.parametrize("label", list(tbench.MODES))
@pytest.mark.parametrize("dim, ref", [(3, 5), (2, 4)])
def test_chip_smoke_bench_launches(monkeypatch, label, dim, ref):
    """P14's launch structure: in 3D refinement 5 the 31 level smoothed by
    K3dg (the threshold lowered to it), the 15 level by K3; ``subgroups8``
    splits both (one z slab per slot), in 2D none."""
    monkeypatch.setattr(tgmg, "CHEB_DIAG_MIN_POINTS", 31**3)
    calls = count_wrappers(monkeypatch)
    space = make_space(dim, 1, ref)
    gmg = tgmg.build_gmg_data(space, torch.float64)
    res = tbench._bench_mode(space, gmg, dim, label, torch.float64, kernels=True,
                             device="cpu", repetitions=1)
    want = chip_smoke.bench_launches(gmg, dim, label, res.iterations, solves=2)
    assert calls == want
    if dim == 3:
        keys = (("stencil_apply_halo", "cheb_iter_halo", "cheb_iter_dg_halo")
                if label == "subgroups8" else ("stencil_apply", "cheb_iter", "cheb_iter_dg"))
    else:
        keys = ("stencil_apply_2d",)
    assert all(want[k] > 0 for k in keys)
