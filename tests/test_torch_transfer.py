"""K10, the V-cycle's grid transfers (``ops/cuda/transfer.py``,
``csrc/transfer.cu``), on the CPU: the kernels run only on the card
(``chip_smoke.py``), their run tables, plan, schedule and launch arguments
are Python.

* ``row_runs`` rebuilds P and P^T exactly: the Lagrange prolongation at
  p = 1-4 on two refinements, and AMG's aggregation (odd and even m);
  ``transfer_runs`` admits every level pair of the hierarchies the paths
  and cells build; a P whose runs are too wide gets no run form, keeps the
  dense code on the CPU and raises on the card;
* the kernels' schedule (tiles, z chunks, the ring of open z sums or of
  coarse planes, the z, y and x passes in the plain versions' order), as a
  numpy model of ``csrc/transfer.cu``'s control flow, gives the dense
  transfers at f64 round-off on small hierarchies, at the plan's chunks
  and at chunks of 1 and 64;
* on CPU tensors ``restrict_residual`` and ``prolong_add`` equal the
  V-cycle's plain code (``restrict(P, rl - ax)``, ``x + prolong(P, xc)``)
  bit for bit in f64, q = 1 and 6, and ``vcycle(kernels=True)`` on the CPU
  returns the dense path's tensor bit for bit, calls each entry point once
  per level pair and launches nothing;
* the wrappers hand ``build.SIGNATURES``' arguments in order, and the
  constants mirror csrc's; ``scripts/torch_l2_tolerance.py``'s
  ``f32-but-transfer`` arm swaps both wrappers for their plain versions.
"""

import os
import re

import numpy as np
import pytest
import torch

# one intra-op thread: the tests run beside other test processes
torch.set_num_threads(1)

from dealii_spirk_tpu_torch.fem.assembly import prolongation_1d  # noqa: E402
from dealii_spirk_tpu_torch.fem.grid import make_space  # noqa: E402
from dealii_spirk_tpu_torch.ops.cuda import build  # noqa: E402
from dealii_spirk_tpu_torch.ops.cuda import stencil as tst  # noqa: E402
from dealii_spirk_tpu_torch.ops.cuda import transfer as ttr  # noqa: E402
from dealii_spirk_tpu_torch.ops.transfer import prolong, restrict  # noqa: E402
from dealii_spirk_tpu_torch.solvers import gmg as tgmg  # noqa: E402
from dealii_spirk_tpu_torch.solvers.amg import aggregation_prolongator, build_amg_data  # noqa: E402

CSRC = os.path.join(os.path.dirname(build.__file__), os.pardir, os.pardir, "csrc",
                    "transfer.cu")
ENTRY_KEYS = {"restrict_residual": "transfer_restrict", "prolong_add": "transfer_prolong"}


def count_transfers(monkeypatch, calls: dict) -> None:
    """Count K10's wrapper calls into ``calls`` under their ``LAUNCHES``
    keys (on CPU tensors they run their plain versions)."""
    for name, key in ENTRY_KEYS.items():
        wrapper = getattr(ttr, name)

        def counted(*args, _key=key, _wrapper=wrapper):
            calls[_key] += 1
            return _wrapper(*args)

        monkeypatch.setattr(ttr, name, counted)


def _prolongations() -> dict:
    mats = {f"Q{p} {nc} cells": prolongation_1d(nc, p) for p in (1, 2, 3, 4) for nc in (4, 32)}
    mats |= {f"AMG m={m}": aggregation_prolongator(m) for m in (15, 16, 63, 64)}
    return mats


MATS = _prolongations()


def _dense(start, weights, cols):
    rows, width = weights.shape
    A = np.zeros((rows, cols))
    for r in range(rows):
        for k in range(width):
            if start[r] + k < cols:
                A[r, start[r] + k] = weights[r, k]
    return A


@pytest.mark.parametrize("name", sorted(MATS))
def test_row_runs_rebuild_p_exactly(name):
    P = MATS[name]
    t = ttr.transfer_runs(torch.as_tensor(P))
    assert t.fits
    np.testing.assert_array_equal(_dense(t.start.numpy(), t.weights.numpy(), P.shape[1]), P)
    np.testing.assert_array_equal(_dense(t.start_t.numpy(), t.weights_t.numpy(), P.shape[0]),
                                  P.T)
    assert t.start.dtype == t.start_t.dtype == torch.int32
    if name.startswith("Q"):  # P's rows p + 1 wide, P^T's 4p - 1
        p = int(name[1])
        assert (t.weights.shape[1], t.weights_t.shape[1]) == (p + 1, 4 * p - 1)
    else:
        assert (t.weights.shape[1], t.weights_t.shape[1]) == (2, 3)


HIERARCHIES = [(p, ref, amg) for p in (1, 2, 3, 4) for ref in (4, 6, 8) for amg in (False, True)]


@pytest.mark.parametrize("p, ref, amg", HIERARCHIES)
def test_every_level_pair_takes_the_kernels(p, ref, amg):
    """Every pair of the geometric and aggregation hierarchies at
    refinements 4-8 (the cells' 511 <- 255 at Q4 r7 lies inside: r8's
    hierarchy holds it) fits the kernels' tiles and ring."""
    space = make_space(3, p, ref)
    gmg = (build_amg_data if amg else tgmg.build_gmg_data)(space, torch.float32)
    assert len(gmg.transfers) == len(gmg.prolongs) >= 1
    for P, t in zip(gmg.prolongs, gmg.transfers, strict=True):
        assert t.fits and t.P is P
        assert t.weights.dtype == torch.float32


def test_a_too_wide_run_keeps_the_dense_path(monkeypatch):
    """A P whose rows are wider than the kernels take: ``transfer_runs``
    gives it no run form and the ``GMGData`` records that.  The dense path
    stays only where the plain versions run (CPU tensors); on the card both
    entry points raise before any launch, so a kernel V-cycle never falls
    back to the dense code."""
    space = make_space(3, 1, 5)
    gmg = tgmg.build_gmg_data(space)
    wide = torch.rand(gmg.prolongs[-1].shape, dtype=torch.float64) + 0.1  # dense rows
    assert not ttr.transfer_runs(wide).fits
    data = tgmg.GMGData(gmg.level_ops, gmg.prolongs[:-1] + (wide,), gmg.coarse_mass,
                        gmg.coarse_stiff)
    t = data.transfers[-1]
    assert t.P is wide and not t.fits and all(u.fits for u in data.transfers[:-1])
    m_f, m_c = wide.shape
    fine, coarse = torch.rand(1, m_f, m_f, m_f, dtype=torch.float64), torch.rand(1, m_c, m_c, m_c,
                                                                                 dtype=torch.float64)
    assert torch.equal(ttr.restrict_residual(t, fine, fine), restrict(wide, fine - fine, 3))
    assert torch.equal(ttr.prolong_add(t, fine, coarse), fine + prolong(wide, coarse, 3))
    launched = []
    monkeypatch.setattr(ttr, "_on_cpu", lambda *ts: False)
    monkeypatch.setattr(ttr, "_launch_raw", lambda *args: launched.append(args))
    with pytest.raises(ValueError, match="does not take"):
        ttr.restrict_residual(t, fine.float(), fine.float())
    with pytest.raises(ValueError, match="does not take"):
        ttr.prolong_add(t, fine.float(), coarse.float())
    assert launched == []


def _restrict_model(t: ttr.TransferRuns, res: np.ndarray, chunk: int,
                    tile=ttr.RESTRICT_TILE) -> np.ndarray:
    """csrc transfer_restrict_kernel's schedule in numpy: per lane, coarse
    (y, x) tile and chunk of coarse planes, the march over fine planes with
    the ring of open coarse planes' z sums on the fine tile, and each plane's
    y and x passes once the fine plane of its last nonzero tap has
    passed."""
    st, w = t.start_t.numpy(), t.weights_t.numpy()
    W, (ty, tx), (fy, fx), R = w.shape[1], tile, ttr.RESTRICT_SPAN, ttr.TRANSFER_RING
    q, mf, mc = res.shape[0], res.shape[1], st.shape[0]
    close = ttr._last(st, w)  # where each coarse plane's sum closes: its last nonzero tap
    assert close.max() < mf
    out = np.full((q, mc, mc, mc), np.nan)
    for lane in range(q):
        for Y0 in range(0, mc, ty):
            for X0 in range(0, mc, tx):
                Ys, Xs = np.arange(Y0, min(Y0 + ty, mc)), np.arange(X0, min(X0 + tx, mc))
                fy0, fx0 = st[Ys].min(), st[Xs].min()
                ny, nx = (st[Ys] + W).max() - fy0, (st[Xs] + W).max() - fx0
                assert ny <= fy and nx <= fx
                for J0 in range(0, mc, chunk):
                    J1 = min(J0 + chunk, mc)
                    fz0, fz1 = st[J0:J1].min(), (close[J0:J1]).max() + 1
                    jj = [J0 + s for s in range(R)]
                    js = [st[j] if j < J1 else 0 for j in jj]
                    S = np.zeros((R, fy, fx))
                    for z in range(fz0, fz1):
                        F = np.zeros((fy, fx))
                        y1, x1 = min(fy0 + ny, mf), min(fx0 + nx, mf)
                        F[: y1 - fy0, : x1 - fx0] = res[lane, z, fy0:y1, fx0:x1]
                        for s in range(R):
                            if jj[s] < J1 and js[s] <= z < js[s] + W:
                                S[s] += w[jj[s], z - js[s]] * F
                        for s in range(R):
                            if jj[s] < J1 and z == close[jj[s]]:
                                G = np.stack([w[Y] @ S[s][st[Y] - fy0 : st[Y] - fy0 + W]
                                              for Y in Ys])
                                out[lane, jj[s], Y0 : Y0 + len(Ys), X0 : X0 + len(Xs)] = np.stack(
                                    [G[:, st[X] - fx0 : st[X] - fx0 + W] @ w[X] for X in Xs],
                                    axis=1)
                                S[s] = 0.0
                                jj[s] += R
                                js[s] = st[jj[s]] if jj[s] < J1 else 0
    return out


def _prolong_model(t: ttr.TransferRuns, x: np.ndarray, xc: np.ndarray, chunk: int,
                   tile=ttr.PROLONG_TILE) -> np.ndarray:
    """csrc transfer_prolong_kernel's schedule in numpy: per lane, fine
    (y, x) tile and chunk of fine planes, each coarse plane's tile loaded
    once into its ring slot as the fine planes' nonzero taps come to reach
    it, and each fine plane's z pass over the slots of its nonzero taps,
    then its y and x passes."""
    st, w = t.start.numpy(), t.weights.numpy()
    W, (ty, tx), (cy, cx), R = w.shape[1], tile, ttr.PROLONG_SPAN, ttr.TRANSFER_RING
    q, mf, mc = x.shape[0], x.shape[1], xc.shape[1]
    last = ttr._last(st, w)  # each fine plane's last nonzero tap
    out = np.full(x.shape, np.nan)
    for lane in range(q):
        for y0 in range(0, mf, ty):
            for x0 in range(0, mf, tx):
                ys, xs = np.arange(y0, min(y0 + ty, mf)), np.arange(x0, min(x0 + tx, mf))
                cy0, cx0 = st[ys].min(), st[xs].min()
                ncy, ncx = (st[ys] + W).max() - cy0, (st[xs] + W).max() - cx0
                assert ncy <= cy and ncx <= cx
                for i0 in range(0, mf, chunk):
                    i1 = min(i0 + chunk, mf)
                    a0, a1 = st[i0:i1].min(), min((st[i0:i1] + W).max(), mc)
                    C = np.full((R, cy, cx), np.nan)
                    loaded, need = a0, 0
                    for i in range(i0, i1):
                        need = max(need, last[i] + 1)
                        while loaded < need:
                            C[(loaded - a0) % R] = 0.0
                            y1, x1 = min(cy0 + ncy, mc), min(cx0 + ncx, mc)
                            C[(loaded - a0) % R, : y1 - cy0, : x1 - cx0] = (
                                xc[lane, loaded, cy0:y1, cx0:x1])
                            loaded += 1
                        T = np.zeros((cy, cx))
                        for k in range(W):
                            if w[i, k] != 0:
                                T += w[i, k] * C[(st[i] + k - a0) % R]
                        H = np.stack([w[Y] @ T[st[Y] - cy0 : st[Y] - cy0 + W] for Y in ys])
                        out[lane, i, y0 : y0 + len(ys), x0 : x0 + len(xs)] = (
                            x[lane, i, y0 : y0 + len(ys), x0 : x0 + len(xs)]
                            + np.stack([H[:, st[X] - cx0 : st[X] - cx0 + W] @ w[X] for X in xs],
                                       axis=1))
    return out


# (degree, coarse cells (AMG: m), AMG, chunk (None: the plan's), small
# tiles: 4 x 8 in both kernels, so that a field holds several tiles per axis)
MODEL_CASES = [(1, 8, False, None, False), (1, 8, False, 1, False), (2, 4, False, None, False),
               (3, 4, False, 64, False), (4, 8, False, None, False), (4, 4, False, 1, False),
               (1, 31, True, None, False), (4, 16, True, 1, False), (4, 4, False, None, True),
               (1, 31, True, 4, True)]


@pytest.mark.parametrize("p, nc, amg, chunk, small", MODEL_CASES)
def test_kernel_schedule_gives_the_dense_transfers(p, nc, amg, chunk, small):
    """The schedule covers every output once with every tap: f64 round-off
    of the dense transfers (two lanes, random fields)."""
    P = aggregation_prolongator(nc) if amg else prolongation_1d(nc, p)
    t = ttr.transfer_runs(torch.as_tensor(P))
    m_f, m_c = P.shape
    rng = np.random.default_rng(m_f + 10 * p)
    res, x = rng.uniform(-1, 1, (2, 2, m_f, m_f, m_f))
    xc = rng.uniform(-1, 1, (2, m_c, m_c, m_c))
    rchunk = chunk or ttr.transfer_plan("restrict", 2, m_f, m_c)
    pchunk = chunk or ttr.transfer_plan("prolong", 2, m_f, m_c)
    want_r = restrict(torch.as_tensor(P), torch.as_tensor(res), 3).numpy()
    want_p = (torch.as_tensor(x) + prolong(torch.as_tensor(P), torch.as_tensor(xc), 3)).numpy()
    tile = {"tile": (4, 8)} if small else {}
    np.testing.assert_allclose(_restrict_model(t, res, rchunk, **tile), want_r, rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(_prolong_model(t, x, xc, pchunk, **tile), want_p, rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("q", [1, 6])
@pytest.mark.parametrize("p", [1, 2, 3, 4])
def test_entry_points_equal_the_plain_code_bitwise(p, q):
    space = make_space(3, p, 3)
    gmg = tgmg.build_gmg_data(space)
    rng = np.random.default_rng(10 * p + q)
    for P, t in zip(gmg.prolongs, gmg.transfers, strict=True):
        m_f, m_c = P.shape
        rl, ax, x = (torch.as_tensor(rng.uniform(-1, 1, (q, m_f, m_f, m_f))) for _ in range(3))
        xc = torch.as_tensor(rng.uniform(-1, 1, (q, m_c, m_c, m_c)))
        assert torch.equal(ttr.restrict_residual(t, rl, ax), restrict(P, rl - ax, 3))
        assert torch.equal(ttr.prolong_add(t, x, xc), x + prolong(P, xc, 3))


@pytest.mark.parametrize("amg", [False, True])
def test_cpu_kernel_vcycle_equals_the_dense_path(monkeypatch, amg):
    """``vcycle(kernels=True)`` on CPU tensors: bit for bit the V-cycle
    whose transfers are the dense code with its elementwise passes (the
    parent's), one K10 call per direction, level pair and V-cycle, and no
    launch."""
    space = make_space(3, 2, 3)
    gmg = (build_amg_data if amg else tgmg.build_gmg_data)(space)
    q = 2
    a = torch.tensor([1.5, 2.5], dtype=torch.float64)
    prec = tgmg.gmg_reinit(gmg, a, 0.1, 3)
    m = gmg.level_ops[-1].m
    r = torch.as_tensor(np.random.default_rng(7).uniform(-1, 1, (q, m, m, m)))
    calls = dict.fromkeys(tst.LAUNCHES, 0)
    count_transfers(monkeypatch, calls)
    tst.reset_launches()
    got = tgmg.vcycle(gmg, prec, a, 0.1, r, 3, kernels=True)
    pairs = len(gmg.transfers)
    assert calls["transfer_restrict"] == calls["transfer_prolong"] == pairs >= 1
    assert tst.LAUNCHES == dict.fromkeys(tst.LAUNCHES, 0)
    # the parent's code: the dense transfers and the two elementwise passes
    monkeypatch.setattr(ttr, "restrict_residual", lambda t, rl, ax: restrict(t.P, rl - ax, 3))
    monkeypatch.setattr(ttr, "prolong_add", lambda t, x, xc: x + prolong(t.P, xc, 3))
    want = tgmg.vcycle(gmg, prec, a, 0.1, r, 3, kernels=True)
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", sorted(ENTRY_KEYS))
def test_launch_arguments(monkeypatch, name):
    """Each wrapper hands its entry point ``build.SIGNATURES``' arguments in
    order: the fields, the run tables of P^T (restriction) or P
    (prolongation), q, m_f, m_c, the run width and ``transfer_plan``'s
    chunk."""
    calls = []
    monkeypatch.setattr(ttr, "_on_cpu", lambda *ts: False)
    monkeypatch.setattr(ttr, "_launch_raw", lambda n, device, *args: calls.append((n, args)))
    gmg = tgmg.build_gmg_data(make_space(3, 4, 3), torch.float32)
    t = gmg.transfers[-1]
    m_f, m_c = t.P.shape
    q = 3
    fine, fine2 = torch.zeros(q, m_f, m_f, m_f), torch.zeros(q, m_f, m_f, m_f)
    coarse = torch.zeros(q, m_c, m_c, m_c)
    tst.reset_launches()
    if name == "restrict_residual":
        out = ttr.restrict_residual(t, fine, fine2)
        tables, kind, other = (t.start_t, t.weights_t), "restrict", fine2
    else:
        out = ttr.prolong_add(t, fine, coarse)
        tables, kind, other = (t.start, t.weights), "prolong", coarse
    ((called, args),) = calls
    assert called == "spirk_" + ENTRY_KEYS[name]
    sig = build.SIGNATURES[called][:-1]  # the stream is _launch_raw's
    assert len(args) == len(sig) and all(isinstance(v, int) for v in args)
    assert args[:5] == (fine.data_ptr(), other.data_ptr(), out.data_ptr(),
                        tables[0].data_ptr(), tables[1].data_ptr())
    assert args[5:] == (q, m_f, m_c, tables[1].shape[1], ttr.transfer_plan(kind, q, m_f, m_c))
    assert tst.LAUNCHES[ENTRY_KEYS[name]] == 1
    tst.reset_launches()
    with pytest.raises(TypeError, match="float32"):
        ttr.restrict_residual(t, fine.double(), fine2.double())


def test_l2_script_swaps_both_transfers():
    """``scripts/torch_l2_tolerance.py``'s f32-but-transfer arm runs both
    K10 wrappers' plain versions and puts the kernels back after it."""
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                    "scripts"))
    import torch_l2_tolerance as tl2

    kernels = (ttr.restrict_residual, ttr.prolong_add)
    gmg = tgmg.build_gmg_data(make_space(3, 2, 3))
    t = gmg.transfers[-1]
    m_f, m_c = t.P.shape
    rl, ax = torch.rand(1, m_f, m_f, m_f, dtype=torch.float64), torch.rand(1, m_f, m_f, m_f)
    xc = torch.rand(1, m_c, m_c, m_c, dtype=torch.float64)
    with tl2.plain_wrapper(tl2.TRANSFER):
        assert (ttr.restrict_residual, ttr.prolong_add) != kernels
        assert torch.equal(ttr.restrict_residual(t, rl, ax.double()),
                           ttr.restrict_residual_ref(t.P, rl, ax.double()))
        assert torch.equal(ttr.prolong_add(t, rl, xc), ttr.prolong_add_ref(t.P, rl, xc))
    assert (ttr.restrict_residual, ttr.prolong_add) == kernels
    assert tl2.parse_runs("f32-but-transfer:1e-4") == [("f32-but-transfer", 1e-4)]


@pytest.mark.parametrize("kind", ["restrict", "prolong"])
@pytest.mark.parametrize("q, m_f, m_c", [(1, 511, 255), (6, 255, 127), (1, 15, 7), (4, 128, 64),
                                         (5, 255, 128)])
def test_transfer_plan(kind, q, m_f, m_c):
    chunk = ttr.transfer_plan(kind, q, m_f, m_c)
    n = m_c if kind == "restrict" else m_f
    assert chunk & (chunk - 1) == 0 and 1 <= chunk <= ttr.TRANSFER_MAX_CHUNK
    assert chunk < 2 * n


def test_constants_mirror_csrc():
    src = open(CSRC).read()

    def const(name):
        return int(re.search(rf"\b{name} = (\d+)", src).group(1))

    assert (const("RTY"), const("RTX")) == ttr.RESTRICT_TILE
    assert (const("RFY"), const("RFX")) == ttr.RESTRICT_SPAN
    assert (const("PTY"), const("PTX")) == ttr.PROLONG_TILE
    assert (const("PCY"), const("PCX")) == ttr.PROLONG_SPAN
    assert const("TRING") == ttr.TRANSFER_RING
    bounds = {kind: int(n) for n, kind in
              re.findall(r"__launch_bounds__\(TT, (\d)\) transfer_(restrict|prolong)", src)}
    assert bounds == ttr.RESIDENT
    for fn, widths in (("restrict", ttr.RESTRICT_WIDTHS), ("prolong", ttr.PROLONG_WIDTHS)):
        body = src[src.index(f"int spirk_transfer_{fn}("):]
        body = body[: body.index("default:")]
        assert tuple(int(w) for w in re.findall(r"case (\d+):", body)) == widths
