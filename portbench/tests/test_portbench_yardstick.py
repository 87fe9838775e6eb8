"""The frozen arithmetic: kernel bounds, the roofline share, busy and idle
shares."""

import math

import pytest

from portbench import devtrace, roofline


@pytest.mark.parametrize("lanes, bound_ms", [(6, 0.7128), (4, 0.4752)])
def test_k3dg_bound_is_perf_mds(lanes, bound_ms):
    """K3dg at m = 255: 6 passes x 4 B x lanes x 255^3 over 3.35 TB/s, as
    PERF.md's kernel table (P4's 6 lanes, P17's 4)."""
    seconds, binds = roofline.bound_s("cheb_iter_dg", lanes, 255**3, 4 if lanes == 4 else 1)
    assert binds == "bytes"
    assert round(seconds * 1e3, 4) == bound_ms


def test_k3dg_share_sums_each_launchs_bound():
    """The share is the bounds of the launches, each at its own lanes and
    m, over their summed device time; unread where the trace's ChebDiag
    kernels and the port's calls differ in number."""
    from portbench.run import read_metric

    calls = [{"kernel": "cheb_iter_dg", "lanes": 1, "m": 511, "p": 4}] * 2 + \
        [{"kernel": "cheb_iter_dg", "lanes": 1, "m": 255, "p": 4},
         {"kernel": "stencil_apply", "lanes": 1, "m": 255, "p": 4}]
    kernels = {"void spirk::march<4, spirk::ChebDiag, 0>(spirk::MarchArgs)": [3, 2e-3],
               "void spirk::march<4, spirk::Apply, 0>(spirk::MarchArgs)": [1, 1e-3]}
    bound = (2 * 511**3 + 255**3) * 6 * 4 / roofline.HBM_BYTES_PER_S
    share = read_metric("k3dg_roofline", {"trace": {"launches": calls, "kernels": kernels}})
    assert math.isclose(share, 100 * bound / 2e-3)
    kernels["void spirk::march<4, spirk::ChebDiag, 0>(spirk::MarchArgs)"][0] = 4
    assert read_metric("k3dg_roofline", {"trace": {"launches": calls, "kernels": kernels}}) is None
    assert read_metric("k3dg_roofline", {"trace": None}) is None


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_busy_idle_and_gaps():
    """Busy is the union of device intervals (overlap counted once), the
    idle share 1 - busy / wall, and each gap goes to the innermost host
    event under its midpoint."""
    events = [
        _x("user_annotation", devtrace.MARK, 0, 100),
        _x("gpu_user_annotation", devtrace.MARK, 5, 90),
        _x("kernel", "void march<4, ChebDiag>", 10, 20),
        _x("kernel", "k2", 25, 10),
        _x("gpu_memcpy", "Memcpy DtoH", 60, 10),
        _x("cpu_op", "aten::item", 40, 30),
        _x("cuda_runtime", "cudaStreamSynchronize", 45, 20),
        _x("cpu_op", "aten::add", 75, 2),
    ]
    r = devtrace.reduce(events, 100e-6)
    assert math.isclose(r["busy_s"], 35e-6)
    assert r["device_ops"] == 3
    assert r["kernels"]["void march<4, ChebDiag>"] == [1, 20e-6]
    assert math.isclose(r["idle_by_host"]["cudaStreamSynchronize"], 25e-6)
    assert math.isclose(r["idle_by_host"]["host Python, outside any op"], 40e-6)
    assert devtrace.top(r["idle_by_host"])[0][0] == "host Python, outside any op"


def test_trace_without_the_mark_is_refused():
    with pytest.raises(RuntimeError):
        devtrace.reduce([_x("kernel", "k", 0, 1)], 1.0)
