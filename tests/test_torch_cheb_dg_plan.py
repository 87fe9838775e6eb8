"""The launch plan of K3dg and K9d, the z-marching Chebyshev step
(``csrc/cheb_iter.cu::cheb_dg_march``), on the CPU: the kernels run only on
the card (``chip_smoke.py``), the plan and the launch arguments are Python.

* ``march_plan`` / ``march_planes``: for every 3D shape of
  ``chip_smoke.KERNEL_CASES``, ``PAIR_CASES`` and ``HALO_CASES`` (each slab
  of each space split, one stage per slot) and for P4's, P7's and P10's
  K3dg / K9d launches, the grid's (y, x) tiles cover [0, m)^2 and its z
  blocks cover every output plane of every stage exactly once, with at
  most ``MARCH_MAX_CHUNK`` planes per block; a launch has at least
  ``MARCH_MIN_BLOCKS`` (two per SM of the H100) blocks wherever one-plane
  chunks would give that many, and P4's, P7's and P10's launches do;
* the K3dg and K9d wrappers hand the C entry points the arguments of
  ``build.SIGNATURES`` in order: pointers, ``b`` by value, the (q,)
  coefficient tables of ``a``, ``c1`` and ``c2``, the plan's chunk.
"""

import os
import sys

import pytest
import torch

# one intra-op thread: the tests run beside other test processes
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
from dealii_spirk_tpu_torch.fem.grid import make_level
from dealii_spirk_tpu_torch.ops.cuda import build
from dealii_spirk_tpu_torch.ops.cuda import stencil as st
from dealii_spirk_tpu_torch.ops.mass_laplace import level_ops, slab_ops
from dealii_spirk_tpu_torch.parallel.sharding import z_partition


def _m(ref: int, p: int) -> int:
    return p * 2**ref - 1


def _launches() -> dict:
    """(q, nz, m) of every K3dg / K9d launch shape, by where it comes from."""
    shapes = {}
    for dim, q, ref, p, *_ in chip_smoke.KERNEL_CASES:
        if dim == 3:
            shapes[f"kernel q={q} r={ref} p={p}"] = (q, _m(ref, p), _m(ref, p))
    for q, ref, p, _timed in chip_smoke.PAIR_CASES:
        shapes[f"pair q={q} r={ref} p={p}"] = (q, _m(ref, p), _m(ref, p))
    for _q, ref, p, nsps, _timed in chip_smoke.HALO_CASES:
        m = _m(ref, p)
        for nsp in nsps:
            for z0, nz in z_partition(m, nsp):
                shapes[f"halo r={ref} p={p} {nsp} slabs, planes {z0}+{nz}"] = (1, nz, m)
    return shapes


# the paths' launches: P4's and P10's six-lane V-cycle on the 255 level (K3dg;
# P10 checks K8 against it), P7's slabs of a (2, 2) mesh (K9d, one stage per slot)
PATHS = {"P4": (6, 255, 255), "P10": (6, 255, 255), "P7 slab 0": (1, 128, 255),
         "P7 slab 1": (1, 127, 255)}
SHAPES = {**_launches(), **PATHS}


@pytest.mark.parametrize("where", sorted(SHAPES))
def test_march_plan_covers_every_plane_once(where):
    q, nz, m = SHAPES[where]
    chunk, grid = st.march_plan(q, nz, m)
    assert 1 <= chunk <= st.MARCH_MAX_CHUNK
    ty, tx = st.MARCH_TILE
    assert (grid[0] - 1) * tx < m <= grid[0] * tx
    assert (grid[1] - 1) * ty < m <= grid[1] * ty
    seen = {}
    for bz in range(grid[2]):
        stage, z0, z1 = st.march_planes(nz, chunk, bz)
        assert 0 <= stage < q and 0 <= z0 < z1 <= nz and z1 - z0 <= chunk
        for z in range(z0, z1):
            seen[stage, z] = seen.get((stage, z), 0) + 1
    assert seen == {(i, z): 1 for i in range(q) for z in range(nz)}
    blocks = grid[0] * grid[1] * grid[2]
    if grid[0] * grid[1] * q * nz >= st.MARCH_MIN_BLOCKS:
        assert blocks >= st.MARCH_MIN_BLOCKS, (chunk, grid)
    if where in PATHS:
        assert blocks >= 2 * 132


def _capture(monkeypatch):
    calls = []
    monkeypatch.setattr(st, "_on_cpu", lambda *ts: False)
    monkeypatch.setattr(st, "_launch_raw", lambda name, device, *args: calls.append((name, args)))
    return calls


def _check_args(name: str, args: tuple, q: int, ints: tuple) -> None:
    sig = build.SIGNATURES[name][:-1]  # the stream is _launch_raw's
    assert len(args) == len(sig)
    for arg, kind in zip(args, sig):
        if kind is build._F:
            assert isinstance(arg, float)
        else:
            assert isinstance(arg, int)
    assert args[11] == 0.1  # b
    assert args[-len(ints):] == ints


@pytest.mark.parametrize("halo", [False, True])
def test_dg_launch_arguments(monkeypatch, halo):
    q, ref = 3, 4
    ops = level_ops(make_level(ref, 1), torch.float32, "cpu")
    m = ops.m
    a, c1, c2 = (torch.linspace(lo, lo + 1, q) for lo in (1.0, 0.2, 0.1))
    calls = _capture(monkeypatch)
    if halo:
        z0, nzl = 5, 6
        sops = slab_ops(ops, z0, nzl)
        d_h = torch.zeros(q, nzl + 2, m, m)
        r, x = torch.zeros(q, nzl, m, m), torch.zeros(q, nzl, m, m)
        st.cheb_iter_dg_halo(sops, a, 0.1, c1, c2, d_h, r, x)
        name, ints = "spirk_cheb_iter_dg_halo", (q, m, nzl, z0, st.march_plan(q, nzl, m)[0], 1)
    else:
        d, r, x = (torch.zeros(q, m, m, m) for _ in range(3))
        st.cheb_iter_dg(ops, a, 0.1, c1, c2, d, r, x)
        name, ints = "spirk_cheb_iter_dg", (q, m, st.march_plan(q, m, m)[0], 1)
    ((called, args),) = calls
    assert called == name
    _check_args(name, args, q, ints)
    # a, c1, c2 go as they are: f32 contiguous (q,) tensors need no copy
    assert (args[10], args[12], args[13]) == (a.data_ptr(), c1.data_ptr(), c2.data_ptr())
