"""The launch plan of the z march (``csrc/march.cuh``: K4, K3, K3dg and
their slab forms K9a, K9c, K9d), on the CPU: the kernels run only on the
card (``chip_smoke.py``), the plan and the launch arguments are Python.

* ``march_plan`` / ``march_planes``: for every 3D shape of
  ``chip_smoke.KERNEL_CASES``, ``PAIR_CASES`` and ``HALO_CASES`` (each slab
  of each space split, one stage per slot) and for every z-march launch of
  the paths (P1, P2, P4-P10: each smoothed level, each slab of a mesh
  path's two space slots, with the lanes of its V-cycles), the grid's
  (y, x) tiles cover [0, m)^2 and its z blocks cover every output plane of
  every stage exactly once, with at most ``MARCH_MAX_CHUNK`` planes per
  block; a launch has at least ``MARCH_MIN_BLOCKS`` (two per SM of the H100) blocks
  wherever one-plane chunks would give that many, and P4's, P7's and
  P10's launches on the 255 level do;
* the six march wrappers hand the C entry points the arguments of
  ``build.SIGNATURES`` in order: pointers, ``b`` by value, the (q,)
  coefficient tables of ``a`` (and ``c1``, ``c2``), the plan's chunk.
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
    """(q, nz, m) of every z-march launch shape of the kernels phase."""
    shapes = {}
    for dim, q, ref, p, *_ in chip_smoke.KERNEL_CASES:
        if dim == 3:
            shapes[f"kernel q={q} r={ref} p={p}"] = (q, _m(ref, p), _m(ref, p))
    for q, ref, p, _timed in chip_smoke.PAIR_CASES:
        shapes[f"pair q={q} r={ref} p={p}"] = (q, _m(ref, p), _m(ref, p))
    for _q, ref, p, nsps, _timed in chip_smoke.HALO_CASES:
        m = _m(ref, p)
        for nsp in nsps:
            for z0, z1 in z_partition(m, nsp):
                shapes[f"halo r={ref} p={p} {nsp} slabs, planes {z0}:{z1}"] = (1, z1 - z0, m)
    return shapes


# the lanes of a path's V-cycle launches: whole blocks (P1 four stages, P2
# one at a time, P4 and P10 six pair lanes, P5 three), or per slot of a
# mesh path with two space slots (P6, P7 and P9 one lane, P8 two)
PATH_LANES = {"P1": 4, "P2": 1, "P4": 6, "P5": 3, "P10": 6}
MESH_LANES = {"P6": 1, "P7": 1, "P8": 2, "P9": 1}


def _path_launches() -> dict:
    shapes = {}
    for name, (_dim, cfg, n_levels) in chip_smoke.PATHS.items():
        top = cfg["NRefinements"]
        for ref in range(top - n_levels + 1, top + 1):
            m = _m(ref, 1)
            if name in PATH_LANES:
                shapes[f"{name} r={ref}"] = (PATH_LANES[name], m, m)
            elif name in MESH_LANES:
                for z0, z1 in z_partition(m, 2):
                    shapes[f"{name} r={ref} planes {z0}:{z1}"] = (MESH_LANES[name], z1 - z0, m)
    return shapes


PATHS = _path_launches()
SHAPES = {**_launches(), **PATHS}
# the 255 level of the paths that the device binds or that time K9d
FILLED = ("P4 r=8", "P10 r=8", "P7 r=8 planes 0:128", "P7 r=8 planes 128:255")


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
    if where in FILLED:
        assert blocks >= 2 * 132


def test_the_paths_filled_shapes_exist():
    assert set(FILLED) <= set(PATHS)


def _capture(monkeypatch):
    calls = []
    monkeypatch.setattr(st, "_on_cpu", lambda *ts: False)
    monkeypatch.setattr(st, "_launch_raw", lambda name, device, *args: calls.append((name, args)))
    return calls


# entry point: (fields before the band tables, has c1 and c2, on a slab)
ENTRIES = {
    "spirk_stencil_apply": (2, False, False),
    "spirk_stencil_apply_halo": (2, False, True),
    "spirk_cheb_iter": (7, True, False),
    "spirk_cheb_iter_halo": (7, True, True),
    "spirk_cheb_iter_dg": (8, True, False),
    "spirk_cheb_iter_dg_halo": (8, True, True),
}


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_dg_launch_arguments(monkeypatch, name):
    """Each march wrapper hands its entry point ``build.SIGNATURES``'s
    arguments in order; a, c1, c2 go as they are (f32 contiguous (q,)
    tensors need no copy); ``q, m, [nzl, z_off,] chunk, p`` last."""
    n_fields, cheb, halo = ENTRIES[name]
    q, ref, z0, nzl = 3, 4, 5, 6
    ops = level_ops(make_level(ref, 1), torch.float32, "cpu")
    m = ops.m
    a, c1, c2 = (torch.linspace(lo, lo + 1, q) for lo in (1.0, 0.2, 0.1))
    calls = _capture(monkeypatch)
    nz = nzl if halo else m
    sops = slab_ops(ops, z0, nzl) if halo else ops
    d = torch.zeros(q, nz + 2 * halo, m, m)
    r, x, invd = (torch.zeros(q, nz, m, m) for _ in range(3))
    fn = getattr(st, name.removeprefix("spirk_"))
    if not cheb:
        fn(sops, a, 0.1, d)
    elif "_dg" in name:
        fn(sops, a, 0.1, c1, c2, d, r, x)
    else:
        fn(sops, a, 0.1, c1, c2, d, r, x, invd)
    ((called, args),) = calls
    assert called == name
    sig = build.SIGNATURES[name][:-1]  # the stream is _launch_raw's
    assert len(args) == len(sig)
    for arg, kind in zip(args, sig):
        assert isinstance(arg, float if kind is build._F else int)
    chunk, _grid = st.march_plan(q, nz, m)
    slab = (nzl, z0) if halo else ()
    assert args[-(4 + len(slab)):] == (q, m, *slab, chunk, 1)
    assert args[0] == d.data_ptr()
    assert args[n_fields : n_fields + 4] == (
        sops.mass_band.data_ptr(), sops.stiff_band.data_ptr(), a.data_ptr(), 0.1)
    if cheb:
        assert args[n_fields + 4 : n_fields + 6] == (c1.data_ptr(), c2.data_ptr())
        assert args[1:3] == (r.data_ptr(), x.data_ptr())
    if name in ("spirk_cheb_iter", "spirk_cheb_iter_halo"):
        assert args[3] == invd.data_ptr()
    if "_dg" in name:
        assert args[3:5] == (sops.mass_diag.data_ptr(), sops.stiff_diag.data_ptr())
