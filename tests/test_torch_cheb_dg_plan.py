"""The launch plan of the z march (``csrc/march.cuh``: K1, K3, K3dg, K4,
K5 and their slab forms K9a-K9d), on the CPU: the kernels run only on the
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
  coefficient tables of ``a`` (and ``c1``, ``c2``), the plan's chunk;
* K1 (the Mix mode: a block for every stage, ``mix_plan``'s tile height
  and chunk) and its route (K2, then a block per stage of
  ``ms_mix_apply_split``), K5 and K9b: every K1, K5 and K9b launch shape
  of ``chip_smoke.KERNEL_CASES``, ``HALO_CASES`` and the paths covers
  every output plane of every stage once at its own tile and chunk; the
  wrappers hand their entry points ``build.SIGNATURES``'s arguments in
  order (K1 the caller's coefficient table where it passes one, as the
  ``irk_batched`` scheme does, built once per tau); ``mix_tile`` picks the
  route exactly where no block holds the q rings, and ``march_smem_bytes``
  is the shared memory ptxas reported for a one-ring mode;
* the passes in runs (``march_runs``: K3, K3dg, K9c, K9d, K4, K9a, K5, K9b
  and the split march at p >= 3, K1 on the 16-row tile at p = 3): each
  mode's layout at p = 1-4 (``_mode_smem_bytes``, a mirror of csrc
  ``March<P, Mode>``; ChebInvd in runs with one plane of its fields; Mix
  with the rings of four stages) is the shared memory the card's launches
  reported, with the blocks per SM it allows (the modes of
  ``RUNS_BLOCKS`` in runs: those it plans for); their launches at Q3's
  191 and Q4's 255 levels cover every plane once in chunks of up to
  ``MARCH_RUNS_MAX_CHUNK``; K3's and K9c's, K4's and K9a's (``runs_chunk``
  at p >= 3) at the degree sweep's levels and on P18's slabs take the
  chunk of the card's sweep and cover every plane once, and the wrappers
  hand their entry points that chunk (at p <= 2 ``march_plan``'s); K1's
  form per path (Mix's tile, or the route at Q4), and every form
  ``mix_tile`` picks is held by a kernel case;
* K1's library call (``chip_smoke.ms_mix_conv``, one dense conv3d) is K1's
  function: at p = 1 in f64 it equals ``ms_mix_apply_ref``;
* K8 (the march's pair form): ``pair_tile`` picks 16 rows at p = 1 and 3
  and 8 at p = 2 and 4, the tallest tile that lets two blocks share an SM,
  else one; ``pair_smem_bytes`` is the shared memory the card's launches
  reported; every K8 launch shape of ``chip_smoke.PAIR_CASES`` and P10's
  covers every output plane of every stage once at its tile, and stage 1
  runs the chunk's planes and p more at each end; the wrapper hands
  ``spirk_cheb_pair_dg`` ``build.SIGNATURES``'s arguments in order.
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


# the lanes of a path's V-cycle launches: whole blocks (P1, P16, P17 four
# stages, P19 five, P2 one at a time, P4, P10 and P20 six pair lanes, P5
# three), or per slot of a mesh path with two space slots (P6, P7, P9 and
# P18 one lane, P8 two)
PATH_LANES = {"P1": 4, "P2": 1, "P4": 6, "P5": 3, "P10": 6, "P16": 4, "P17": 4,
              "P19": chip_smoke.P19_STAGES, "P20": 6}
MESH_LANES = {"P6": 1, "P7": 1, "P8": 2, "P9": 1, "P18": 1}


def _path_launches() -> dict:
    shapes = {}
    for name, (_dim, cfg, n_levels) in chip_smoke.PATHS.items():
        top = cfg["NRefinements"]
        for ref in range(top - n_levels + 1, top + 1):
            m = _m(ref, cfg["FEDegree"])
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


def _k1_launches() -> dict:
    """(q, m, p) of every K1 launch of the kernels phase and of P1."""
    shapes = {}
    for dim, q, ref, p, names, _timed in chip_smoke.KERNEL_CASES:
        if dim == 3 and "ms_mix_apply" in names:
            shapes[f"kernel q={q} r={ref} p={p}"] = (q, _m(ref, p), p)
    for name in ("P1", "P15", "P16", "P17", "P19"):
        _dim, cfg, _levels = chip_smoke.PATHS[name]
        p = cfg["FEDegree"]
        shapes[name] = (cfg["IRKStages"], _m(cfg["NRefinements"], p), p)
    return shapes


# the lanes of a path's K5 launch (the vmult, unsharded: P2 the q stages, P4,
# P5 and P10 the 2 n2 = 6 pair lanes) or of its K9b launch per slot of a
# mesh with two space slots (P6, P7 a stage, P8, P9 a pair)
K5_LANES = {"P2": 5, "P4": 6, "P5": 6, "P10": 6, "P20": 6}
K9B_LANES = {"P6": 1, "P7": 1, "P8": 2, "P9": 2, "P18": 1}


def _ms_launches() -> dict:
    """(q, nz, m, p) of every K5 and K9b launch of the kernels phase and the paths."""
    shapes = {}
    for dim, q, ref, p, names, _timed in chip_smoke.KERNEL_CASES:
        if dim == 3 and "mass_stiffness_apply" in names:
            shapes[f"K5 q={q} r={ref} p={p}"] = (q, _m(ref, p), _m(ref, p), p)
    for _q, ref, p, nsps, _timed in chip_smoke.HALO_CASES:
        m = _m(ref, p)
        for nsp in nsps:
            for z0, z1 in z_partition(m, nsp):
                shapes[f"K9b r={ref} p={p} {nsp} slabs, planes {z0}:{z1}"] = (1, z1 - z0, m, p)
    for name, (_dim, cfg, _levels) in chip_smoke.PATHS.items():
        p = cfg["FEDegree"]
        m = _m(cfg["NRefinements"], p)
        if name in K5_LANES:
            shapes[f"{name} K5"] = (K5_LANES[name], m, m, p)
        elif name in K9B_LANES:
            for z0, z1 in z_partition(m, 2):
                shapes[f"{name} K9b planes {z0}:{z1}"] = (K9B_LANES[name], z1 - z0, m, p)
    return shapes


K1_SHAPES = _k1_launches()
MS_SHAPES = _ms_launches()


def _covered(q, nz, m, ty, per_stage, max_chunk=st.MARCH_MAX_CHUNK):
    """Each (stage, plane) that the plan's blocks write, counted, and the
    grid's (y, x) tiles checked against [0, m)^2."""
    chunk, grid = st.march_plan(q, nz, m, ty, per_stage=per_stage, max_chunk=max_chunk)
    assert 1 <= chunk <= max_chunk
    tx = st.MARCH_TILE[1]
    assert (grid[0] - 1) * tx < m <= grid[0] * tx
    assert (grid[1] - 1) * ty < m <= grid[1] * ty
    seen = {}
    for bz in range(grid[2]):
        stage, z0, z1 = st.march_planes(nz, chunk, bz)
        stages = [stage] if per_stage else range(q)
        assert 0 <= stage < (q if per_stage else 1) and 0 <= z0 < z1 <= nz
        assert z1 - z0 <= chunk
        for i in stages:
            for z in range(z0, z1):
                seen[i, z] = seen.get((i, z), 0) + 1
    blocks = grid[0] * grid[1] * grid[2]
    lanes = q if per_stage else 1
    least = st.MARCH_MIN_BLOCKS if per_stage else st.MIX_MIN_BLOCKS
    if grid[0] * grid[1] * lanes * nz >= least:
        assert blocks >= least, (chunk, grid)
    if 2 * chunk <= max_chunk:  # the largest chunk that leaves them
        assert grid[0] * grid[1] * lanes * -(-nz // (2 * chunk)) < least
    return seen


def _runs_covered(mode, q, nz, m, p, lanes):
    """A launch of ``mode`` in runs (``runs_chunk``'s chunk): each (stage,
    plane) its blocks write, counted (Mix: ``lanes`` 1, a block for every
    stage), in chunks of up to MARCH_RUNS_MAX_CHUNK; the busiest SM holds
    the mode's resident blocks where one-plane chunks give it that many."""
    chunk = st.runs_chunk(mode, q, nz, m, p)
    assert chunk & (chunk - 1) == 0 and 1 <= chunk <= st.MARCH_RUNS_MAX_CHUNK[p]
    nch = -(-nz // chunk)
    seen = {}
    for bz in range(lanes * nch):
        stage, z0, z1 = st.march_planes(nz, chunk, bz)
        assert 0 <= stage < lanes and 0 <= z0 < z1 <= nz and z1 - z0 <= chunk
        for i in [stage] if lanes == q else range(q):
            for z in range(z0, z1):
                seen[i, z] = seen.get((i, z), 0) + 1
    tiles = -(-m // st.MARCH_TILE[1]) * -(-m // st.MARCH_TILE[0])
    resident = st.RUNS_BLOCKS[mode][p]
    if -(-tiles * lanes * nz // st.SMS) >= resident:
        assert -(-tiles * lanes * nch // st.SMS) >= resident
    return seen


@pytest.mark.parametrize("where", sorted(K1_SHAPES))
def test_k1_plan_covers_every_plane_once(where):
    """K1's launch: every stage's planes once, by blocks that each hold
    every stage (Mix), on ``mix_plan``'s tile and chunk (in runs, the
    16-row tile at p = 3, ``runs_chunk`` with one block for every stage);
    on the route, the split march's blocks one stage each on the 16-row
    tile."""
    q, m, p = K1_SHAPES[where]
    ty, chunk = st.mix_plan(q, m, p)
    if ty and st.march_runs("Mix", p, ty):
        assert chunk == st.runs_chunk("Mix", q, m, m, p)
        seen = _runs_covered("Mix", q, m, m, p, lanes=1)
    elif ty:
        assert chunk == st.march_plan(q, m, m, ty, per_stage=False)[0]
        seen = _covered(q, m, m, ty, per_stage=False)
    else:
        seen = _covered(q, m, m, st.MARCH_TILE[0], per_stage=True,
                        max_chunk=st.march_max_chunk("MixSplit", p))
    assert seen == {(i, z): 1 for i in range(q) for z in range(m)}


@pytest.mark.parametrize("where", sorted(MS_SHAPES))
def test_k5_plan_covers_every_plane_once(where):
    """K5's and K9b's launches (MassStiff): at p >= 3 in runs,
    ``runs_chunk``'s chunk (P20's vmult, P16's shape, P18's slabs), below
    ``march_plan``'s; every plane of every stage once."""
    q, nz, m, p = MS_SHAPES[where]
    if st.march_runs("MassStiff", p):
        seen = _runs_covered("MassStiff", q, nz, m, p, lanes=q)
    else:
        seen = _covered(q, nz, m, st.MARCH_TILE[0], per_stage=True)
    assert seen == {(i, z): 1 for i in range(q) for z in range(nz)}


def test_the_ms_and_k1_shapes_hold_the_degree_sweeps_launches():
    """The K5, K9b and K1 shapes above include P20's vmult, P18's two slabs
    and P16's finest level, with the chunks of the card's sweep."""
    assert MS_SHAPES["P20 K5"] == (6, 127, 127, 4)
    assert MS_SHAPES["P18 K9b planes 0:64"] == (1, 64, 127, 4)
    assert MS_SHAPES["P18 K9b planes 64:127"] == (1, 63, 127, 4)
    assert K1_SHAPES["P16"] == (4, 191, 3)
    assert st.runs_chunk("MassStiff", 6, 127, 127, 4) == 32
    assert st.runs_chunk("MassStiff", 1, 64, 127, 4) == 4
    assert st.mix_plan(4, 191, 3) == (16, 8)


def test_the_k1_cases_take_both_tiles_and_the_route():
    """The kernels phase holds K1 at both tile heights and on its route,
    and P1 takes the 16-row tile with two blocks per SM."""
    tiles = {st.mix_tile(q, p) for q, _m_, p in K1_SHAPES.values()}
    assert tiles == {16, 8, 0}
    q, m, p = K1_SHAPES["P1"]
    assert st.mix_tile(q, p) == 16
    assert 2 * (st.march_smem_bytes(p, 16, q) + 1024) <= st.SM_SMEM_BYTES
    assert st.march_plan(q, m, m, 16, per_stage=False) == (8, (2, 8, 16))


@pytest.mark.parametrize("p", [1, 2, 3, 4])
def test_mix_tile_routes_only_where_no_block_holds_the_rings(p):
    """Below p = 4, K1 takes the route exactly where no tile holds its q
    rings; at p = 4 wherever no tile lets two Mix blocks share an SM."""
    per_sm = 2 if p == 4 else 1
    for q in range(1, st.QMAX + 1):
        ty = st.mix_tile(q, p)
        fits = [t for t in (st.MIX_TILES if q <= 4 else st.MIX_TILES[1:])
                if per_sm * (st.march_smem_bytes(p, t, q) + 1024) <= st.SM_SMEM_BYTES]
        assert (ty == 0) == (not fits), (q, ty)
        if ty:
            assert st.march_smem_bytes(p, ty, q) <= st.BLOCK_SMEM_BYTES
    assert [q for q in range(1, 9) if not st.mix_tile(q, p)] == {
        1: [], 2: [], 3: [7, 8], 4: [3, 4, 5, 6, 7, 8]}[p]


# the z march's modes (csrc March<P, Mode>): (operand rings, per-point
# fields, 1D diagonals); Mix's rings are its launch's stages
MARCH_MODES = {
    "Apply": (1, 0, False),  # K4, K9a
    "ChebInvd": (1, 3, False),  # K3, K9c: r, x, D^-1
    "ChebDiag": (1, 2, True),  # K3dg, K9d: r, x
    "MassStiff": (1, 0, False),  # K5, K9b
    "MixSplit": (2, 0, False),  # K1's route: v, u
}
# Mix<16, 4> (K1 on the 16-row tile) as its residency counts it: the rings
# of four stages (csrc March::SM_FLOATS)
MIX_MODE = (4, 0, False)


def _mode_smem_bytes(p, mode):
    """csrc ``March<P, Mode>::SMEM_FLOATS`` x 4 on the 16-row tile: the
    rings, the z-pass planes E and F, the y-pass fields C and D, the
    per-point fields of two planes (ChebInvd in runs: one, csrc
    March::RX1), the z band rows of a chunk, the y band rows ([mass,
    stiff][row][k], k padded to 4, where ``march_runs``) and ChebDiag's 1D
    diagonals."""
    rings, fields, diag = MIX_MODE if mode == "Mix" else MARCH_MODES[mode]
    ty, tx = st.MARCH_TILE
    nb, hx, hy = 2 * p + 1, tx + 2 * p, ty + 2 * p
    zc = st.march_max_chunk(mode, p)
    runs = st.march_runs(mode, p)
    y_rows = 2 * ty * (-(-nb // 4) * 4) if runs else 2 * nb * ty
    planes = 1 if mode == "ChebInvd" and runs else 2
    floats = (rings * (2 * p + 2) * hy * hx + 2 * hy * hx + 2 * ty * hx
              + planes * fields * ty * tx + 2 * nb * zc + y_rows
              + (2 * zc + 2 * ty if diag else 0))
    return 4 * floats


def _blocks(nbytes):
    """csrc ``March::BLOCKS``: blocks per SM that a block of ``nbytes`` of
    shared memory allows (1 KB of the SM's reserved per block), at most 4."""
    return min(4, st.SM_SMEM_BYTES // (nbytes + 1024))


# the dynamic shared memory of K3's and K9c's (ChebInvd), K3dg's (ChebDiag),
# K4's and K9a's (Apply), K5's and K9b's (MassStiff) and the split march's
# (MixSplit) launches at p = 1-4, and of K1's four-stage launch on the
# 16-row tile at p = 3 (Mix), as the card's profiler trace recorded them
# (csrc March<P, Mode>::SMEM_FLOATS * 4, Mix with a ring per stage; PERF.md
# section 6): in runs (p >= 3; Mix at p = 3) the y band rows lie [mass,
# stiff][row][k], k padded to a multiple of 4, and the z band rows and
# diagonals are a chunk's of up to 32 (p = 3) or 64 (p = 4) planes; ChebInvd
# there holds one plane of its three fields, not two
MODE_SMEM = {("ChebInvd", 1): 62304, ("ChebInvd", 2): 78080, ("ChebInvd", 3): 85664,
             ("ChebInvd", 4): 110592,
             ("ChebDiag", 1): 54368, ("ChebDiag", 2): 70144, ("ChebDiag", 3): 90144,
             ("ChebDiag", 4): 115328, ("MixSplit", 1): 56736, ("MixSplit", 2): 86144,
             ("MixSplit", 3): 122656, ("MixSplit", 4): 167424,
             ("Apply", 1): 37728, ("Apply", 2): 53504, ("Apply", 3): 73376,
             ("Apply", 4): 98304, ("MassStiff", 1): 37728, ("MassStiff", 2): 53504,
             ("MassStiff", 3): 73376, ("MassStiff", 4): 98304, ("Mix", 3): 221216}
# and the blocks per SM that each allows (csrc March::BLOCKS; Mix per point,
# at p = 1, 2 and 4, is held to 2)
MODE_BLOCKS = {"ChebInvd": (3, 2, 2, 2), "ChebDiag": (4, 3, 2, 2), "MixSplit": (4, 2, 1, 1),
               "Apply": (4, 4, 3, 2), "MassStiff": (4, 4, 3, 2), "Mix": (2, 2, 1, 2)}
# the modes whose passes run in runs at p >= 3 (csrc March::RUNS; Mix only
# at p = 3, on the 16-row tile)
RUNS_MODES = ("ChebInvd", "ChebDiag", "MixSplit", "Apply", "MassStiff")


@pytest.mark.parametrize("mode, p", sorted(MODE_SMEM))
def test_march_mode_smem_is_the_kernels_layout(mode, p):
    nbytes = _mode_smem_bytes(p, mode)
    assert nbytes == MODE_SMEM[mode, p]
    assert nbytes <= st.BLOCK_SMEM_BYTES
    assert _blocks(nbytes) == MODE_BLOCKS[mode][p - 1]
    runs = (mode in RUNS_MODES and p >= 3) or (mode == "Mix" and p == 3)
    assert st.march_runs(mode, p) == runs
    assert st.march_max_chunk(mode, p) == ({3: 32, 4: 64}[p] if runs else st.MARCH_MAX_CHUNK)


@pytest.mark.parametrize("p", [1, 2, 3, 4])
def test_march_blocks_per_sm(p):
    """The blocks per SM that each mode's shared memory allows, at most 4:
    MassStiff's layout is ``march_smem_bytes``'s with one ring, in runs at
    p >= 3; the modes that ``runs_chunk`` plans for hold the blocks of
    RUNS_BLOCKS; Mix<16, 4> runs in runs only at p = 3, where its four
    stages' rings (``mix_tile``'s tile for q = 4) leave one block per SM."""
    for mode in MARCH_MODES:
        nbytes = _mode_smem_bytes(p, mode)
        blocks = _blocks(nbytes)
        assert 1 <= blocks <= 4
        assert blocks * (nbytes + 1024) <= st.SM_SMEM_BYTES
        assert blocks == 4 or (blocks + 1) * (nbytes + 1024) > st.SM_SMEM_BYTES
        assert st.march_runs(mode, p) == (mode in RUNS_MODES and p >= 3)
        if mode in st.RUNS_BLOCKS and st.march_runs(mode, p):
            assert blocks == st.RUNS_BLOCKS[mode][p]
    assert st.march_runs("MassStiff", p) == (p >= 3)
    assert st.march_runs("Mix", p) == (p == 3) and not st.march_runs("Mix", p, 8)
    assert _mode_smem_bytes(p, "MassStiff") == st.march_smem_bytes(p, st.MARCH_TILE[0], 1, p >= 3)
    assert st.RUNS_BLOCKS.keys() == {"ChebInvd", "Apply", "MassStiff", "Mix"}
    assert all(st.RUNS_BLOCKS[mode].keys() == ({3} if mode == "Mix" else {3, 4})
               for mode in st.RUNS_BLOCKS)
    mix = st.march_smem_bytes(p, st.MARCH_TILE[0], 4, st.march_runs("Mix", p))
    if p == 3:
        assert st.mix_tile(4, p) == 16 and mix == _mode_smem_bytes(p, "Mix")
        assert _blocks(mix) == st.RUNS_BLOCKS["Mix"][p] == MODE_BLOCKS["Mix"][p - 1] == 1


@pytest.mark.parametrize("q, m", [(1, 255), (4, 191), (4, 255), (5, 255), (6, 255), (8, 191)])
def test_plan_covers_the_degree_sweeps_levels(q, m):
    """K3dg's (and the split march's) launches at Q3's 191 and Q4's 255
    levels, in chunks of up to 32 and 64 planes: every plane of every stage
    once, at least two blocks per SM; the wrapper hands the kernel that
    chunk."""
    cap = st.MARCH_RUNS_MAX_CHUNK[3 if m == 191 else 4]
    seen = _covered(q, m, m, st.MARCH_TILE[0], per_stage=True, max_chunk=cap)
    assert seen == {(i, z): 1 for i in range(q) for z in range(m)}
    chunk, grid = st.march_plan(q, m, m, max_chunk=cap)
    assert chunk == (cap if q > 1 else 32) and grid[0] * grid[1] * grid[2] >= 2 * 132
    ops = level_ops(make_level(6, 3 if m == 191 else 4), torch.float32, "cpu")
    assert ops.m == m
    assert st._runs_plan(ops, q, m) == (chunk,)
    assert st._runs_plan(ops, q, m, "MixSplit") == (chunk,)


# K3's and K9c's launches at p >= 3 (ChebInvd in runs): (q, nz, m, p) and the
# chunk of the H100 sweep (PERF.md: the fastest, or within 1% of it) —
# P18's first slab (one stage, 64 of 127 planes), P20's 127 level (six
# lanes), P17's 127 level (q=4), P16's 95 level (q=4, p = 3); and at p = 1
# P1's finest level and P6's first slab, which keep ``march_plan``'s chunk
CHEB_INVD_SHAPES = {"P18 slab": (1, 64, 127, 4, 4), "P20 r=5": (6, 127, 127, 4, 32),
                    "P17 r=5": (4, 127, 127, 4, 32), "P16 r=5": (4, 95, 95, 3, 8),
                    "P1 r=7": (4, 127, 127, 1, 16), "P6 slab": (1, 64, 127, 1, 2)}
# K4's and K9a's launches (Apply), the same way: at p >= 3 the degree sweep's
# levels (P20's 127 level, P17's and P19's 255 levels, P16's 191 and 95
# levels) and both of P18's slabs (64 and 63 planes); at p = 1 and 2 P1's and
# P15's finest levels and P6's first slab
APPLY_SHAPES = {"P20 r=5": (6, 127, 127, 4, 32), "P17 r=6": (4, 255, 255, 4, 64),
                "P19 r=6": (5, 255, 255, 4, 64), "P16 r=6": (4, 191, 191, 3, 32),
                "P16 r=5": (4, 95, 95, 3, 8), "P18 slab": (1, 64, 127, 4, 4),
                "P18 slab 2": (1, 63, 127, 4, 4), "P1 r=7": (4, 127, 127, 1, 16),
                "P15 r=6": (4, 127, 127, 2, 16), "P6 slab": (1, 64, 127, 1, 2)}


def _runs_plan_holds(mode, q, nz, m, p, want):
    """The plan of a ``mode`` launch (``_runs_plan``): every plane of every
    stage once, the sweep's chunk ``want``; at p >= 3 ``runs_chunk``, a
    power of two up to MARCH_RUNS_MAX_CHUNK that gives every SM the mode's
    resident blocks (RUNS_BLOCKS), and no other such chunk gives the
    busiest SM less work; at p <= 2 ``march_plan``'s chunk."""
    ref = ((m + 1) // p).bit_length() - 1  # m = p 2^ref - 1
    ops = level_ops(make_level(ref, p), torch.float32, "cpu")
    assert ops.m == m
    sops = slab_ops(ops, 0, nz) if nz < m else ops
    (chunk,) = st._runs_plan(sops, q, nz, mode)
    assert chunk == want
    seen = _covered(q, nz, m, st.MARCH_TILE[0], per_stage=True, max_chunk=chunk)
    assert seen == {(i, z): 1 for i in range(q) for z in range(nz)}
    if p < 3:
        assert chunk == st.march_plan(q, nz, m)[0]
        return
    assert chunk == st.runs_chunk(mode, q, nz, m, p)
    cap = st.march_max_chunk(mode, p)
    assert chunk & (chunk - 1) == 0 and chunk <= cap
    tiles = -(-m // st.MARCH_TILE[1]) * -(-m // st.MARCH_TILE[0])
    resident = st.RUNS_BLOCKS[mode][p]

    def per_sm(c):  # the busiest SM's blocks
        return -(-tiles * q * -(-nz // c) // st.SMS)

    assert per_sm(chunk) >= resident
    for c in (2**k for k in range(8) if 2**k <= cap):
        if per_sm(c) >= resident:
            assert per_sm(c) * (c + 1) >= per_sm(chunk) * (chunk + 1), c


@pytest.mark.parametrize("where", sorted(CHEB_INVD_SHAPES))
def test_cheb_invd_plan_covers_every_plane_once(where):
    """K3's and K9c's plan (mode ChebInvd, two blocks per SM in runs)."""
    _runs_plan_holds("ChebInvd", *CHEB_INVD_SHAPES[where])


@pytest.mark.parametrize("where", sorted(APPLY_SHAPES))
def test_apply_plan_covers_every_plane_once(where):
    """K4's and K9a's plan (mode Apply: three blocks per SM in runs at p = 3,
    two at p = 4)."""
    _runs_plan_holds("Apply", *APPLY_SHAPES[where])


def _apply_launches() -> dict:
    """(q, nz, m, p) of every K4 and K9a launch at p >= 3 of the kernels
    phase (KERNEL_CASES, AMG_CASES, HALO_CASES: each slab of each space
    split) and of the paths' V-cycles."""
    shapes = {}
    for dim, q, ref, p, names, _timed in chip_smoke.KERNEL_CASES:
        if dim == 3 and p >= 3 and "stencil_apply" in names:
            shapes[f"kernel q={q} r={ref} p={p}"] = (q, _m(ref, p), _m(ref, p), p)
    for q, p, _ref, m in chip_smoke.AMG_CASES:
        if p >= 3:
            shapes[f"amg q={q} m={m} p={p}"] = (q, m, m, p)
    for _q, ref, p, nsps, _timed in chip_smoke.HALO_CASES:
        m = _m(ref, p)
        for nsp in nsps:
            for z0, z1 in z_partition(m, nsp):
                if p >= 3:
                    shapes[f"halo r={ref} p={p} {nsp} slabs, planes {z0}:{z1}"] = (1, z1 - z0, m, p)
    for name, (_dim, cfg, n_levels) in chip_smoke.PATHS.items():
        top, p = cfg["NRefinements"], cfg["FEDegree"]
        for ref in range(top - n_levels + 1, top + 1):
            m = _m(ref, p)
            if p >= 3 and name in PATH_LANES:
                shapes[f"{name} r={ref}"] = (PATH_LANES[name], m, m, p)
            elif p >= 3 and name in MESH_LANES:
                for z0, z1 in z_partition(m, 2):
                    shapes[f"{name} r={ref} planes {z0}:{z1}"] = (MESH_LANES[name], z1 - z0, m, p)
    return shapes


APPLY_LAUNCHES = _apply_launches()


@pytest.mark.parametrize("where", sorted(APPLY_LAUNCHES))
def test_apply_runs_launches_cover_every_plane_once(where):
    """Every K4 and K9a launch at p >= 3 (Apply in runs, ``runs_chunk``)
    writes every plane of every stage once, in chunks of up to
    MARCH_RUNS_MAX_CHUNK, and gives the busiest SM the mode's resident
    blocks where one-plane chunks do."""
    q, nz, m, p = APPLY_LAUNCHES[where]
    chunk = st.runs_chunk("Apply", q, nz, m, p)
    assert 1 <= chunk <= st.MARCH_RUNS_MAX_CHUNK[p]
    seen = _covered(q, nz, m, st.MARCH_TILE[0], per_stage=True, max_chunk=chunk)
    assert seen == {(i, z): 1 for i in range(q) for z in range(nz)}
    tiles = -(-m // st.MARCH_TILE[1]) * -(-m // st.MARCH_TILE[0])
    resident = st.RUNS_BLOCKS["Apply"][p]
    if -(-tiles * q * nz // st.SMS) >= resident:
        assert -(-tiles * q * -(-nz // chunk) // st.SMS) >= resident


def test_cheb_invd_launch_arguments_in_runs(monkeypatch):
    """At p = 4 K3 and K9c hand their entry points ``_runs_plan``'s chunk
    (mode ChebInvd), not ``march_plan``'s default."""
    q = 1
    ops = level_ops(make_level(5, 4), torch.float32, "cpu")
    m = ops.m
    sops = slab_ops(ops, 0, 64)
    a, c1, c2 = (torch.linspace(lo, lo + 1, q) for lo in (1.0, 0.2, 0.1))
    calls = _capture(monkeypatch)
    st.cheb_iter(ops, a, 0.1, c1, c2, *(torch.zeros(q, m, m, m) for _ in range(4)))
    d_h = torch.zeros(q, 64 + 8, m, m)
    st.cheb_iter_halo(sops, a, 0.1, c1, c2, d_h, *(torch.zeros(q, 64, m, m) for _ in range(3)))
    (n1, a1), (n2, a2) = calls
    assert (n1, n2) == ("spirk_cheb_iter", "spirk_cheb_iter_halo")
    assert a1[-2:] == (st._runs_plan(ops, q, m, "ChebInvd")[0], 4)
    assert a2[-4:] == (64, 0, st._runs_plan(sops, q, 64, "ChebInvd")[0], 4)
    assert a2[-2] != st.march_plan(q, 64, m)[0]


@pytest.mark.parametrize("p", [1, 2, 3, 4])
def test_apply_launch_arguments_in_runs(monkeypatch, p):
    """K4 and K9a hand their entry points ``runs_chunk``'s chunk (mode
    Apply) at p >= 3, and ``march_plan``'s at p <= 2; on P18's first slab
    at p = 4 (64 of 127 planes) that is 4 planes, not ``march_plan``'s 2."""
    q = 1
    ops = level_ops(make_level(5, p), torch.float32, "cpu")
    m = ops.m
    nzl = z_partition(m, 2)[0][1]
    sops = slab_ops(ops, 0, nzl)
    a = torch.linspace(1.0, 2.0, q)
    calls = _capture(monkeypatch)
    st.stencil_apply(ops, a, 0.1, torch.zeros(q, m, m, m))
    st.stencil_apply_halo(sops, a, 0.1, torch.zeros(q, nzl + 2 * p, m, m))
    (n1, a1), (n2, a2) = calls
    assert (n1, n2) == ("spirk_stencil_apply", "spirk_stencil_apply_halo")
    for name, args in calls:
        assert len(args) == len(build.SIGNATURES[name]) - 1
    if p >= 3:
        want = st.runs_chunk("Apply", q, m, m, p), st.runs_chunk("Apply", q, nzl, m, p)
    else:
        want = st.march_plan(q, m, m)[0], st.march_plan(q, nzl, m)[0]
    assert a1[-4:] == (q, m, want[0], p)
    assert a2[-6:] == (q, m, nzl, 0, want[1], p)
    if p == 4:
        assert (nzl, want[1], st.march_plan(q, nzl, m)[0]) == (64, 4, 2)


# the profiler's names of the march's kernels (csrc march<P, Mode, ARM>, the
# diagnostic arm ARM 0 on every path), per LAUNCHES key
MARCH_KERNELS = {
    "stencil_apply": "Apply", "stencil_apply_halo": "Apply", "cheb_iter": "ChebInvd",
    "cheb_iter_halo": "ChebInvd", "cheb_iter_dg": "ChebDiag", "cheb_iter_dg_halo": "ChebDiag",
    "mass_stiffness_apply": "MassStiff", "mass_stiffness_apply_halo": "MassStiff",
    "ms_mix_apply": "Mix<8, 4>", "ms_mix_apply_split": "MixSplit",
}


@pytest.mark.parametrize("key", sorted(MARCH_KERNELS))
def test_device_names_find_the_march_kernels(key):
    """``chip_smoke.DEVICE_NAMES`` selects each march kernel by the name the
    profiler records for it, and no other mode's."""
    def name(mode, p=4):
        return f"void spirk::march<{p}, spirk::{mode}, 0>(spirk::MarchArgs)"

    marker = chip_smoke.DEVICE_NAMES[key]
    assert any(mk in name(MARCH_KERNELS[key]) for mk in marker)
    others = {mode for k, mode in MARCH_KERNELS.items() if mode != MARCH_KERNELS[key]}
    assert not any(mk in name(mode) for mode in others for mk in marker)


# K1's form per path: Mix's tile height, or 0 for the route K2 + split march
K1_FORMS = {"P1": 16, "P15": 8, "P16": 16, "P17": 0, "P19": 0, "P21": 0}


@pytest.mark.parametrize("name", sorted(K1_FORMS))
def test_k1_form_per_path(name):
    cfg = chip_smoke.PATHS[name][1]
    assert st.mix_tile(cfg["IRKStages"], cfg["FEDegree"]) == K1_FORMS[name]


@pytest.mark.parametrize("p", [1, 2, 3, 4])
def test_every_k1_form_is_held_by_a_kernel_case(p):
    """Each form K1 takes at degree ``p`` for some q <= QMAX (Mix's tile
    height, or 0 for the route) is held against its plain version by a 3D
    case of ``chip_smoke.KERNEL_CASES``."""
    live = {st.mix_tile(q, p) for q in range(1, st.QMAX + 1)}
    held = {st.mix_tile(q, pc) for dim, q, _ref, pc, names, _timed in chip_smoke.KERNEL_CASES
            if dim == 3 and pc == p and "ms_mix_apply" in names}
    assert live <= held, sorted(live - held)


# the dynamic shared memory of a one-ring march outside runs at p = 1-4 as
# ptxas reported it on the H100 (March<P, MassStiff>::SMEM_FLOATS * 4 per
# point, and Apply's at p = 1-2; PERF.md section 6): the layout
# ``march_smem_bytes`` gives ``mix_tile`` outside runs
PER_POINT_SMEM = {1: 37728, 2: 53504, 3: 72352, 4: 94464}


@pytest.mark.parametrize("p", sorted(PER_POINT_SMEM))
def test_march_smem_bytes_is_the_kernels_layout(p):
    """One ring per point, and in runs at p >= 3 MassStiff's layout there
    (and Apply's)."""
    assert st.march_smem_bytes(p, st.MARCH_TILE[0], 1) == PER_POINT_SMEM[p]
    runs = st.march_runs("MassStiff", p)
    assert st.march_smem_bytes(p, st.MARCH_TILE[0], 1, runs) == MODE_SMEM["MassStiff", p]
    assert MODE_SMEM["MassStiff", p] == MODE_SMEM["Apply", p]


def _k_args(monkeypatch, fn, *args):
    calls = _capture(monkeypatch)
    fn(*args)
    return calls


@pytest.mark.parametrize("halo", [False, True])
@pytest.mark.parametrize("p", [1, 3, 4])
def test_k5_launch_arguments(monkeypatch, halo, p):
    """K5 and K9b: u, M u, K u, the band tables, q, m, [nzl, z_off,] the
    plan's chunk (at p >= 3 ``runs_chunk``'s, mode MassStiff; below
    ``march_plan``'s), p."""
    q, ref, z0, nzl = 3, 4, 5, 6
    ops = level_ops(make_level(ref, p), torch.float32, "cpu")
    m = ops.m
    sops = slab_ops(ops, z0, nzl) if halo else ops
    nz = nzl if halo else m
    u = torch.zeros(q, nz + 2 * halo * p, m, m)
    name = "spirk_mass_stiffness_apply" + ("_halo" if halo else "")
    fn = st.mass_stiffness_apply_halo if halo else st.mass_stiffness_apply
    ((called, args),) = _k_args(monkeypatch, fn, sops, u)
    assert called == name
    sig = build.SIGNATURES[name][:-1]
    assert len(args) == len(sig) and all(isinstance(a, int) for a in args)
    assert args[0] == u.data_ptr()
    assert args[3:5] == (sops.mass_band.data_ptr(), sops.stiff_band.data_ptr())
    slab = (nzl, z0) if halo else ()
    chunk = st.runs_chunk("MassStiff", q, nz, m, p) if p >= 3 else st.march_plan(q, nz, m)[0]
    assert args[5:] == (q, m, *slab, chunk, p)
    assert (chunk, st.march_max_chunk("MassStiff", p)) == {
        1: (st.march_plan(q, nz, m)[0], 16), 3: (chunk, 32), 4: (chunk, 64)}[p]


@pytest.mark.parametrize("q, p", [(4, 1), (8, 1), (2, 4), (3, 4), (4, 4), (8, 4), (4, 3),
                                  (2, 3)])
def test_k1_launch_arguments(monkeypatch, q, p):
    """K1: u, out, the band tables, the (q + 1, q) table [A^-1; tau], q, m,
    the tile height, the chunk of a block for every stage (``mix_plan``:
    at p = 3 on the 16-row tile ``runs_chunk``'s), p; on the route (no tile
    holds the q rings) K2's v = A^-1 u, then the split march: v, u, out,
    the band tables, tau by value, q, m, the chunk, p."""
    ops = level_ops(make_level(2, p), torch.float32, "cpu")
    m = ops.m
    u = torch.zeros(q, m, m, m)
    ainv = torch.linspace(-1.0, 1.0, q * q).reshape(q, q)
    calls = _k_args(monkeypatch, st.ms_mix_apply, ops, ainv, 0.25, u)
    ty = st.mix_tile(q, p)
    if ty:
        ((called, args),) = calls
        assert called == "spirk_ms_mix_apply"
    else:
        (k2, k2_args), (called, args) = calls
        assert (k2, called) == ("spirk_stage_mix", "spirk_ms_mix_apply_split")
        assert len(k2_args) == len(build.SIGNATURES[k2]) - 1
        assert k2_args[0] == u.data_ptr() and k2_args[3:] == (q, q, u[0].numel())
    sig = build.SIGNATURES[called][:-1]
    assert len(args) == len(sig)
    for arg, kind in zip(args, sig):
        assert isinstance(arg, float if kind is build._F else int)
    if ty:
        assert args[0] == u.data_ptr()
        assert args[2:4] == (ops.mass_band.data_ptr(), ops.stiff_band.data_ptr())
        if st.march_runs("Mix", p, ty):
            chunk = st.runs_chunk("Mix", q, m, m, p)
        else:
            chunk, _grid = st.march_plan(q, m, m, ty, per_stage=False)
        assert args[5:] == (q, m, ty, chunk, p) and (ty, chunk) == st.mix_plan(q, m, p)
        # the caller's coefficient table, where it hands one, goes as it is
        mw = st.mix_table(ainv, 0.25)
        ((_k1, with_mw),) = _k_args(monkeypatch, st.ms_mix_apply, ops, ainv, 0.25, u, mw)
        assert with_mw[4] == mw.data_ptr()
        assert (with_mw[0], *with_mw[2:4], *with_mw[5:]) == (args[0], *args[2:4], *args[5:])
    else:
        assert args[0] == k2_args[1] and args[1] == u.data_ptr()
        assert args[3:6] == (ops.mass_band.data_ptr(), ops.stiff_band.data_ptr(), 0.25)
        chunk = st.march_plan(q, m, m, max_chunk=st.march_max_chunk("MixSplit", p))[0]
        assert args[6:] == (q, m, chunk, p)


@pytest.mark.parametrize("q", [2, 4])
def test_k1_table_is_built_once_per_tau(q):
    """K1's coefficient table: ``mix_table`` is the (q + 1, q) f32 table the
    wrapper builds without one (rows A^-1, then tau per stage); the
    ``irk_batched`` scheme holds it, builds it once per tau and anew for a
    new tau, and its vmult hands it to every K1 launch."""
    from dealii_spirk_tpu_torch.config import Parameters
    from dealii_spirk_tpu_torch.problem import HeatProblem
    from dealii_spirk_tpu_torch.schemes import make_scheme

    params = Parameters.from_dict({
        "FEDegree": 1, "NRefinements": 2, "TimeIntegrationScheme": "irk_batched",
        "IRKStages": q, "TimeStepSize": 0.1, "EndTime": 0.1, "OperatorType": "MatrixFree",
        "BlockPreconditionerType": "GMG", "InnerTolerance": 0.0, "OuterTolerance": 1e-8,
        "Precision": "f32", "DoOutputParaview": False}, dim=3)
    scheme = make_scheme(HeatProblem(params, device="cpu"), params, kernels=True)
    ainv = scheme.A_inv
    today = torch.cat([ainv.to(torch.float32), torch.full((1, q), 0.1, dtype=torch.float32)])
    table = scheme.k1_table(0.1)
    assert table.dtype == torch.float32 and table.is_contiguous() and table.shape == (q + 1, q)
    assert torch.equal(table, today) and torch.equal(st.mix_table(ainv, 0.1), today)
    assert scheme.k1_table(0.1) is table
    other = scheme.k1_table(0.05)
    assert other is not table and torch.equal(other[:q], table[:q])
    assert torch.equal(other[q], torch.full((q,), 0.05, dtype=torch.float32))
    assert scheme.k1_table(0.05) is other


@pytest.mark.parametrize("q", [1, 4, 5])
def test_k1_library_conv_is_k1(q):
    """``chip_smoke.ms_mix_conv``: one dense conv3d with q input and q
    output channels, weight[i, j] = A^-1[i, j] M3 + delta_ij tau K3, equals
    ``ms_mix_apply_ref`` at p = 1 in f64."""
    import numpy as np

    ops = level_ops(make_level(3, 1), torch.float64, "cpu")
    rng = np.random.default_rng(q)
    u = torch.as_tensor(rng.uniform(-1, 1, (q,) + (ops.m,) * 3))
    ainv = torch.as_tensor(rng.uniform(-2, 2, (q, q)))
    want = st.ms_mix_apply_ref(ops, ainv, 0.1, u)
    got = chip_smoke.ms_mix_conv(ops, ainv, 0.1)(u)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-13 * float(want.abs().max())


# K8's tile height per degree, and the dynamic shared memory of those
# launches as the card reported it (torch.profiler's "shared memory" of
# pair_march, NVIDIA H100 80GB HBM3, PERF.md section 6)
PAIR_TILES = {1: 16, 2: 8, 3: 16, 4: 8}
PAIR_SMEM = {1: 86352, 2: 82432, 3: 186832, 4: 177664}


@pytest.mark.parametrize("p", sorted(PAIR_TILES))
def test_pair_tile_per_degree(p):
    ty = st.pair_tile(p)
    assert ty == PAIR_TILES[p]
    nbytes = st.pair_smem_bytes(p, ty)
    assert nbytes <= st.BLOCK_SMEM_BYTES
    two = [t for t in st.MIX_TILES
           if 2 * (st.pair_smem_bytes(p, t) + 1024) <= st.SM_SMEM_BYTES]
    # the tallest tile with two blocks per SM, else the tallest of one
    assert ty == (two[0] if two else max(
        t for t in st.MIX_TILES if st.pair_smem_bytes(p, t) <= st.BLOCK_SMEM_BYTES))


@pytest.mark.parametrize("p", sorted(PAIR_SMEM))
def test_pair_smem_bytes_is_the_kernels_layout(p):
    assert st.pair_smem_bytes(p, PAIR_TILES[p]) == PAIR_SMEM[p]


def _pair_launches() -> dict:
    """(q, m, p) of every K8 launch of the kernels phase and of P10."""
    shapes = {f"pair q={q} r={ref} p={p}": (q, _m(ref, p), p)
              for q, ref, p, _timed in chip_smoke.PAIR_CASES}
    shapes["P10"] = (PATH_LANES["P10"], _m(chip_smoke.PATHS["P10"][1]["NRefinements"], 1), 1)
    return shapes


PAIR_SHAPES = _pair_launches()


@pytest.mark.parametrize("where", sorted(PAIR_SHAPES))
def test_pair_plan_covers_every_plane_once(where):
    """Stage 2 writes every (stage, plane) once; stage 1 runs the block's
    planes and p more on each side (steps = planes + 2p), on the grown tile."""
    q, m, p = PAIR_SHAPES[where]
    ty = st.pair_tile(p)
    chunk, grid = st.march_plan(q, m, m, ty, max_chunk=st.PAIR_MAX_CHUNK)
    assert 1 <= chunk <= st.PAIR_MAX_CHUNK
    assert (grid[0] - 1) * st.MARCH_TILE[1] < m <= grid[0] * st.MARCH_TILE[1]
    assert (grid[1] - 1) * ty < m <= grid[1] * ty
    seen, stage1 = {}, 0
    for bz in range(grid[2]):
        stage, z0, z1 = st.march_planes(m, chunk, bz)
        assert 0 <= stage < q and 0 <= z0 < z1 <= m and z1 - z0 <= chunk
        for z in range(z0, z1):
            seen[stage, z] = seen.get((stage, z), 0) + 1
        stage1 += (z1 - z0) + 2 * p
    assert seen == {(i, z): 1 for i in range(q) for z in range(m)}
    assert stage1 == q * (m + 2 * p * -(-m // chunk))
    if grid[0] * grid[1] * q * m >= st.MARCH_MIN_BLOCKS:
        assert grid[0] * grid[1] * grid[2] >= st.MARCH_MIN_BLOCKS
    if where == "P10":
        assert (chunk, grid) == (32, (4, 16, 6 * 8))


@pytest.mark.parametrize("p", sorted(PAIR_TILES))
def test_k8_launch_arguments(monkeypatch, p):
    """K8: d, r, x, the 1D diagonals, r'', d'', x'', the band tables, a as a
    (q,) table, b by value, c1a, c2a, c1b, c2b as (q,) tables (as they are:
    no copy), q, m, the tile height, the plan's chunk, p."""
    q = 3
    ops = level_ops(make_level(2, p), torch.float32, "cpu")
    m = ops.m
    d, r, x = (torch.zeros(q, m, m, m) for _ in range(3))
    a, c1a, c2a, c1b, c2b = (torch.linspace(lo, lo + 1, q) for lo in (1.0, 0.2, 0.1, 0.3, 0.4))
    ((called, args),) = _k_args(monkeypatch, st.cheb_pair_dg, ops, a, 0.1, c1a, c2a, c1b, c2b,
                                d, r, x)
    assert called == "spirk_cheb_pair_dg"
    sig = build.SIGNATURES[called][:-1]
    assert len(args) == len(sig)
    for arg, kind in zip(args, sig):
        assert isinstance(arg, float if kind is build._F else int)
    assert args[:3] == (d.data_ptr(), r.data_ptr(), x.data_ptr())
    assert args[3:5] == (ops.mass_diag.data_ptr(), ops.stiff_diag.data_ptr())
    assert args[8:12] == (ops.mass_band.data_ptr(), ops.stiff_band.data_ptr(), a.data_ptr(), 0.1)
    assert args[12:16] == tuple(t.data_ptr() for t in (c1a, c2a, c1b, c2b))
    ty = st.pair_tile(p)
    chunk = st.march_plan(q, m, m, ty, max_chunk=st.PAIR_MAX_CHUNK)[0]
    assert args[16:] == (q, m, ty, chunk, p)
