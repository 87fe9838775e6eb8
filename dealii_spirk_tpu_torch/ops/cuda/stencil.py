"""The port's hand-written Hopper kernels, with their plain torch
versions and launch counters.

Each public wrapper dispatches on where its tensors lie: on the CPU it
runs the plain version (``*_ref``, which the CPU tests hold against the
JAX package); on a CUDA device it checks dtype (f32), shape and
contiguity, allocates its outputs with ``torch.empty``, launches the CUDA
kernel (``csrc/``, built by ``build.py``) on the current stream, raises if
the launch is refused, and adds one to its count in ``LAUNCHES``.  There
is no fallback from the kernel to the plain version.

Fields are compact stage blocks ``(q, m, m, m)`` (3D) or ``(q, m, m)``
(2D), x fastest — the JAX package's canonical padding (y to 8, x to 128)
is a TPU tiling and is not needed here: the kernels mask the ragged edge
instead.

All are bound by device memory at p=1 on the H100 (3.35 TB/s against
67 TFLOP/s f32): each moves 2 to 7 field passes of 4 bytes per point
against under 100 flops per point.  Each keeps every 1D intermediate in
shared memory or registers so that it reads each input about once from
DRAM (halo re-reads come mostly from L2) and writes each output once.  The
3D kernels (K1, K3, K3dg, K4, K5, K8 and the slab forms) are one z march
(``csrc/march.cuh``): a block marches over a chunk of z planes of one
stage's (y, x) tile (K1: of every stage's), ``march_plan`` (``runs_chunk``
for the modes whose passes run in runs) picks the chunk per launch,
``mix_plan`` K1's tile height and chunk and ``pair_tile`` K8's.

Wrappers and their ``LAUNCHES`` keys (one per CUDA entry point; a 2D
block counts under ``<key>_2d``), with the Pallas kernels they replace
(``dealii_spirk_tpu/ops/pallas/stencil.py``):

* K1 ``ms_mix_apply`` — ``fused_ms_mix_apply_canon``: the 3D
  ``irk_batched`` outer vmult in one pass; where its q rings fit no block,
  K2 and ``ms_mix_apply_split`` (out_i = M v_i + tau K u_i, v = Ainv u);
* K2 ``stage_mix`` — ``stage_mix_canon``: the T / T^-1 basis changes and
  the A^-1 mix of K5's ``M u``;
* K3 ``cheb_iter`` — ``fused_cheb_iter_canon``: one 3D Chebyshev step;
* K3dg ``cheb_iter_dg`` — ``fused_cheb_iter_canon`` with ``diag_tables``
  (``_fused_cheb_canon_dg``): K3 with the Jacobi diagonal rebuilt per
  point from the level's 1D diagonals, so no D^-1 field is read;
* K8 ``cheb_pair_dg`` — ``fused_cheb_pair_canon``: two K3dg steps in one
  pass (the march's pair form: stage 1 on the tile grown by p, stage 2 p
  planes behind it on the tile), 6 field passes for two steps; the
  unsharded V-cycle takes it only when asked (``cheb_pair``), as the JAX
  package's ``SPIRK_CHEB_PAIR`` switch does;
* K4 ``stencil_apply`` — ``fused_stencil_apply_canon``: (a_i M + b K) u_i,
  3D and 2D (``_make_kernel_2d``);
* K5 ``mass_stiffness_apply`` — ``fused_mass_stiffness_apply_canon`` and
  its compact-layout twin ``fused_mass_stiffness_apply``: (M u_i, K u_i)
  from one read, 3D and 2D (``_make_kernel_ms_2d``); the outer vmult of
  ``irk`` and of 2D ``irk_batched``;
* K9a-K9d ``stencil_apply_halo``, ``mass_stiffness_apply_halo``,
  ``cheb_iter_halo``, ``cheb_iter_dg_halo`` — K4, K5, K3 and K3dg on one z
  slab of a block that a (stage, space) mesh splits over z: the operand
  carries p planes of each z neighbour (``ops/cuda/sharded.py`` exchanges
  them), the outputs are the slab's own planes, and ``ops`` is the slab's
  (``mass_laplace.slab_ops``: its first global plane ``z_off``).  They
  replace ``dealii_spirk_tpu/ops/pallas/sharded.py``'s ``halo_z=True``
  forms and equal the whole-field kernels bit for bit.

K10's grid transfers (``transfer_restrict``, ``transfer_prolong``) count
here too; their wrappers are in ``transfer.py`` (no TPU kernel: the JAX
package's transfers are XLA's dense dot).
"""

from __future__ import annotations

import functools

import torch

from ..mass_laplace import (
    LevelOps,
    apply_mass,
    apply_mass_stiffness_batched,
    apply_shifted_batched,
    apply_stiffness,
    per_stage,
)

QMAX = 8  # most stages the stage-coupled kernels hold (csrc/common.cuh)
# The z march (csrc/march.cuh: K1, K3, K3dg, K4, K5 and the slab forms
# K9a-K9d): the (y, x) output tile of a block, the most planes one block
# marches (csrc MZC; at P4's shape chunks of 16 planes ran faster than
# chunks of 32 or 64 on the H100, PERF.md), and the blocks a launch should
# have at least: two per SM of the H100 (132 SMs)
MARCH_TILE = (16, 64)
MARCH_MAX_CHUNK = 16
# the most planes a block of K3, K3dg, K9c, K9d, K4, K9a, K5, K9b or the
# split march marches at p = 3 and 4, and of K1 on the 16-row tile at p = 3
# (csrc March::ZC, ``march_runs``): a chunk reads the
# 2p-plane z halo once, so chunks of 32 took K3dg at P17's shape from 1.0203 to 0.9647 ms on
# the H100 and chunks of 64 from 0.9210 to 0.8996 ms; at P16's (p = 3, m =
# 191) chunks of 64 leave 432 blocks, 1.6 waves of two per SM, and took
# 0.3605 against 0.3274 with 32 (PERF.md)
MARCH_RUNS_MAX_CHUNK = {3: 32, 4: 64}
SMS = 132  # the H100's streaming multiprocessors
MARCH_MIN_BLOCKS = 2 * SMS
# the blocks that one SM holds of the modes in runs whose launches plan
# their chunks by the busiest SM's work (``runs_chunk``), per degree: csrc
# March<P, Mode>::BLOCKS — ChebInvd (K3, K9c) 85,664 / 110,592 B of shared
# memory at p = 3 / 4, Apply (K4, K9a) and MassStiff (K5, K9b) 73,376 /
# 98,304 B, Mix (K1 on the 16-row tile, p = 3) 221,216 B with four rings
RUNS_BLOCKS = {"ChebInvd": {3: 2, 4: 2}, "Apply": {3: 3, 4: 2}, "MassStiff": {3: 3, 4: 2},
               "Mix": {3: 1}}
# K8's blocks run stage 1 on 2p more planes per chunk: at P4's 255 level
# chunks of 32 planes ran 3% faster than chunks of 16 on the H100 (csrc
# PAIR_MZC, PERF.md)
PAIR_MAX_CHUNK = 32
# K1's blocks each march every stage, so one per SM suffices: at P1's shape
# chunks of 8 planes (256 blocks) ran 7% faster than chunks of 4 (512) on
# the H100 (PERF.md)
MIX_MIN_BLOCKS = 132
# K1's tile heights (csrc Mix<TY>), tallest first, and the H100's shared
# memory: the most one block may take, and an SM's (1 KB of it reserved per
# block)
MIX_TILES = (16, 8)
BLOCK_SMEM_BYTES = 232448
SM_SMEM_BYTES = 233472

# one count per CUDA entry point (csrc/, build.SIGNATURES without "spirk_")
LAUNCHES = {
    "ms_mix_apply": 0,
    "ms_mix_apply_split": 0,
    "stage_mix": 0,
    "cheb_iter": 0,
    "cheb_iter_dg": 0,
    "cheb_pair_dg": 0,
    "stencil_apply": 0,
    "stencil_apply_2d": 0,
    "mass_stiffness_apply": 0,
    "mass_stiffness_apply_2d": 0,
    "stencil_apply_halo": 0,
    "mass_stiffness_apply_halo": 0,
    "cheb_iter_halo": 0,
    "cheb_iter_dg_halo": 0,
    "transfer_restrict": 0,
    "transfer_prolong": 0,
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain torch versions
# ---------------------------------------------------------------------------


def stencil_apply_ref(ops: LevelOps, a, b, u: torch.Tensor) -> torch.Tensor:
    """(a_i M + b K) u_i per stage (by the level's route, ``mass_laplace``)."""
    return apply_shifted_batched(ops, a, b, u, u.ndim - 1)


def mass_stiffness_apply_ref(ops: LevelOps, u: torch.Tensor):
    """(M u_i, K u_i) per stage."""
    return apply_mass_stiffness_batched(ops, u, u.ndim - 1)


def cheb_chain(apply, jacobi, c1, c2, d, r, x):
    """One Chebyshev step as an apply and an elementwise chain:
    r' = r - apply(d); d' = c1_i d + c2_i jacobi(r'); x' = x + d'."""
    r_new = r - apply(d)
    d_new = per_stage(c1, d) * d + per_stage(c2, d) * jacobi(r_new)
    return r_new, d_new, x + d_new


def cheb_iter_ref(ops: LevelOps, a, b, c1, c2, d, r, x, invd):
    """r' = r - (a_i M + b K) d; d' = c1_i d + c2_i invd r'; x' = x + d'."""
    return cheb_chain(
        lambda u: stencil_apply_ref(ops, a, b, u), lambda t: invd * t, c1, c2, d, r, x
    )


def cheb_diag(ops: LevelOps, a, b, like: torch.Tensor) -> torch.Tensor:
    """The (q, m, m, m) Jacobi diagonal of a_i M + b K from the level's 1D
    diagonals, in the JAX package's order (``_dg_z``):
    (a zm ym + b (zk ym + zm yk)) xm + (b zm ym) xk; ``like`` (a stage
    block) gives the stage count and, for a slab's ``ops``, the z rows
    (``z_off .. z_off + like.shape[1]``)."""
    dm, dk = ops.mass_diag, ops.stiff_diag
    rows = slice(ops.z_off, ops.z_off + like.shape[1])
    zm, zk = dm[rows, None, None], dk[rows, None, None]
    ym, yk = dm[None, :, None], dk[None, :, None]
    zmym = zm * ym
    aq = per_stage(a, like)
    return (aq * zmym + b * (zk * ym + zm * yk)) * dm + (b * zmym) * dk


def cheb_iter_dg_ref(ops: LevelOps, a, b, c1, c2, d, r, x):
    """K3's step with D^-1 r' computed as r' / diag (``cheb_diag``)."""
    diag = cheb_diag(ops, a, b, d)
    return cheb_chain(
        lambda u: stencil_apply_ref(ops, a, b, u), lambda t: t / diag, c1, c2, d, r, x
    )


def cheb_pair_dg_ref(ops: LevelOps, a, b, c1a, c2a, c1b, c2b, d, r, x):
    """Two chained K3dg steps, coefficients (c1a, c2a) then (c1b, c2b):
    what K8 computes in one pass."""
    r, d, x = cheb_iter_dg_ref(ops, a, b, c1a, c2a, d, r, x)
    return cheb_iter_dg_ref(ops, a, b, c1b, c2b, d, r, x)


def _interior(ops: LevelOps, t: torch.Tensor) -> torch.Tensor:
    return t[:, ops.p : t.shape[1] - ops.p]


def stencil_apply_halo_ref(ops: LevelOps, a, b, u_h: torch.Tensor) -> torch.Tensor:
    """``stencil_apply_ref`` on a haloed slab (q, nzl + 2p, m, m) with the
    slab's band rows along z, the slab's own planes kept."""
    return _interior(ops, stencil_apply_ref(ops, a, b, u_h)).contiguous()


def mass_stiffness_apply_halo_ref(ops: LevelOps, u_h: torch.Tensor):
    mu, ku = mass_stiffness_apply_ref(ops, u_h)
    return _interior(ops, mu).contiguous(), _interior(ops, ku).contiguous()


def cheb_iter_halo_ref(ops: LevelOps, a, b, c1, c2, d_h, r, x, invd):
    """``cheb_iter_ref`` on a slab: only ``d_h`` carries the halo."""
    return cheb_chain(
        lambda _d: stencil_apply_halo_ref(ops, a, b, d_h), lambda t: invd * t,
        c1, c2, _interior(ops, d_h), r, x,
    )


def cheb_iter_dg_halo_ref(ops: LevelOps, a, b, c1, c2, d_h, r, x):
    diag = cheb_diag(ops, a, b, r)
    return cheb_chain(
        lambda _d: stencil_apply_halo_ref(ops, a, b, d_h), lambda t: t / diag,
        c1, c2, _interior(ops, d_h), r, x,
    )


def stage_mix_ref(mat: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """out_i = sum_j mat[i, j] W_j as a reshaped GEMM."""
    out = mat @ W.reshape(W.shape[0], -1)
    return out.reshape((mat.shape[0],) + W.shape[1:])


def ms_mix_apply_ref(ops: LevelOps, Ainv: torch.Tensor, tau, u: torch.Tensor):
    """out_i = sum_j Ainv[i, j] (M u_j) + tau (K u_i)."""
    MW, KW = mass_stiffness_apply_ref(ops, u)
    return stage_mix_ref(Ainv, MW) + tau * KW


def ms_mix_apply_split_ref(ops: LevelOps, tau, v: torch.Tensor, u: torch.Tensor):
    """out_i = M v_i + tau (K u_i): K1 with v = Ainv u mixed beforehand."""
    dim = u.ndim - 1
    return apply_mass(ops, v, dim) + tau * apply_stiffness(ops, u, dim)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _on_cpu(*ts: torch.Tensor) -> bool:
    if all(t.is_cuda for t in ts):
        return False
    kinds = {t.device.type for t in ts}
    if kinds == {"cpu"}:
        return True
    raise ValueError(f"tensors must all lie on the CPU or all on CUDA: {kinds}")


def _check_field(t: torch.Tensor, shape: tuple, name: str) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernels take float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_block(ops: LevelOps, u: torch.Tensor, name: str) -> tuple[int, int, int]:
    if u.ndim not in (3, 4):
        raise ValueError(
            f"{name}: the CUDA kernels take stage blocks (q, m, m, m) or (q, m, m)"
        )
    q, m = u.shape[0], ops.m
    _check_field(u, (q,) + (m,) * (u.ndim - 1), name)
    if not ops.kernel_bands:
        raise ValueError("the CUDA kernels take f32 contiguous band tables of degree 1-4")
    if ops.mass_band.device != u.device:
        raise ValueError("band tables and fields must share a device")
    return q, m, ops.p


def _stage_coefs(a, q: int, device) -> torch.Tensor:
    """``a`` as the contiguous f32 (q,) table that the z march (its a, c1,
    c2; K8's c1a, c2a, c1b, c2b) and K4-2D read by pointer: a (q,) f32
    contiguous tensor on
    ``device`` as it is (no copy, no device op), any other (q,) or 0-d
    tensor converted, a Python scalar filled in."""
    if not isinstance(a, torch.Tensor):
        return torch.full((q,), float(a), dtype=torch.float32, device=device)
    if a.ndim == 0:
        a = a.expand(q)
    if a.shape != (q,):
        raise ValueError(f"per-stage coefficients: expected shape ({q},), got {tuple(a.shape)}")
    if a.dtype == torch.float32 and a.is_contiguous() and a.device == device:
        return a
    return a.to(device=device, dtype=torch.float32).contiguous()


def march_plan(q: int, nz: int, m: int, ty: int = MARCH_TILE[0],
               per_stage: bool = True,
               max_chunk: int = MARCH_MAX_CHUNK) -> tuple[int, tuple[int, int, int]]:
    """(chunk, grid) of a z-march launch over ``nz`` output planes of ``q``
    stages of m x m on ``ty`` x 64 tiles, a block per stage (K1's Mix
    mode, ``per_stage`` False: a block for every stage): the most planes a
    block marches, a power of two up to ``max_chunk`` (K8:
    PAIR_MAX_CHUNK), the largest that leaves MARCH_MIN_BLOCKS blocks (Mix:
    MIX_MIN_BLOCKS; 1 where even that does not), and the launch grid the
    kernel takes from it (x tiles, y tiles, chunks, times q per stage;
    ``march_planes``)."""
    tx = MARCH_TILE[1]
    tiles = -(-m // tx), -(-m // ty)
    lanes = q if per_stage else 1
    least = MARCH_MIN_BLOCKS if per_stage else MIX_MIN_BLOCKS
    chunk = max_chunk
    while chunk > 1 and tiles[0] * tiles[1] * lanes * -(-nz // chunk) < least:
        chunk //= 2
    return chunk, (tiles[0], tiles[1], lanes * -(-nz // chunk))


def march_runs(mode: str, p: int, ty: int = MARCH_TILE[0]) -> bool:
    """Whether the mode's passes run in runs (csrc March::RUNS: K3, K3dg,
    K9c, K9d, K4, K9a (Apply), K5, K9b (MassStiff) and K1's split march at
    p >= 3, K1 (Mix) on the ``ty`` = 16-row tile at p = 3): the z pass over
    4-point groups, the y pass from registers in runs of rows, with its y
    band rows laid out [mass, stiff][row][k] (k padded to a multiple of
    4), and chunks of up to MARCH_RUNS_MAX_CHUNK planes.  Mix on the 8-row
    tile, and at p = 4, keeps its sums per point."""
    if mode == "Mix":
        return p == 3 and ty == MARCH_TILE[0]
    return mode in ("ChebInvd", "ChebDiag", "MixSplit", "Apply", "MassStiff") and p >= 3


def march_max_chunk(mode: str, p: int) -> int:
    """The most planes one block of ``mode`` (Mix: on the 16-row tile)
    marches at degree ``p`` (csrc March::ZC)."""
    return MARCH_RUNS_MAX_CHUNK[p] if march_runs(mode, p) else MARCH_MAX_CHUNK


def march_smem_bytes(p: int, ty: int, rings: int, runs: bool = False) -> int:
    """Shared memory of a z-march block without per-point fields (csrc
    March<P, Mode>): ``rings`` rings of 2p + 2 haloed planes, the z-pass
    planes E and F, the y-pass fields C and D, the z and y band rows (in
    ``runs``: a chunk of MARCH_RUNS_MAX_CHUNK planes, the y rows [mass,
    stiff][row][k] with k padded to a multiple of 4)."""
    nb, hx, hy = 2 * p + 1, MARCH_TILE[1] + 2 * p, ty + 2 * p
    plane = hy * hx
    zc = MARCH_RUNS_MAX_CHUNK[p] if runs else MARCH_MAX_CHUNK
    y_rows = 2 * ty * (-(-nb // 4) * 4) if runs else 2 * nb * ty
    floats = rings * (2 * p + 2) * plane + 2 * plane + 2 * ty * hx + 2 * nb * zc + y_rows
    return 4 * floats


def pair_smem_bytes(p: int, ty: int) -> int:
    """Shared memory of a K8 block (csrc PairMarch<P, TY>): the ring of
    2p + 2 planes of d with a 2p halo, the z-pass fields E and F over such a
    plane, the y-pass fields C and D over the tile's rows grown by p, the
    ring of 2p + 1 grown planes of d1, two grown planes of r, the ring of
    p + 1 core planes of r1, x at the core for two planes, and the band
    rows and 1D diagonals of a chunk's planes (up to PAIR_MAX_CHUNK) and 2p
    more, the grown rows and the grown columns."""
    tx = MARCH_TILE[1]
    nb, gy, gx, dy, dx = 2 * p + 1, ty + 2 * p, tx + 2 * p, ty + 4 * p, tx + 4 * p
    core = ty * tx
    floats = ((2 * p + 2) * dy * dx + 2 * dy * dx + 2 * gy * dx + (2 * p + 1) * gy * gx
              + 2 * gy * gx + (p + 1) * core + 2 * core
              + (2 * nb + 2) * (PAIR_MAX_CHUNK + 2 * p + gy + gx))
    return 4 * floats


def pair_tile(p: int) -> int:
    """K8's tile height at degree ``p``: the tallest of MIX_TILES whose block
    lets two blocks share an SM, else the tallest that fits one block (16
    rows at p = 1 and 3, 8 at p = 2 and 4); csrc ``pair_tile<P>`` builds
    only this height and refuses a launch at another."""
    for per_sm in (2, 1):
        for ty in MIX_TILES:
            nbytes = pair_smem_bytes(p, ty)
            if nbytes <= BLOCK_SMEM_BYTES and per_sm * (nbytes + 1024) <= SM_SMEM_BYTES:
                return ty
    raise ValueError(f"no K8 tile fits one block at p={p}")


def mix_tile(q: int, p: int) -> int:
    """K1's tile height at degree ``p`` with ``q`` stages: the tallest of
    MIX_TILES whose block (a ring per stage; on the 16-row tile at p = 3 in
    runs' layout, ``march_runs``) lets two blocks share an SM, else the
    tallest that fits one block, else 0: no block holds the q rings (p = 3
    with q >= 7), and K1 takes the route K2 + ``ms_mix_apply_split``.  At
    p = 3 the one-block form stays: ``Mix<16, 4>`` in runs took P16's shape
    (q = 4) in 0.4349 ms on the H100 against the route's 0.4784 (PERF.md,
    section 6).  At p = 4 the one-block form is left out, so K1
    takes the route wherever no tile lets two blocks share an SM (q >= 3):
    one ``Mix<8, 4>`` block per SM (8-row tile, 2q barriers a plane) read
    0.100 of its bound at P17's shape, and the route's split march runs its
    passes from registers (``march_runs``; PERF.md, section 6).  Above 4
    stages a thread keeps QMAX sums per output point, and only the 8-row
    tile (2 points) keeps them in registers (csrc/ms_mix_apply.cu)."""
    for per_sm in (2,) if p >= 4 else (2, 1):
        for ty in MIX_TILES if q <= 4 else MIX_TILES[1:]:
            nbytes = march_smem_bytes(p, ty, q, march_runs("Mix", p, ty))
            if nbytes <= BLOCK_SMEM_BYTES and per_sm * (nbytes + 1024) <= SM_SMEM_BYTES:
                return ty
    return 0


def march_planes(nz: int, chunk: int, bz: int) -> tuple[int, int, int]:
    """(stage, first plane, end plane) of the blocks at ``blockIdx.z = bz``,
    as the march reads it."""
    nch = -(-nz // chunk)
    z0 = (bz % nch) * chunk
    return bz // nch, z0, min(z0 + chunk, nz)


@functools.lru_cache(maxsize=None)  # once per shape: the search costs a launch about 7 us of host time
def runs_chunk(mode: str, q: int, nz: int, m: int, p: int) -> int:
    """The chunk of a launch of a mode of RUNS_BLOCKS in runs (p >= 3: K3
    and K9c, ChebInvd, two blocks per SM; K4 and K9a, Apply, and K5 and
    K9b, MassStiff, three at p = 3 and two at p = 4; K1, Mix on the 16-row
    tile at p = 3, one block for all q stages, one per SM): the power of
    two up to ``march_max_chunk`` that gives the busiest SM the least work,
    counted as its blocks (ceil(blocks / SMS)) times the planes of each
    plus one for the block's ring fill, among the chunks that give every SM
    the mode's resident blocks where any does; of equal ones the longest.
    For K3 and K9c on the H100 at P16's 95, P17's and P20's 127 levels and
    P18's first slab this picked the fastest chunk of the sweep or one
    within 1% of it (PERF.md), where ``march_plan``'s rule (the longest
    that leaves two blocks per SM) took 16 planes at P16's 95 level (1.09
    waves, 16% slower) and 8 on the slab; for K4 and K9a at P20's 127,
    P17's and P19's 255 and P16's 191 levels and on P18's first slab, K5 at
    P20's vmult and P16's shape, K9b on P18's first slab and K1 at P16's
    finest level the fastest of the sweep (scripts/torch_chunk_sweep.py)."""
    tiles = -(-m // MARCH_TILE[1]) * -(-m // MARCH_TILE[0])
    lanes = 1 if mode == "Mix" else q
    resident = RUNS_BLOCKS[mode][p]

    def cost(chunk: int) -> tuple:
        per_sm = -(-tiles * lanes * -(-nz // chunk) // SMS)
        return per_sm < resident, per_sm * (chunk + 1), -chunk

    cap = march_max_chunk(mode, p)
    return min((2**k for k in range(cap.bit_length()) if 2**k <= cap), key=cost)


def _runs_plan(ops: LevelOps, q: int, nz: int, mode: str = "ChebDiag") -> tuple[int]:
    """(chunk,) of a launch of a march mode but Mix: ``march_plan`` with
    the mode's most planes per block at the level's degree; K3, K9c, K4,
    K9a, K5 and K9b in runs (RUNS_BLOCKS) ``runs_chunk``."""
    if mode in RUNS_BLOCKS and march_runs(mode, ops.p):
        return (runs_chunk(mode, q, nz, ops.m, ops.p),)
    return (march_plan(q, nz, ops.m, max_chunk=march_max_chunk(mode, ops.p))[0],)


def _march(name: str, ops: LevelOps, q: int, fields: tuple, a, b, cs=(), slab=(), *,
           plan: tuple) -> None:
    """Launch the z-march entry point ``name`` over ``q`` stages:
    ``fields`` (the tensors before the band tables), the band tables, ``a``
    as a (q,) table, ``b`` by value, ``cs`` (Chebyshev: c1, c2; K8: c1a,
    c2a, c1b, c2b) as (q,) tables (no device op where they are f32 (q,)
    tensors already), q, m, ``slab`` (a slab's nzl, z_off), then
    ``plan`` (the chunk, ``_runs_plan``; K8: its tile height and chunk), p."""
    device = fields[0].device
    tabs = [_stage_coefs(c, q, device) for c in (a, *cs)]  # held until the launch is queued
    _launch_raw(name, device, *(t.data_ptr() for t in fields), ops.mass_band.data_ptr(),
                ops.stiff_band.data_ptr(), tabs[0].data_ptr(), float(b),
                *(t.data_ptr() for t in tabs[1:]), q, ops.m, *slab, *plan, ops.p)


def _launch(name: str, *args) -> None:
    """Launch entry point ``name`` on the first tensor's device (the slots of
    a mesh may lie on several), each tensor passed as its data pointer."""
    _launch_raw(name, args[0].device,
                *[a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args])


def _launch_raw(name: str, device: torch.device, *args) -> None:
    """Launch entry point ``name`` on ``device``'s current stream with
    ``args`` as they are (pointers as ints); raise if it was refused."""
    from .build import load_library

    fn = getattr(load_library(), name)
    # the current stream's handle, without building a torch.cuda.Stream
    # (the call PyTorch's generated kernels launch with)
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    if device.index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, stream)
    if err != 0:
        msg = load_library().spirk_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def _entry(name: str, u: torch.Tensor) -> str:
    """The entry point (and ``LAUNCHES`` key) of a kernel for u's dimension."""
    return name if u.ndim == 4 else name + "_2d"


def stencil_apply(ops: LevelOps, a, b, u: torch.Tensor) -> torch.Tensor:
    """K4 (3D, the z march) / K4-2D: (a_i M + b K) u_i per stage; ``a``
    scalar or (q,), ``b`` a Python scalar (passed by value: a launch is one
    device op)."""
    if _on_cpu(u, ops.mass_band):
        return stencil_apply_ref(ops, a, b, u)
    q, m, p = _check_block(ops, u, "u")
    out = torch.empty_like(u)
    if u.ndim == 4:
        _march("spirk_stencil_apply", ops, q, (u, out), a, b,
               plan=_runs_plan(ops, q, m, "Apply"))
        LAUNCHES["stencil_apply"] += 1
        return out
    coefs = _stage_coefs(a, q, u.device)  # held until the launch is queued
    _launch_raw("spirk_stencil_apply_2d", u.device, u.data_ptr(), out.data_ptr(),
                ops.mass_band.data_ptr(), ops.stiff_band.data_ptr(), coefs.data_ptr(), float(b),
                q, m, p)
    LAUNCHES["stencil_apply_2d"] += 1
    return out


def mass_stiffness_apply(ops: LevelOps, u: torch.Tensor):
    """K5 (3D, the z march) / K5-2D: (M u_i, K u_i) per stage from one read
    of u."""
    if _on_cpu(u, ops.mass_band):
        return mass_stiffness_apply_ref(ops, u)
    q, m, p = _check_block(ops, u, "u")
    mu, ku = torch.empty_like(u), torch.empty_like(u)
    name = _entry("mass_stiffness_apply", u)
    plan = _runs_plan(ops, q, m, "MassStiff") if u.ndim == 4 else ()
    _launch("spirk_" + name, u, mu, ku, ops.mass_band, ops.stiff_band, q, m, *plan, p)
    LAUNCHES[name] += 1
    return mu, ku


def cheb_iter(ops: LevelOps, a, b, c1, c2, d, r, x, invd):
    """K3: one Chebyshev step, returns new tensors (r', d', x'); the
    inputs are left unchanged (none is updated in place).  3D only."""
    if _on_cpu(d, r, x, invd, ops.mass_band):
        return cheb_iter_ref(ops, a, b, c1, c2, d, r, x, invd)
    if d.ndim != 4:
        raise ValueError("cheb_iter takes 3D stage blocks (q, m, m, m)")
    q, m, _ = _check_block(ops, d, "d")
    for t, name in ((r, "r"), (x, "x"), (invd, "invd")):
        _check_field(t, d.shape, name)
    r_out, d_out, x_out = (torch.empty_like(d) for _ in range(3))
    _march("spirk_cheb_iter", ops, q, (d, r, x, invd, r_out, d_out, x_out), a, b, (c1, c2),
           plan=_runs_plan(ops, q, m, "ChebInvd"))
    LAUNCHES["cheb_iter"] += 1
    return r_out, d_out, x_out


def cheb_iter_dg(ops: LevelOps, a, b, c1, c2, d, r, x):
    """K3dg: K3's step with the Jacobi diagonal rebuilt per point from
    ``ops.mass_diag`` / ``ops.stiff_diag`` (no D^-1 field); returns new
    tensors (r', d', x').  3D only."""
    if _on_cpu(d, r, x, ops.mass_band):
        return cheb_iter_dg_ref(ops, a, b, c1, c2, d, r, x)
    if d.ndim != 4:
        raise ValueError("cheb_iter_dg takes 3D stage blocks (q, m, m, m)")
    q, m, _ = _check_block(ops, d, "d")
    for t, name in ((r, "r"), (x, "x")):
        _check_field(t, d.shape, name)
    for t in (ops.mass_diag, ops.stiff_diag):
        _check_field(t, (m,), "1D diagonal")
    r_out, d_out, x_out = (torch.empty_like(d) for _ in range(3))
    _march("spirk_cheb_iter_dg", ops, q,
           (d, r, x, ops.mass_diag, ops.stiff_diag, r_out, d_out, x_out), a, b, (c1, c2),
           plan=_runs_plan(ops, q, m))
    LAUNCHES["cheb_iter_dg"] += 1
    return r_out, d_out, x_out


def cheb_pair_dg(ops: LevelOps, a, b, c1a, c2a, c1b, c2b, d, r, x):
    """K8: two Chebyshev steps in one pass, the Jacobi diagonal rebuilt per
    point as in K3dg; returns new tensors (r'', d'', x'').  3D only; one
    launch of the march's pair form on ``pair_tile``'s tile, a, c1a, c2a,
    c1b, c2b as (q,) tables, b by value."""
    if _on_cpu(d, r, x, ops.mass_band):
        return cheb_pair_dg_ref(ops, a, b, c1a, c2a, c1b, c2b, d, r, x)
    if d.ndim != 4:
        raise ValueError("cheb_pair_dg takes 3D stage blocks (q, m, m, m)")
    q, m, p = _check_block(ops, d, "d")
    for t, name in ((r, "r"), (x, "x")):
        _check_field(t, d.shape, name)
    for t in (ops.mass_diag, ops.stiff_diag):
        _check_field(t, (m,), "1D diagonal")
    r_out, d_out, x_out = (torch.empty_like(d) for _ in range(3))
    ty = pair_tile(p)
    chunk, _grid = march_plan(q, m, m, ty, max_chunk=PAIR_MAX_CHUNK)
    _march("spirk_cheb_pair_dg", ops, q,
           (d, r, x, ops.mass_diag, ops.stiff_diag, r_out, d_out, x_out), a, b,
           (c1a, c2a, c1b, c2b), plan=(ty, chunk))
    LAUNCHES["cheb_pair_dg"] += 1
    return r_out, d_out, x_out


def _check_slab(ops: LevelOps, u_h: torch.Tensor, name: str) -> tuple[int, int, int, int]:
    """(q, m, p, nzl) of a haloed slab operand (q, nzl + 2p, m, m)."""
    if u_h.ndim != 4 or ops.z_mass_band is None:
        raise ValueError(f"{name}: the halo kernels take a 3D slab and its slab_ops")
    q, m, p = u_h.shape[0], ops.m, ops.p
    nzl = u_h.shape[1] - 2 * p
    if nzl < 1 or ops.z_off < 0 or ops.z_off + nzl > m:
        raise ValueError(f"{name}: planes {ops.z_off}..{ops.z_off + nzl} leave [0, {m})")
    _check_field(u_h, (q, nzl + 2 * p, m, m), name)
    for band in (ops.mass_band, ops.stiff_band):
        _check_field(band, (2 * p + 1, m), "band table")
        if band.device != u_h.device:
            raise ValueError("band tables and fields must share a device")
    if not 1 <= p <= 4:
        raise ValueError(f"the CUDA kernels take degrees 1-4, got p={p}")
    return q, m, p, nzl


def stencil_apply_halo(ops: LevelOps, a, b, u_h: torch.Tensor) -> torch.Tensor:
    """K9a: (a_i M + b K) u_i on a z slab; ``u_h`` (q, nzl + 2p, m, m) holds
    p planes of each z neighbour, the result is (q, nzl, m, m)."""
    if _on_cpu(u_h, ops.mass_band):
        return stencil_apply_halo_ref(ops, a, b, u_h)
    q, m, _, nzl = _check_slab(ops, u_h, "u_h")
    out = torch.empty((q, nzl, m, m), dtype=u_h.dtype, device=u_h.device)
    _march("spirk_stencil_apply_halo", ops, q, (u_h, out), a, b, slab=(nzl, ops.z_off),
           plan=_runs_plan(ops, q, nzl, "Apply"))
    LAUNCHES["stencil_apply_halo"] += 1
    return out


def mass_stiffness_apply_halo(ops: LevelOps, u_h: torch.Tensor):
    """K9b: (M u_i, K u_i) on a z slab, from one read of ``u_h``."""
    if _on_cpu(u_h, ops.mass_band):
        return mass_stiffness_apply_halo_ref(ops, u_h)
    q, m, p, nzl = _check_slab(ops, u_h, "u_h")
    mu = torch.empty((q, nzl, m, m), dtype=u_h.dtype, device=u_h.device)
    ku = torch.empty_like(mu)
    _launch("spirk_mass_stiffness_apply_halo", u_h, mu, ku, ops.mass_band, ops.stiff_band,
            q, m, nzl, ops.z_off, *_runs_plan(ops, q, nzl, "MassStiff"), p)
    LAUNCHES["mass_stiffness_apply_halo"] += 1
    return mu, ku


def cheb_iter_halo(ops: LevelOps, a, b, c1, c2, d_h, r, x, invd):
    """K9c: one Chebyshev step on a z slab; only ``d_h`` carries the halo,
    ``r``, ``x``, ``invd`` and the results (r', d', x') are (q, nzl, m, m)."""
    if _on_cpu(d_h, r, x, invd, ops.mass_band):
        return cheb_iter_halo_ref(ops, a, b, c1, c2, d_h, r, x, invd)
    q, m, _, nzl = _check_slab(ops, d_h, "d_h")
    for t, name in ((r, "r"), (x, "x"), (invd, "invd")):
        _check_field(t, (q, nzl, m, m), name)
    r_out, d_out, x_out = (torch.empty_like(r) for _ in range(3))
    _march("spirk_cheb_iter_halo", ops, q, (d_h, r, x, invd, r_out, d_out, x_out), a, b,
           (c1, c2), (nzl, ops.z_off), plan=_runs_plan(ops, q, nzl, "ChebInvd"))
    LAUNCHES["cheb_iter_halo"] += 1
    return r_out, d_out, x_out


def cheb_iter_dg_halo(ops: LevelOps, a, b, c1, c2, d_h, r, x):
    """K9d: K9c with the Jacobi diagonal rebuilt per point from the level's
    1D diagonals at the slab's global rows (no D^-1 field)."""
    if _on_cpu(d_h, r, x, ops.mass_band):
        return cheb_iter_dg_halo_ref(ops, a, b, c1, c2, d_h, r, x)
    q, m, _, nzl = _check_slab(ops, d_h, "d_h")
    for t, name in ((r, "r"), (x, "x")):
        _check_field(t, (q, nzl, m, m), name)
    for t in (ops.mass_diag, ops.stiff_diag):
        _check_field(t, (m,), "1D diagonal")
    r_out, d_out, x_out = (torch.empty_like(r) for _ in range(3))
    _march("spirk_cheb_iter_dg_halo", ops, q,
           (d_h, r, x, ops.mass_diag, ops.stiff_diag, r_out, d_out, x_out), a, b, (c1, c2),
           (nzl, ops.z_off), plan=_runs_plan(ops, q, nzl))
    LAUNCHES["cheb_iter_dg_halo"] += 1
    return r_out, d_out, x_out


def mix_table(Ainv: torch.Tensor, tau, device=None) -> torch.Tensor:
    """K1's coefficient table: (q + 1, q) f32 contiguous on ``device``
    (default Ainv's), rows Ainv, then tau per stage."""
    q = Ainv.shape[0]
    device = Ainv.device if device is None else device
    tau_row = torch.full((1, q), float(tau), dtype=torch.float32, device=device)
    return torch.cat([Ainv.to(device=device, dtype=torch.float32), tau_row], dim=0).contiguous()


def mix_plan(q: int, m: int, p: int) -> tuple[int, int]:
    """(tile height, chunk) of K1's Mix launch over q stages of m^3
    (``mix_tile``'s tile; (0, 0) for the route): on the 16-row tile at
    p = 3 (in runs) ``runs_chunk``, else ``march_plan`` with a block for
    every stage."""
    ty = mix_tile(q, p)
    if not ty:
        return 0, 0
    if march_runs("Mix", p, ty):
        return ty, runs_chunk("Mix", q, m, m, p)
    return ty, march_plan(q, m, m, ty, per_stage=False)[0]


def ms_mix_apply(ops: LevelOps, Ainv: torch.Tensor, tau, u: torch.Tensor,
                 mw: torch.Tensor | None = None) -> torch.Tensor:
    """K1: out_i = sum_j Ainv[i, j] (M u_j) + tau (K u_i); q <= 8, 3D.  One
    launch of the z march's Mix mode on ``mix_plan``'s tile and chunk; where
    no tile holds the q rings, K2 (v = Ainv u) and ``ms_mix_apply_split``.
    ``mw``: the launch's coefficient table ``mix_table(Ainv, tau)``, built
    by the caller once per Ainv and tau (default: built here)."""
    if _on_cpu(u, Ainv, ops.mass_band):
        return ms_mix_apply_ref(ops, Ainv, tau, u)
    if u.ndim != 4:
        raise ValueError("ms_mix_apply takes 3D stage blocks (q, m, m, m)")
    q, m, p = _check_block(ops, u, "u")
    if q > QMAX or tuple(Ainv.shape) != (q, q):
        raise ValueError(f"ms_mix_apply takes q <= {QMAX} and a (q, q) Ainv")
    ty, chunk = mix_plan(q, m, p)
    if not ty:
        return ms_mix_apply_split(ops, tau, stage_mix(Ainv, u), u)
    if mw is None:
        mw = mix_table(Ainv, tau, u.device)
    else:
        _check_field(mw, (q + 1, q), "mw")
        if mw.device != u.device:
            raise ValueError("mw and u must share a device")
    out = torch.empty_like(u)
    _launch("spirk_ms_mix_apply", u, out, ops.mass_band, ops.stiff_band, mw, q, m, ty, chunk, p)
    LAUNCHES["ms_mix_apply"] += 1
    return out


def ms_mix_apply_split(ops: LevelOps, tau, v: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """K1's route where no tile holds its q rings (``mix_tile``): out_i =
    M v_i + tau (K u_i), v = Ainv u from K2; the z march's MixSplit mode, a
    block per stage with a ring of v_i and one of u_i; 3D."""
    if _on_cpu(v, u, ops.mass_band):
        return ms_mix_apply_split_ref(ops, tau, v, u)
    if u.ndim != 4:
        raise ValueError("ms_mix_apply_split takes 3D stage blocks (q, m, m, m)")
    q, m, p = _check_block(ops, u, "u")
    _check_field(v, u.shape, "v")
    out = torch.empty_like(u)
    _launch("spirk_ms_mix_apply_split", v, u, out, ops.mass_band, ops.stiff_band, float(tau),
            q, m, *_runs_plan(ops, q, m, "MixSplit"), p)
    LAUNCHES["ms_mix_apply_split"] += 1
    return out


def stage_mix(mat: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """K2: out_i = sum_j mat[i, j] W_j; ``out`` never aliases ``W``."""
    if _on_cpu(W, mat):
        return stage_mix_ref(mat, W)
    qo, qi = mat.shape
    if W.shape[0] != qi or max(qo, qi) > QMAX:
        raise ValueError(f"stage_mix takes (q_out, q_in) <= {QMAX} matching W")
    _check_field(W, tuple(W.shape), "W")
    out = W.new_empty((qo,) + tuple(W.shape[1:]))
    if mat.dtype != torch.float32 or not mat.is_contiguous():
        mat = mat.to(torch.float32).contiguous()
    _launch_raw("spirk_stage_mix", W.device, W.data_ptr(), out.data_ptr(), mat.data_ptr(),
                qo, qi, W.numel() // qi)
    LAUNCHES["stage_mix"] += 1
    return out
