"""Geometric multigrid V-cycle with Chebyshev smoothing.

Port of ``dealii_spirk_tpu/solvers/gmg.py`` (the reference's
``PreconditionerGMG``, ``preconditioner.h:219-501``): global-coarsening
level hierarchy truncated at ``COARSE_SIZE_LIMIT``, Chebyshev(5) /
point-Jacobi smoothing with CG-estimated intervals on every level above
the coarsest, and an exact dense coarse solve (a precomputed inverse —
a deliberate deviation from the reference's AMG coarse V-cycle that can
only reduce iteration counts).

``vcycle`` is the stage-batched V-cycle of the JAX package's
``vcycle_canon`` on the compact (q, *spatial) layout.  With
``kernels=True`` its smoother and residual run through the hand-written
CUDA kernels (3D: K3 ``cheb_iter``, or K3dg ``cheb_iter_dg`` on the large
levels of ``cheb_diag_level``, and K4 ``stencil_apply``; 2D: the
elementwise Chebyshev chain over K4-2D, as the JAX package smooths 2D
with its apply kernel, ``solvers/gmg.py:471-477``; on CPU tensors the
wrappers run their plain versions).  With ``cheb_pair=True`` as well, the
levels of ``cheb_pair_level`` take their Chebyshev steps two at a time
through K8 ``cheb_pair_dg`` (the JAX package's ``SPIRK_CHEB_PAIR``; off by
default there and here); with ``kernels=False`` the same
structure runs the plain torch operators, each level by its own route
(``mass_laplace``: MatrixBased levels, built ``with_dense``, apply their
dense matrices).  The algebraic hierarchy of ``solvers/amg.py``
comes in the same ``GMGData`` and runs through the same code, kernels
included.  The sequential ``irk`` scheme
runs it on one stage at a time with ``stage_prec``.  Grid transfers are
dense 1D contractions (``apply_dense_1d``) and the coarse solve a batched
dense inverse, as the JAX package leaves both to XLA; the 3D kernel
V-cycle takes each level's residual restriction and its prolongation with
the correction as one K10 launch each (``ops/cuda/transfer.py``), in the
dense contractions' order of sums.

With ``mesh=`` the V-cycle runs on a (stage, space) slot mesh (the JAX
package's ``vcycle_canon(mesh=)``): ``scatter_prec`` splits the per-level
state once, the levels that ``canon_shardable`` admits smooth and take
residuals through the space-sharded layer (``ops/cuda/sharded.py``: the
halo kernels K9a, K9c, K9d and p-plane exchanges), their z transfers are
h-plane exchanges and local contractions, and a level too small to split is
gathered onto the first space slot of its stage row, solved there by the
unsharded level code on that row's stages and scattered back (the
reference coarsens onto fewer ranks the same way,
``preconditioner.h:287-339``).  The mesh V-cycle takes single Chebyshev
steps whatever ``cheb_pair`` says: the JAX package's pair kernel has no
sharded form (``solvers/gmg.py:596``), and so the port runs the
reference's semantics there.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields
from typing import Callable

import numpy as np
import torch

from ..fem.grid import Space
from ..ops.cuda import sharded as shk
from ..ops.cuda import stencil as st
from ..ops.cuda import transfer as tr
from ..ops.mass_laplace import LevelOps, apply_shifted_batched, level_ops, operator_diagonal
from ..ops.banded import apply_dense_1d
from ..parallel.mesh import SlotMesh
from ..parallel.sharding import ShardedBlock, canon_shardable, scatter, send, z_partition
from ..utils.timer import no_phase
from .chebyshev import chebyshev_apply, estimate_chebyshev_range

SMOOTHER_DEGREE = 5  # reference preconditioner.h:222
SMOOTHING_RANGE = 20.0  # reference preconditioner.h:221
EIG_CG_ITERATIONS = 20  # reference preconditioner.h:223

# levels at or below this DoF count are dropped and solved exactly by the
# dense coarse solve (the JAX package's rule, gmg.py:93-98)
COARSE_SIZE_LIMIT = 1024

# 3D levels with at least this many points per stage are smoothed by K3dg
# (the Jacobi diagonal rebuilt from the 1D factors, no D^-1 field read):
# a stage field of 16 MiB or more at f32, so a block of four stages or more
# outgrows the H100's 50 MB L2 and every pass of the smoother step goes to
# DRAM, where the dropped pass is a seventh of K3's traffic.  Smaller levels
# keep K3.  On the level chains of refinements 3-8 at degrees 1-4 this picks
# the levels the JAX package's cheb_diag_supported picks (m >= 191).
CHEB_DIAG_MIN_POINTS = 1 << 22


def cheb_diag_level(m: int, dim: int) -> bool:
    """Whether the kernel V-cycle smooths a level of m points per axis
    with K3dg (``CHEB_DIAG_MIN_POINTS``)."""
    return dim == 3 and m**dim >= CHEB_DIAG_MIN_POINTS


# The pair budget of the JAX package's K8 (``_cheb2_by``, stencil.py:2025-
# 2045): its smallest window — 8 y rows and 16 more, 8 + 4p planes of d,
# 8 + 2p of r and the stage-1 fields, whole x rows padded to 128 lanes —
# must fit 11 MiB of VMEM.
PAIR_WINDOW_BYTES = 11 * 2**20


def cheb_pair_level(m: int, dim: int, p: int) -> bool:
    """Whether a ``cheb_pair`` V-cycle smooths a level of m points per axis
    at degree p with K8: the K3dg levels where the JAX package pairs steps
    with its switch on (``cheb2_supported``), i.e. where its pair window
    fits ``PAIR_WINDOW_BYTES``.  K8's tile on the H100 does not depend on
    m (it shrinks with p only); the rule keeps both packages pairing the
    same levels (on refinements 3-8 at degrees 1-4 every K3dg level but
    p = 3, m = 767 and p = 4, m >= 511)."""
    if not cheb_diag_level(m, dim):
        return False
    bz, by, byw = 8, 8, 24
    ez = bz + 2 * p
    nx_p = -(-m // 128) * 128
    floats = (2 * (bz + 4 * p) + 2 * ez + 8 * ez + 6 * bz) * byw + 8 * bz * by
    return floats * nx_p * 4 <= PAIR_WINDOW_BYTES


@dataclass(frozen=True)
class GMGData:
    """Static (tau-independent) multigrid data for one problem."""

    level_ops: tuple[LevelOps, ...]  # coarse -> fine
    prolongs: tuple[torch.Tensor, ...]  # [l]: level l -> level l+1
    coarse_mass: torch.Tensor  # dense coarsest-level dim-D mass matrix
    coarse_stiff: torch.Tensor
    # [l]: prolongs[l] with K10's row-run form (``transfer_runs``), built
    # with the hierarchy
    transfers: tuple[tr.TransferRuns, ...] = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "transfers", tuple(tr.transfer_runs(P) for P in self.prolongs))


@dataclass(frozen=True)
class GMGPrec:
    """Shift-dependent state produced by ``gmg_reinit``: per level the
    (q, *spatial) inverse Jacobi diagonal and the (q,) Chebyshev interval,
    plus the (q, n_c, n_c) inverse of the coarse matrices."""

    inv_diags: tuple[torch.Tensor, ...]
    thetas: tuple[torch.Tensor, ...]
    deltas: tuple[torch.Tensor, ...]
    coarse_inv: torch.Tensor


def coarse_dense(M1: np.ndarray, K1: np.ndarray, dim: int) -> tuple[np.ndarray, np.ndarray]:
    """The dim-D mass and stiffness matrices of the coarsest level's 1D pair
    (M1, K1), for the dense coarse solve."""
    if dim == 2:
        M = np.kron(M1, M1)
        K = np.kron(K1, M1) + np.kron(M1, K1)
    else:
        MM = np.kron(M1, M1)
        MK = np.kron(M1, K1) + np.kron(K1, M1)
        M = np.kron(M1, MM)
        K = np.kron(K1, MM) + np.kron(M1, MK)
    return M, K


def build_gmg_data(space: Space, dtype=torch.float64, device="cpu",
                   with_dense: bool = False) -> GMGData:
    """The geometric hierarchy of ``space``; ``with_dense``: each level with
    its dense 1D matrices (the MatrixBased route)."""
    # coarsest retained level: the largest one still within the dense
    # coarse-solve budget (always keep at least the bottom level, and keep
    # the finest level out of the dense solve when there are >= 2 levels)
    l0 = 0
    for i, lev in enumerate(space.levels):
        if lev.m**space.dim <= COARSE_SIZE_LIMIT:
            l0 = i
    if l0 == len(space.levels) - 1 and len(space.levels) > 1:
        l0 -= 1
    cm, ck = coarse_dense(space.levels[l0].mass_dense, space.levels[l0].stiff_dense, space.dim)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device).contiguous()

    return GMGData(
        level_ops=tuple(level_ops(lev, dtype, device, with_dense) for lev in space.levels[l0:]),
        prolongs=tuple(t(P) for P in space.prolongations[l0:]),
        coarse_mass=t(cm),
        coarse_stiff=t(ck),
    )


_M32 = 0xFFFFFFFF


def _threefry2x32(key: tuple[int, int], x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 with 20 rounds (Salmon et al., SC'11) of the 32-bit
    counter words (x0, x1), held in int64 tensors, under ``key`` — the block
    function of JAX's default generator."""
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    ks = (key[0], key[1], key[0] ^ key[1] ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in rotations[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) & _M32) | (x1 >> (32 - r))
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def threefry_uniform(seed: int, shape: tuple[int, ...], dtype=torch.float64,
                     device="cpu") -> torch.Tensor:
    """The floats in [0, 1) of JAX's ``jax.random.uniform(PRNGKey(seed),
    shape, dtype)`` (before its clamp at the lower bound), drawn on
    ``device``.

    JAX's generator with ``jax_threefry_partitionable`` (its default):
    element i (row-major) takes the Threefry-2x32 block of the counter
    (i >> 32, i & 0xffffffff) under the key (0, seed); f32 keeps the top 23
    bits of the two words' XOR as the mantissa of a float in [1, 2), f64
    the top 52 bits of the words joined (first word high); minus 1, which
    is the mantissa times 2^-23 (2^-52) exactly."""
    n = int(np.prod(shape))
    idx = torch.arange(n, dtype=torch.int64, device=device)
    w0, w1 = _threefry2x32((0, seed), idx >> 32, idx & _M32)
    if dtype == torch.float32:
        return (((w0 ^ w1) >> 9).to(torch.float32) * 2.0**-23).reshape(shape)
    mant = (w0 << 20) | (w1 >> 12)
    return (mant.to(torch.float64) * 2.0**-52).reshape(shape)


def default_start(shape: tuple[int, ...], dtype=np.float64) -> np.ndarray:
    """Lanczos start vector of a level: the bits of the JAX package's
    ``jax.random.uniform(PRNGKey(42), shape, dtype)`` (``solvers/gmg.py``),
    drawn anew (same seed) for every level."""
    tdt = torch.float32 if np.dtype(dtype) == np.float32 else torch.float64
    return threefry_uniform(42, shape, tdt).clamp_min(0).numpy()


def gmg_reinit(
    gmg: GMGData,
    a: torch.Tensor,
    b: float,
    dim: int,
    *,
    start: Callable[[tuple[int, ...], type], np.ndarray] | None = None,
) -> GMGPrec:
    """Build the GMG state for the stage-batched operators a_i M + b K
    (the block preconditioner, reference ``main.cc:3150-3178`` and
    ``PreconditionerGMG::reinit``, ``preconditioner.h:341-447``): per-level
    Jacobi diagonals, Chebyshev interval estimates and the coarse inverse.

    ``start(shape, numpy dtype)`` gives each smoothed level's Lanczos
    start vector (broadcast over the stages); ``default_start`` when None.
    The Lanczos applies take each level's route; the coarse matrices are
    ``gmg``'s own (an AMG hierarchy brings its Galerkin ones), never rebuilt
    from a space.
    """
    start = start or default_start
    dtype, device = gmg.coarse_mass.dtype, gmg.coarse_mass.device
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    a = torch.as_tensor(a, dtype=dtype, device=device)
    q = a.shape[0]
    one = torch.ones(q, dtype=dtype, device=device)
    inv_diags, thetas, deltas = [], [], []
    for lvl, ops in enumerate(gmg.level_ops):
        inv_diag = 1.0 / operator_diagonal(ops, a, b, dim)
        inv_diags.append(inv_diag)
        if lvl == 0:
            # the coarsest level is solved exactly (dense); no smoother
            thetas.append(one)
            deltas.append(one)
            continue
        shape = (ops.m,) * dim
        rhs = torch.as_tensor(np.array(start(shape, np_dtype)), dtype=dtype, device=device)
        rhs = rhs.expand((q,) + shape).contiguous()
        theta, delta = estimate_chebyshev_range(
            lambda u, ops=ops: apply_shifted_batched(ops, a, b, u, dim),
            inv_diag,
            rhs,
            n_cg_iterations=EIG_CG_ITERATIONS,
            smoothing_range=SMOOTHING_RANGE,
        )
        thetas.append(theta)
        deltas.append(delta)
    coarse = a[:, None, None] * gmg.coarse_mass[None] + b * gmg.coarse_stiff
    return GMGPrec(
        inv_diags=tuple(inv_diags),
        thetas=tuple(thetas),
        deltas=tuple(deltas),
        coarse_inv=torch.linalg.inv(coarse),
    )


def stage_prec(prec: GMGPrec, i: int) -> GMGPrec:
    """Stage i of a stage-batched ``GMGPrec``: every field keeps a leading
    axis of 1 (the JAX package's ``tree_map(lambda x: x[i], prec)`` of the
    sequential ``irk``, ``schemes/irk.py:231-234``)."""
    return GMGPrec(
        inv_diags=tuple(d[i : i + 1] for d in prec.inv_diags),
        thetas=tuple(t[i : i + 1] for t in prec.thetas),
        deltas=tuple(d[i : i + 1] for d in prec.deltas),
        coarse_inv=prec.coarse_inv[i : i + 1],
    )


def _to_device(obj, device):
    """A frozen dataclass of tensors (and tuples of them) on ``device``."""
    def move(v):
        if isinstance(v, torch.Tensor):
            return v.to(device)
        if isinstance(v, tuple):
            return tuple(move(x) for x in v)
        if isinstance(v, (LevelOps, GMGData, GMGPrec)):
            return _to_device(v, device)
        return v

    return type(obj)(**{f.name: move(getattr(obj, f.name))
                        for f in fields(obj) if f.init})


def row_prec(prec: GMGPrec, rows: slice) -> GMGPrec:
    """The stages ``rows`` of a stage-batched ``GMGPrec``."""
    return GMGPrec(
        inv_diags=tuple(d[rows] for d in prec.inv_diags),
        thetas=tuple(t[rows] for t in prec.thetas),
        deltas=tuple(d[rows] for d in prec.deltas),
        coarse_inv=prec.coarse_inv[rows],
    )


@dataclass(frozen=True)
class MeshPrec:
    """``GMGPrec`` on a slot mesh (``scatter_prec``).  Per level l:
    ``levels[l]`` the slab operators of every slot and ``inv_diags[l]`` the
    split D^-1, or None where the level is not sharded; ``restricts[l]`` /
    ``prolongs[l]`` the z transfers between levels l and l + 1 where level
    l + 1 is sharded, with ``P[l]`` the 1D prolongation on every slot's
    device for the y and x passes.  ``rows[i]`` is stage row i's unsharded
    state (GMGData, GMGPrec, a) on its first slot's device, which solves
    the levels that are not sharded."""

    mesh: SlotMesh
    levels: tuple
    inv_diags: tuple
    thetas: tuple[torch.Tensor, ...]
    deltas: tuple[torch.Tensor, ...]
    restricts: tuple
    prolongs: tuple
    P: tuple
    rows: tuple


def sharded_levels(gmg: GMGData, dim: int, n_space: int) -> list[bool]:
    """Which levels run through the sharded layer: 3D, smoothed, admitted by
    ``canon_shardable``, and so is every finer level."""
    out, ok = [], dim == 3
    for l in reversed(range(len(gmg.level_ops))):
        ops = gmg.level_ops[l]
        ok = ok and l > 0 and canon_shardable((ops.m,) * dim, ops.p, dim, n_space)
        out.append(ok)
    return out[::-1]


def scatter_prec(gmg: GMGData, prec: GMGPrec, a: torch.Tensor, dim: int,
                 mesh: SlotMesh) -> MeshPrec:
    """Split the multigrid state over the mesh, once per ``gmg_reinit``."""
    q = a.shape[0]
    ql = q // mesh.n_stage
    sharded = sharded_levels(gmg, dim, mesh.n_space)
    n = len(gmg.level_ops)
    levels = tuple(
        shk.shard_level(gmg.level_ops[l], mesh) if sharded[l] else None for l in range(n)
    )
    inv_diags = tuple(
        scatter(prec.inv_diags[l], mesh, kind=None) if sharded[l] else None for l in range(n)
    )
    # transfers between levels l and l + 1, where level l + 1 is sharded
    pairs = [(l, gmg.prolongs[l]) for l in range(n - 1)]
    restricts = tuple(shk.transfer_z(P.T, mesh) if sharded[l + 1] else None for l, P in pairs)
    prolongs = tuple(shk.transfer_z(P, mesh) if sharded[l + 1] else None for l, P in pairs)
    Ps = tuple(
        tuple(
            tuple(P.to(mesh.device(i, j)) for j in range(mesh.n_space))
            for i in range(mesh.n_stage)
        ) if sharded[l + 1] else None
        for l, P in pairs
    )
    rows = []
    for i in range(mesh.n_stage):
        dev, sl = mesh.device(i, 0), slice(i * ql, (i + 1) * ql)
        rows.append((_to_device(gmg, dev), _to_device(row_prec(prec, sl), dev), a[sl].to(dev)))
    return MeshPrec(
        mesh=mesh, levels=levels, inv_diags=inv_diags, thetas=prec.thetas,
        deltas=prec.deltas, restricts=restricts, prolongs=prolongs, P=Ps, rows=tuple(rows),
    )


def _coarse_solve(prec: GMGPrec, r: torch.Tensor) -> torch.Tensor:
    q = r.shape[0]
    x = torch.bmm(prec.coarse_inv, r.reshape(q, -1, 1))
    return x.reshape(r.shape)


def vcycle(
    gmg: GMGData,
    prec: GMGPrec,
    a: torch.Tensor,
    b: float,
    r: torch.Tensor,
    dim: int,
    *,
    kernels: bool,
    mesh: SlotMesh | None = None,
    top: int | None = None,
    cheb_pair: bool = False,
    phase: Callable = no_phase,
):
    """One stage-batched V-cycle approximating (a_i M + b K)^-1 r_i
    (``a``, ``prec`` and ``r`` share the stage axis).  ``top``: start at
    that level instead of the finest.  ``mesh``: ``prec`` is a
    ``MeshPrec`` and ``r`` a ``ShardedBlock`` on that mesh (see the module
    docstring); the result is one too.  ``cheb_pair``: with ``kernels``,
    smooth the ``cheb_pair_level`` levels by K8, two steps per launch
    (ignored on a mesh).  Without ``kernels`` each level's plain
    operators take its own route (``mass_laplace``).  ``phase``:
    ``phase(name)`` gives the context of each level's smoothing
    (``mg_smooth``) and of its residual and transfers (``mg_transfer``);
    default: none.

    Per level: pre-smoothing from a zero initial guess, the residual
    ``r - A x`` restricted to the next coarser level, the coarse
    correction prolongated back, post-smoothing from the corrected guess;
    the coarsest retained level is solved exactly.  Matches deal.II's
    ``Multigrid`` as configured by the reference (one V-cycle per inner
    solve when InnerTolerance == 0, reference ``main.cc:1126-1148``).
    """
    if mesh is not None:
        return _vcycle_mesh(prec, a, b, r, dim, kernels=kernels, phase=phase)
    apply_fn = st.stencil_apply if kernels else st.stencil_apply_ref
    fused = kernels and dim == 3  # K3 is 3D; 2D chains its step over K4-2D

    def smooth(l: int, rl: torch.Tensor, x0: torch.Tensor | None = None):
        ops, invd = gmg.level_ops[l], prec.inv_diags[l]
        pair = None

        def apply(u):
            return apply_fn(ops, a, b, u)

        if fused and cheb_diag_level(ops.m, dim):
            # K3dg; the entry step divides by the diagonal built from the
            # 1D factors, as the JAX package does in XLA (gmg.py:511-531)
            diag = st.cheb_diag(ops, a, b, rl)

            def jacobi(t):
                return t / diag

            def step(c1, c2, d, rr, x):
                return st.cheb_iter_dg(ops, a, b, c1, c2, d, rr, x)

            if cheb_pair and cheb_pair_level(ops.m, dim, ops.p):

                def pair(c1a, c2a, c1b, c2b, d, rr, x):
                    return st.cheb_pair_dg(ops, a, b, c1a, c2a, c1b, c2b, d, rr, x)

        else:

            def jacobi(t):
                return invd * t

            def step(c1, c2, d, rr, x):
                if fused:
                    return st.cheb_iter(ops, a, b, c1, c2, d, rr, x, invd)
                return st.cheb_chain(apply, jacobi, c1, c2, d, rr, x)

        return chebyshev_apply(
            apply,
            step,
            jacobi,
            prec.thetas[l],
            prec.deltas[l],
            rl,
            x0=x0,
            degree=SMOOTHER_DEGREE,
            cheb_pair=pair,
        )

    def solve(l: int, rl: torch.Tensor) -> torch.Tensor:
        if l == 0:
            return _coarse_solve(prec, rl)
        with phase("mg_smooth"):
            x = smooth(l, rl)
        P, runs = gmg.prolongs[l - 1], gmg.transfers[l - 1]
        with phase("mg_transfer"):
            ax = apply_fn(gmg.level_ops[l], a, b, x)
            rc = tr.restrict_residual(runs, rl, ax) if fused else tr.restrict_residual_ref(P, rl, ax)
        xc = solve(l - 1, rc)
        with phase("mg_transfer"):
            x = tr.prolong_add(runs, x, xc) if fused else tr.prolong_add_ref(P, x, xc)
        with phase("mg_smooth"):
            return smooth(l, rl, x0=x)

    return solve(len(gmg.level_ops) - 1 if top is None else top, r)


def _vcycle_mesh(mp: MeshPrec, a, b, r: ShardedBlock, dim: int, *, kernels: bool,
                 phase: Callable) -> ShardedBlock:
    """``vcycle`` on the mesh of ``mp``."""
    mesh = mp.mesh

    def smooth(l: int, rl: ShardedBlock, x0: ShardedBlock | None = None):
        level = mp.levels[l]
        # K9d on the levels K3dg smooths unsharded (the whole level's size
        # decides, so both forms pick the same levels)
        dg = kernels and cheb_diag_level(level.m, dim)
        invd = None if dg else mp.inv_diags[l]
        if dg:
            diag = shk.sharded_cheb_diag(level, a, b, rl)

        return chebyshev_apply(
            lambda u: shk.sharded_stencil_apply(level, a, b, u, kernels=kernels),
            lambda c1, c2, d, rr, x: shk.sharded_cheb_iter(
                level, a, b, c1, c2, d, rr, x, invd, kernels=kernels
            ),
            (lambda t: t / diag) if dg else (lambda t: invd * t),
            mp.thetas[l],
            mp.deltas[l],
            rl,
            x0=x0,
            degree=SMOOTHER_DEGREE,
        )

    def transfer(z_plan, mats, u: ShardedBlock, transpose: bool) -> ShardedBlock:
        """z through the sharded contraction, then y and x on every slot."""
        u = shk.sharded_transfer_z(z_plan, u)
        parts = []
        for i, row in enumerate(u.parts):
            parts.append([])
            for j, t in enumerate(row):
                mat = mats[i][j].T if transpose else mats[i][j]
                for ax in range(2, t.ndim):
                    t = apply_dense_1d(mat, t, ax)
                parts[-1].append(t.contiguous())
        return ShardedBlock(mesh, parts, u.one_lane)

    def solve_rows(l: int, rl: ShardedBlock) -> ShardedBlock:
        """Level l is not sharded: every stage row gathers its slabs onto
        its first space slot, runs the unsharded levels l..0 on its own
        stages there and scatters the result back."""
        parts = []
        for i, row in enumerate(rl.parts):
            dev = mesh.device(i, 0)
            whole = torch.cat(
                [row[0]] + [send(t, dev, "coarse_gather") for t in row[1:]], dim=1
            ) if len(row) > 1 else row[0]
            gmg_i, prec_i, a_i = mp.rows[i]
            x = vcycle(gmg_i, prec_i, a_i, b, whole, dim, kernels=kernels, top=l, phase=phase)
            if len(row) == 1:
                parts.append([x])
                continue
            cuts = z_partition(x.shape[1], mesh.n_space)
            parts.append([
                (x[:, z0:z1] if j == 0
                 else send(x[:, z0:z1], mesh.device(i, j), "coarse_gather")).contiguous()
                for j, (z0, z1) in enumerate(cuts)
            ])
        return ShardedBlock(mesh, parts, rl.one_lane)

    def solve(l: int, rl: ShardedBlock) -> ShardedBlock:
        level = mp.levels[l]
        if level is None:
            return solve_rows(l, rl)
        with phase("mg_smooth"):
            x = smooth(l, rl)
        with phase("mg_transfer"):
            res = rl - shk.sharded_stencil_apply(level, a, b, x, kernels=kernels)
            rc = transfer(mp.restricts[l - 1], mp.P[l - 1], res, True)
        xc = solve(l - 1, rc)
        with phase("mg_transfer"):
            x = x + transfer(mp.prolongs[l - 1], mp.P[l - 1], xc, False)
        with phase("mg_smooth"):
            return smooth(l, rl, x0=x)

    return solve(len(mp.levels) - 1, r)
