"""The space-sharded kernel layer: the halo kernels over the slots of a
(stage, space) mesh.

Port of ``dealii_spirk_tpu/ops/pallas/sharded.py`` (the reference's
spatial domain decomposition of the matrix-free operator: deal.II
partitions the mesh over ``comm_column``, ``main.cc:3027``, and exchanges
ghost DoFs inside every cell loop, ``operator.h:379-421``).  A stage block
is split (stage, space) with the space axis over z
(``parallel/sharding.py``); each operation

1. passes the p boundary z planes to and from the z neighbours
   (``exchange_z``; the slots at the domain ends take exact zeros),
2. runs one halo kernel per slot (``ops/cuda/stencil.py`` K9a-K9d: the
   operand carries the halo, the output is the slot's own planes).

Per output point the arithmetic is that of the whole-field kernel, so the
sharded and the unsharded result agree bit for bit and iteration counts do
not depend on the partition.  No operation here moves more than p planes
(h for a grid transfer) between two slots.

With ``kernels=False`` the same layer runs the kernels' plain versions
(``*_halo_ref``); on CPU slots the kernel wrappers run them too.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ...parallel.mesh import SlotMesh
from ...parallel.sharding import ShardedBlock, canon_nz, send, z_partition
from ..banded import apply_dense_1d
from ..mass_laplace import LevelOps, slab_ops
from . import stencil as st


@dataclass(frozen=True)
class ShardedLevel:
    """One grid level on the mesh: the slab ``LevelOps`` of every slot.  A
    2D level is not split in space (one space column): its blocks are only
    stage-sharded and every stage row runs the whole-field 2D kernels."""

    mesh: SlotMesh
    ops: tuple[tuple[LevelOps, ...], ...]  # [stage row][space slot]
    m: int
    p: int
    dim: int = 3


def shard_level(ops: LevelOps, mesh: SlotMesh, dim: int = 3) -> ShardedLevel:
    if dim == 2:
        if mesh.n_space != 1:
            raise ValueError("a 2D level takes a mesh of one space column")
        grid = tuple((ops.to(mesh.device(i, 0)),) for i in range(mesh.n_stage))
        return ShardedLevel(mesh, grid, ops.m, ops.p, 2)
    cuts = z_partition(ops.m, mesh.n_space)
    grid = tuple(
        tuple(
            slab_ops(ops, z0, z1 - z0, mesh.device(i, j)) for j, (z0, z1) in enumerate(cuts)
        )
        for i in range(mesh.n_stage)
    )
    return ShardedLevel(mesh, grid, ops.m, ops.p)


def _take(t: torch.Tensor, h: int, top: bool) -> torch.Tensor:
    """The h last (``top``) or first planes of a slab, zero-filled where the
    slab has fewer (the ragged last slab under a wide transfer halo)."""
    n = t.shape[1]
    part = t[:, max(n - h, 0) :] if top else t[:, :h]
    if n >= h:
        return part
    fill = torch.zeros((t.shape[0], h - n) + tuple(t.shape[2:]), dtype=t.dtype, device=t.device)
    return torch.cat([fill, part] if top else [part, fill], dim=1)


def exchange_z(W: ShardedBlock, h: int) -> list[list[torch.Tensor]]:
    """Every slot's slab between h planes of each z neighbour: slot j's
    lower halo is slot j-1's top planes, its upper halo slot j+1's first
    planes (the reference's ghost exchange, ``operator.h:379-421``); the
    slots at the domain ends take exact zeros, the zero boundary of the
    whole-field kernels."""
    mesh, nsp = W.mesh, W.mesh.n_space
    out = []
    for i, row in enumerate(W.parts):
        haloed = []
        for j, t in enumerate(row):
            dev = mesh.device(i, j)
            zeros = t.new_zeros((t.shape[0], h) + tuple(t.shape[2:]))
            lo = send(_take(row[j - 1], h, True), dev, "halo") if j > 0 else zeros
            hi = send(_take(row[j + 1], h, False), dev, "halo") if j < nsp - 1 else zeros
            haloed.append(torch.cat([lo, t, hi], dim=1))
        out.append(haloed)
    return out


def _check(level: ShardedLevel, W: ShardedBlock) -> None:
    if W.mesh is not level.mesh:
        raise ValueError("block and level lie on different meshes")
    if W.ndim - W.one_lane != 1 + level.dim or W.shape[-1] != level.m:
        raise ValueError(f"expected a {level.dim}D block of {level.m} points per axis, "
                         f"got {W.shape}")


def sharded_stencil_apply(level: ShardedLevel, a, b, W: ShardedBlock, *,
                          kernels: bool) -> ShardedBlock:
    """(a_i M + b K) W_i on a sharded stage block: a p-plane exchange and
    one K9a launch per slot."""
    _check(level, W)
    if level.dim == 2:
        fn = st.stencil_apply if kernels else st.stencil_apply_ref
        return W.map_slots(lambda i, j, t: fn(level.ops[i][j], W.rows(a, i, j), b, t))
    fn = st.stencil_apply_halo if kernels else st.stencil_apply_halo_ref
    W_h = exchange_z(W, level.p)
    parts = [
        [fn(level.ops[i][j], W.rows(a, i, j), b, u_h) for j, u_h in enumerate(row)]
        for i, row in enumerate(W_h)
    ]
    return ShardedBlock(W.mesh, parts, W.one_lane)


def sharded_mass_stiffness_apply(level: ShardedLevel, W: ShardedBlock, *, kernels: bool):
    """(M W, K W) on a sharded stage block: one K9b launch per slot."""
    _check(level, W)
    if level.dim == 2:
        fn = st.mass_stiffness_apply if kernels else st.mass_stiffness_apply_ref
        W_h = W.parts
    else:
        fn = st.mass_stiffness_apply_halo if kernels else st.mass_stiffness_apply_halo_ref
        W_h = exchange_z(W, level.p)
    both = [
        [fn(level.ops[i][j], u_h) for j, u_h in enumerate(row)] for i, row in enumerate(W_h)
    ]
    return tuple(
        ShardedBlock(W.mesh, [[pair[k] for pair in row] for row in both], W.one_lane)
        for k in (0, 1)
    )


def sharded_cheb_iter(level: ShardedLevel, a, b, c1, c2, d: ShardedBlock, r: ShardedBlock,
                      x: ShardedBlock, invd: ShardedBlock | None, *, kernels: bool):
    """One fused Chebyshev step on sharded blocks (K9c; K9d when ``invd`` is
    None: the diagonal rebuilt from the 1D factors at each slab's rows).
    Only d, the operand of the apply, has its z halos exchanged; r, x, D^-1
    and the three results stay the slots' own planes."""
    _check(level, d)
    if level.dim != 3:
        raise ValueError("the fused Chebyshev step is 3D")
    d_h = exchange_z(d, level.p)
    outs = []
    for i, row in enumerate(d_h):
        outs.append([])
        for j, dh in enumerate(row):
            ops = level.ops[i][j]
            co = [d.rows(c, i, j) for c in (a, b, c1, c2)]
            rest = (dh, r.parts[i][j], x.parts[i][j])
            if invd is None:
                fn = st.cheb_iter_dg_halo if kernels else st.cheb_iter_dg_halo_ref
                outs[-1].append(fn(ops, *co, *rest))
            else:
                fn = st.cheb_iter_halo if kernels else st.cheb_iter_halo_ref
                outs[-1].append(fn(ops, *co, *rest, invd.parts[i][j]))
    return tuple(
        ShardedBlock(d.mesh, [[trip[k] for trip in row] for row in outs], d.one_lane)
        for k in (0, 1, 2)
    )


def sharded_cheb_diag(level: ShardedLevel, a, b, like: ShardedBlock) -> ShardedBlock:
    """The Jacobi diagonal of a_i M + b K on every slab (``st.cheb_diag``)."""
    parts = [
        [st.cheb_diag(level.ops[i][j], like.rows(a, i, j), b, t) for j, t in enumerate(row)]
        for i, row in enumerate(like.parts)
    ]
    return ShardedBlock(like.mesh, parts, like.one_lane)


# ---------------------------------------------------------------------------
# grid transfers over the sharded z axis
# ---------------------------------------------------------------------------


def transfer_z_plan(mat, nsp: int):
    """Shard plan for contracting a dense 1D grid-transfer matrix over the
    space-sharded z axis, or None when the split is uneven or the matrix
    couples beyond one slot's halo (``transfer_z_plan`` of the JAX package).

    ``mat`` is the (n_out, n_in) 1D prolongation or restriction embedded in
    the canonical z extents (``canon_nz``).  Grid transfers are banded about
    the 2:1 coarsening map, so each slot's output rows read only its own
    input planes plus a small halo h; the plan holds the per-slot matrix
    slices (columns outside the domain zeroed, matching the whole
    contraction's implicit zeros) as one stacked
    (nsp, n_out/nsp, n_in/nsp + 2h) array.
    """
    mat = np.asarray(mat)
    n_out, n_in = mat.shape
    if nsp == 1 or n_out % nsp or n_in % nsp:
        return None
    nlo, nli = n_out // nsp, n_in // nsp
    h = 0
    for s in range(nsp):
        nz = np.nonzero(mat[s * nlo : (s + 1) * nlo])[1]
        if nz.size:
            h = max(h, s * nli - int(nz.min()), int(nz.max()) + 1 - (s + 1) * nli)
    h = max(h, 0)
    if h > nli:
        return None  # couples beyond the neighbour slot
    mloc = np.zeros((nsp, nlo, nli + 2 * h), mat.dtype)
    for s in range(nsp):
        c0 = s * nli - h
        lo = max(0, -c0)
        hi = min(nli + 2 * h, n_in - c0)
        mloc[s, :, lo:hi] = mat[s * nlo : (s + 1) * nlo, c0 + lo : c0 + hi]
    return mloc, h


@dataclass(frozen=True)
class TransferZ:
    """A 1D transfer along the sharded z axis: per slot the matrix
    (own output planes, own input planes + 2h), on the slot's device."""

    h: int
    mats: tuple[tuple[torch.Tensor, ...], ...]  # [stage row][space slot]


def transfer_z(mat: torch.Tensor, mesh: SlotMesh) -> TransferZ:
    """``TransferZ`` of the 1D transfer ``mat`` (m_out, m_in) between two
    levels that both split over the mesh (``z_partition``); with one space
    slot the matrix itself.  Raises where ``transfer_z_plan`` finds no
    plan: the port never gathers a sharded level instead."""
    m_out, m_in = mat.shape
    nsp = mesh.n_space
    if nsp == 1:
        h, locs = 0, [mat]
    else:
        emb = np.zeros((canon_nz(m_out), canon_nz(m_in)))
        emb[:m_out, :m_in] = mat.detach().cpu().numpy()
        plan = transfer_z_plan(emb, nsp)
        if plan is None:
            raise ValueError(
                f"the z transfer {m_in} -> {m_out} does not split over {nsp} space slots"
            )
        mloc, h = plan
        outs, ins = z_partition(m_out, nsp), z_partition(m_in, nsp)
        # the slot's real planes: canonical pad planes (rows and columns
        # past the level's m) are dropped; they are zero in the embedding
        locs = [
            torch.as_tensor(mloc[s, : o1 - o0, : i1 - i0 + 2 * h], dtype=mat.dtype)
            for s, ((o0, o1), (i0, i1)) in enumerate(zip(outs, ins))
        ]
    mats = tuple(
        tuple(loc.to(mesh.device(i, j)).contiguous() for j, loc in enumerate(locs))
        for i in range(mesh.n_stage)
    )
    return TransferZ(h, mats)


def sharded_transfer_z(plan: TransferZ, u: ShardedBlock) -> ShardedBlock:
    """out[q, zo, y, x] = sum_zi mat[zo, zi] u[q, zi, y, x] with the z axis
    sharded: an h-plane exchange and one local contraction per slot
    (``sharded_transfer_z`` of the JAX package, a ``dot_general`` there)."""
    u_h = exchange_z(u, plan.h) if plan.h else u.parts
    parts = [
        [apply_dense_1d(plan.mats[i][j], t, 1) for j, t in enumerate(row)]
        for i, row in enumerate(u_h)
    ]
    return ShardedBlock(u.mesh, parts, u.one_lane)
