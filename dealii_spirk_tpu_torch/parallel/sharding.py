"""Sharded stage blocks on the (stage, space) slot mesh.

Port of ``dealii_spirk_tpu/parallel/sharding.py`` together with what
``shard_map`` and the SPMD partitioner do for the JAX package.  The
reference's data distribution maps as:

* stage parallelism -> the leading stage axis split over the "stage" rows
  of the mesh (``q_loc = q / n_stage`` stages per row),
* spatial domain decomposition -> the first spatial axis (z) of a 3D field
  split over the "space" columns (``z_partition``),
* ReshapedVector reductions spanning both axes -> per-slot partial sums
  added in a fixed order (``ShardedBlock.dot``).

A ``ShardedBlock`` is the grid of local tensors ``(q_loc, nz_loc, m, m)``
(2D, one space column: ``(q_loc, m, m)``), each on its slot's device.  It
offers the few vector operations the Krylov solvers and the smoother use
(arithmetic with blocks, scalars and per-stage coefficients, per-lane dots,
masked selection), so a plain tensor and a sharded block go through the
same solver code.

The complex schemes keep their (re, im) pair blocks ``(n2, 2, *spatial)``
on the mesh with the pair axis on the stage rows (``scatter_pairs``): a
slot holds ``(n2_loc, 2, nz_loc, m, m)``, its z axis second.
``pair_view`` and ``lane_view`` switch between that and the 2 n2 lanes
``(2 n2_loc, nz_loc, m, m)`` that the kernels take, without a copy.

``send`` is the one place where data passes from slot to slot; it counts
the bytes by kind in ``EXCHANGE``, as ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

from typing import Callable

import torch

from .mesh import SlotMesh

Z_BLOCK = 8  # planes per z block of the JAX package's canonical layout

# bytes passed from slot to slot, by kind: "halo" (z planes of a neighbour,
# for a kernel or a grid transfer), "mix" (stage blocks of the stage
# mixers), "coarse_gather" (a level too small to split, gathered onto its
# stage row's first slot and scattered back), "state" (a step's right-hand
# side and solution between the whole field and the mesh)
EXCHANGE = {"halo": 0, "mix": 0, "coarse_gather": 0, "state": 0}
# the most planes one "halo" message carried
HALO_MAX_PLANES = {"planes": 0}


def reset_exchange() -> None:
    for k in EXCHANGE:
        EXCHANGE[k] = 0
    HALO_MAX_PLANES["planes"] = 0


def send(t: torch.Tensor, device: torch.device, kind: str) -> torch.Tensor:
    """``t`` on the slot device ``device``, counted as one message.

    Ordering: every slot's work is enqueued on its device's current stream.
    Between slots of one device the copy is therefore ordered after its
    producer and before its consumer with no further step (it is a view).
    Between devices ``Tensor.to`` enqueues the peer copy behind the
    producer on the source's current stream and makes the destination's
    current stream wait for it, so a consumer enqueued afterwards reads
    the data whole; the source tensor must not be written in place
    before the copy has run, and nothing in the port does."""
    EXCHANGE[kind] += t.numel() * t.element_size()
    if kind == "halo":
        HALO_MAX_PLANES["planes"] = max(HALO_MAX_PLANES["planes"], t.shape[1])
    return t.to(device)


# ---------------------------------------------------------------------------
# the z partition
# ---------------------------------------------------------------------------


def _ceil(x: int, m: int) -> int:
    return -(-x // m) * m


def canon_nz(m: int) -> int:
    """z extent of the JAX package's canonical layout: m rounded up to
    whole blocks of 8 planes (``canon_shape``)."""
    return _ceil(m, Z_BLOCK)


def z_partition(m: int, n_space: int) -> list[tuple[int, int]]:
    """[start, stop) planes of each space slot, the JAX package's: slot s
    owns canonical planes [s nz_c / n, (s + 1) nz_c / n) cut to [0, m) —
    127 planes over 2 slots are 64 + 63."""
    nz_c = canon_nz(m)
    if nz_c % n_space:
        raise ValueError(f"z extent {nz_c} does not split over {n_space} space slots")
    nzl = nz_c // n_space
    return [(min(s * nzl, m), min((s + 1) * nzl, m)) for s in range(n_space)]


def _nx_pad(nx: int) -> int:
    # the +p lane margin of the JAX kernels' roll contraction (3D, p = 1,
    # one lane tile) never changes the rounded extent
    return _ceil(nx, 128)


def _canon_by(m: int, p: int, kind: str) -> int:
    """The JAX package's y-block choice for a canonical 3D level
    (``_canon_by_from_shape``): 0 whole planes, > 0 a y block, -1 when no
    kernel variant fits its fast memory."""
    ny_p, nx_p = _ceil(m + p, 8), _nx_pad(m)
    bz = Z_BLOCK
    blocks = 2 * (bz + 2 * p) + 7 * bz + (6 * bz if kind == "cheb" else 0)
    if ny_p * nx_p * 4 * blocks <= 14 * 2**20:
        return 0
    extra = {"apply": 0, "cheb": 6}[kind]
    for by in range(min(256, ny_p - 8), 7, -8):
        if ny_p % by:
            continue
        floats = (2 * (bz + 2 * p) + 2 * bz) * (by + 16) * nx_p + (8 + extra) * bz * by * nx_p
        if floats * 4 <= 11 * 2**20:
            return by
    return -1


def canon_shardable(spatial, p: int, dim: int, n_space: int) -> bool:
    """Whether a level's kernels run space-sharded over ``n_space`` slots —
    the JAX package's rule (``canon_shardable``, ``stencil.py``), kept so
    that both packages shard the same levels: 3D, degrees 1-4, the
    canonical z extent splits evenly into slabs of whole 8-plane blocks,
    and the level fits the JAX kernels' variants.  With one space slot it
    is that package's ``canon_supported``."""
    if not (1 <= p <= 4 and dim in (2, 3)):
        return False
    m = spatial[0]
    if n_space == 1:
        if dim == 2:
            return _ceil(m + p, 8) * _nx_pad(m) * 4 <= 4 * 2**20
        return canon_nz(m) >= 2 * Z_BLOCK and _canon_by(m, p, "apply") >= 0
    if dim != 3:
        return False
    nz_c = canon_nz(m)
    if nz_c % n_space:
        return False
    nzl = nz_c // n_space
    if nzl % Z_BLOCK or nzl < Z_BLOCK:
        return False
    return _canon_by(m, p, "apply") >= 0 and _canon_by(m, p, "cheb") >= 0


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------


class ShardedBlock:
    """A stage block split over the slots of a mesh: ``parts[i][j]`` is the
    local tensor of stage rows ``[i q_loc, (i + 1) q_loc)`` and space slab
    j, on ``mesh.device(i, j)``.

    ``one_lane`` marks the view ``block[None]`` that the unbatched GMRES
    takes: the whole block is then one lane (``shape[0] == 1``, dots give
    one sum), otherwise every stage is a lane.  ``z_axis``: the axis of the
    local tensors that the space slots split (2 for a pair block)."""

    def __init__(self, mesh: SlotMesh, parts, one_lane: bool = False, z_axis: int = 1):
        self.mesh = mesh
        self.parts = [list(row) for row in parts]
        self.one_lane = one_lane
        self.z_axis = z_axis

    # -- what the solvers read ------------------------------------------------
    @property
    def q_loc(self) -> int:
        return self.parts[0][0].shape[0]

    @property
    def q(self) -> int:
        return self.q_loc * self.mesh.n_stage

    @property
    def shape(self) -> tuple[int, ...]:
        first, za = self.parts[0], self.z_axis
        local = tuple(first[0].shape)
        shape = (self.q,) + local[1:za] + (sum(t.shape[za] for t in first),) + local[za + 1 :]
        return (1,) + shape if self.one_lane else shape

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0][0].dtype

    @property
    def device(self) -> torch.device:
        """Where the small per-lane results (dots, norms) live."""
        return self.mesh.device(0, 0)

    def __getitem__(self, key):
        if key is None and not self.one_lane:
            return ShardedBlock(self.mesh, self.parts, True, self.z_axis)
        if key == 0 and self.one_lane:
            return ShardedBlock(self.mesh, self.parts, False, self.z_axis)
        raise IndexError("a sharded block only takes [None] and its inverse [0]")

    # -- per-slot maps ---------------------------------------------------------
    def map(self, fn: Callable, *others) -> "ShardedBlock":
        """``fn(local, *other_locals)`` on every slot; ``others`` are blocks
        or coefficients (``_local``)."""
        return self.map_slots(
            lambda i, j, t: fn(t, *(self._local(o, i, j) for o in others))
        )

    def map_slots(self, fn: Callable) -> "ShardedBlock":
        """``fn(i, j, local)`` on every slot."""
        parts = [[fn(i, j, t) for j, t in enumerate(row)] for i, row in enumerate(self.parts)]
        return ShardedBlock(self.mesh, parts, self.one_lane, self.z_axis)

    def rows(self, c, i: int, j: int):
        """What slot (i, j) takes of a coefficient: a number as it is; of a
        tensor with one entry that entry (0-d); of a per-stage tensor
        (q entries) the (q_loc,) rows of stage row i — on the slot's device."""
        if not isinstance(c, torch.Tensor):
            return c
        device = self.mesh.device(i, j)
        if c.numel() == 1:
            return c.reshape(()).to(device)
        if c.shape[0] != self.q or c.numel() != self.q:
            raise ValueError(f"a per-stage coefficient has {self.q} entries, got {tuple(c.shape)}")
        ql = self.q_loc
        return c.reshape(self.q)[i * ql : (i + 1) * ql].to(device)

    def _local(self, o, i: int, j: int):
        """Slot (i, j)'s part of a block, or its ``rows`` of a coefficient
        shaped to broadcast over the local tensor."""
        if isinstance(o, ShardedBlock):
            return o.parts[i][j]
        c = self.rows(o, i, j)
        if isinstance(c, torch.Tensor) and c.ndim == 1:
            return c.reshape(c.shape + (1,) * (self.parts[i][j].ndim - 1))
        return c

    def __add__(self, o):
        return self.map(lambda a, b: a + b, o)

    __radd__ = __add__

    def __sub__(self, o):
        return self.map(lambda a, b: a - b, o)

    def __rsub__(self, o):
        return self.map(lambda a, b: b - a, o)

    def __mul__(self, o):
        return self.map(lambda a, b: a * b, o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self.map(lambda a, b: a / b, o)

    def zeros_like(self) -> "ShardedBlock":
        return self.map(torch.zeros_like)

    def select(self, mask: torch.Tensor, other: "ShardedBlock") -> "ShardedBlock":
        """Per lane: this block where ``mask``, else ``other``."""
        return self.map(lambda a, m, b: torch.where(m, a, b), mask, other)

    def dot(self, other: "ShardedBlock", batch: bool) -> torch.Tensor:
        """Per-lane dots (``batch``) or the whole block's, on ``device``:
        every slot sums its own part per stage; the partial sums of a stage
        row are added over the space slots in order, then (for one lane)
        the stages in order."""
        rows = []
        for i, row in enumerate(self.parts):
            acc = None
            for j, t in enumerate(row):
                part = torch.sum(t * other.parts[i][j], dim=tuple(range(1, t.ndim)))
                part = part.to(self.device)
                acc = part if acc is None else acc + part
            rows.append(acc)
        lanes = torch.cat(rows)
        if self.one_lane:
            return lanes.sum().reshape(1) if batch else lanes.sum()
        return lanes if batch else lanes.sum()


# ---------------------------------------------------------------------------
# between a whole block and the mesh
# ---------------------------------------------------------------------------


def stage_rows(q: int, mesh: SlotMesh) -> int:
    if q % mesh.n_stage:
        raise ValueError(
            f"stage extent {q} does not split over the stage axis ({mesh.n_stage})"
        )
    return q // mesh.n_stage


def scatter(W: torch.Tensor, mesh: SlotMesh, kind: str | None = "state") -> ShardedBlock:
    """Split a whole stage block (q, *spatial) over the mesh; 2D blocks
    need one space column.  ``kind=None``: set-up data, not counted."""
    ql = stage_rows(W.shape[0], mesh)
    if W.ndim == 4:
        cuts = z_partition(W.shape[1], mesh.n_space)
    elif mesh.n_space == 1:
        cuts = [(0, W.shape[1])]
    else:
        raise ValueError("only 3D blocks split over the space axis")
    parts = []
    for i in range(mesh.n_stage):
        row = []
        for j, (z0, z1) in enumerate(cuts):
            t = W[i * ql : (i + 1) * ql, z0:z1]
            dev = mesh.device(i, j)
            t = t.to(dev) if kind is None else send(t, dev, kind)
            row.append(t.contiguous())
        parts.append(row)
    return ShardedBlock(mesh, parts)


def gather(block: ShardedBlock, device=None, kind: str = "state") -> torch.Tensor:
    """The whole stage block (q, *spatial) on ``device`` (a pair block:
    (n2, 2, *spatial))."""
    device = block.device if device is None else device
    rows = [torch.cat([send(t, device, kind) for t in row], dim=block.z_axis)
            for row in block.parts]
    return torch.cat(rows)


# ---------------------------------------------------------------------------
# pair blocks of the complex schemes
# ---------------------------------------------------------------------------


def pair_view(lanes):
    """The 2 n2 lanes (re, im of pair j at lanes 2j, 2j + 1) as the pair
    block: every slot's (2 n2_loc, nz, ...) viewed as (n2_loc, 2, nz, ...);
    a plain tensor (2 n2, *spatial) as (n2, 2, *spatial)."""
    if isinstance(lanes, torch.Tensor):
        return lanes.reshape((lanes.shape[0] // 2, 2) + tuple(lanes.shape[1:]))
    if lanes.z_axis != 1 or lanes.q_loc % 2:
        raise ValueError("a pair view takes a block of whole (re, im) lane pairs")
    parts = [[pair_view(t) for t in row] for row in lanes.parts]
    return ShardedBlock(lanes.mesh, parts, lanes.one_lane, z_axis=2)


def lane_view(pairs):
    """The inverse of ``pair_view``: every slot's pairs as 2 n2_loc lanes."""
    if isinstance(pairs, torch.Tensor):
        return pairs.reshape((2 * pairs.shape[0],) + tuple(pairs.shape[2:]))
    if pairs.z_axis != 2:
        raise ValueError("a lane view takes a pair block")
    parts = [[lane_view(t) for t in row] for row in pairs.parts]
    return ShardedBlock(pairs.mesh, parts, pairs.one_lane)


def scatter_pairs(Z: torch.Tensor, mesh: SlotMesh, kind: str | None = "state") -> ShardedBlock:
    """Split a whole pair block (n2, 2, *spatial) over the mesh: the pairs
    over the stage rows (pair j on row j when the stage axis is n2), both
    components of a pair on one row, the z axis over the space slots."""
    return pair_view(scatter(lane_view(Z), mesh, kind))


def pair_component(pairs, c: int):
    """Component c (0: re, 1: im) of a pair block or of a plain (n2, 2,
    *spatial) tensor, one lane per pair (views)."""
    if isinstance(pairs, torch.Tensor):
        return pairs[:, c]
    return ShardedBlock(pairs.mesh, [[t[:, c] for t in row] for row in pairs.parts],
                        pairs.one_lane)


def stack_pairs(re, im):
    """The pair block of two one-lane-per-pair blocks (or plain tensors)."""
    if isinstance(re, torch.Tensor):
        return torch.stack([re, im], dim=1)
    parts = [[stack_pairs(a, b) for a, b in zip(ra, rb)] for ra, rb in zip(re.parts, im.parts)]
    return ShardedBlock(re.mesh, parts, re.one_lane, z_axis=2)
