"""The a*M + b*K operator family on the tensor-product grid, plain torch.

Port of ``dealii_spirk_tpu/ops/mass_laplace.py``: the same shared 1D
intermediates and operation order as the JAX package, each 1D apply along
an axis by one of two routes (``LevelOps.mode``):

* ``"stencil"`` (MatrixFree): banded roll-and-scale sweeps
  (``apply_band``);
* ``"dense"`` (MatrixBased): a dense 1D contraction (``apply_dense_1d``)
  with the level's (m, m) ``mass_dense`` / ``stiff_dense``, as the JAX
  package contracts with XLA's dot.  It runs no CUDA kernel there or here.

Both give the same result.  A level takes the dense route where it carries
its dense matrices (``level_ops(..., with_dense=True)``, which a
MatrixBased scheme builds), else the banded one.  The hand-written CUDA kernels of MatrixFree live in
``ops/cuda/stencil.py``; this module is the plain torch path they are
checked against.

Parity with the reference's L3 layer:

* ``apply_shifted``     <-> ``MassLaplaceOperator::vmult(dst, src, a, b)``
  (reference ``operator.h:15-100``)
* ``operator_diagonal`` <-> ``compute_inverse_diagonal`` (reference
  ``operator.h:311-329``) — exact, via Kronecker structure.
* ``apply_complex`` <-> ``ComplexMassLaplaceOperatorMatrixFree::vmult``
  (reference ``operator.h:593-666``), acting on a (re, im) pair block.
* ``*_batched`` <-> the reference's ``BatchedMassLaplaceOperator``
  (``operator.h:701-881``): a leading stage axis with per-stage shifts.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields, replace

import torch

from ..fem.grid import Level1D
from .banded import apply_band, apply_dense_1d


@dataclass(frozen=True)
class LevelOps:
    """Device-resident 1D operator data for one grid level."""

    mass_band: torch.Tensor  # (2p+1, m)
    stiff_band: torch.Tensor  # (2p+1, m)
    mass_diag: torch.Tensor  # (m,)
    stiff_diag: torch.Tensor  # (m,)
    # the dense 1D matrices (m, m) of the MatrixBased route; None without it
    mass_dense: torch.Tensor | None = None
    stiff_dense: torch.Tensor | None = None
    # One z slab of a 3D level split over the space axis of a mesh
    # (``slab_ops``): its first global plane, and the band rows of its haloed
    # planes (2p+1, nzl + 2p), which the plain operators take along z, and
    # with the dense route the dense blocks (nzl + 2p, nzl + 2p) of those
    # planes.  None on a whole level.
    z_off: int = 0
    z_mass_band: torch.Tensor | None = None
    z_stiff_band: torch.Tensor | None = None
    z_mass_dense: torch.Tensor | None = None
    z_stiff_dense: torch.Tensor | None = None
    # whether the CUDA kernels take these bands (f32, contiguous, on one
    # device, degree 1-4): checked once here, read by the kernel wrappers
    kernel_bands: bool = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        bands = (self.mass_band, self.stiff_band)
        ok = (all(b.dtype == torch.float32 and b.is_contiguous() for b in bands)
              and self.stiff_band.device == self.mass_band.device and 1 <= self.p <= 4)
        object.__setattr__(self, "kernel_bands", ok)

    @property
    def m(self) -> int:
        return self.mass_band.shape[1]

    @property
    def p(self) -> int:
        return (self.mass_band.shape[0] - 1) // 2

    @property
    def mode(self) -> str:
        """The route of the 1D applies: "dense" where the level carries its
        dense matrices, else "stencil"."""
        return "stencil" if self.mass_dense is None else "dense"

    def to(self, device) -> LevelOps:
        """These operators with every tensor on ``device``."""
        return replace(self, **{
            f.name: getattr(self, f.name).to(device) for f in fields(self)
            if f.init and isinstance(getattr(self, f.name), torch.Tensor)
        })


def level_ops(level: Level1D, dtype=torch.float64, device="cpu",
              with_dense: bool = False) -> LevelOps:
    """The level's operators on ``device``; ``with_dense``: with its dense
    1D matrices too (the MatrixBased route)."""
    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device).contiguous()

    return LevelOps(
        mass_band=t(level.mass_band),
        stiff_band=t(level.stiff_band),
        mass_diag=t(level.mass_diag),
        stiff_diag=t(level.stiff_diag),
        mass_dense=t(level.mass_dense) if with_dense else None,
        stiff_dense=t(level.stiff_dense) if with_dense else None,
    )


def slab_ops(ops: LevelOps, z_off: int, nzl: int, device=None) -> LevelOps:
    """``ops`` for the slab of planes ``z_off .. z_off + nzl`` with a p-plane
    halo on either side, on ``device``: haloed plane j is global plane
    ``z_off - p + j`` and takes that row of the bands (zero weights where it
    lies outside the domain; a halo plane's own output is dropped).  A
    level with the dense route takes the dense block of the haloed planes
    along z (zero rows and columns outside the domain): an own plane's row
    holds all its 2p + 1 couplings, since the bandwidth is p."""
    p, m = ops.p, ops.m
    device = ops.mass_band.device if device is None else device
    rows = torch.arange(z_off - p, z_off + nzl + p)
    inside = (rows >= 0) & (rows < m)
    rows = rows.clamp(0, m - 1).to(ops.mass_band.device)
    inside = inside.to(ops.mass_band.device)

    def cut(band):
        return (band[:, rows] * inside).to(device).contiguous()

    def block(mat):
        if mat is None:
            return None
        keep = inside[:, None] & inside[None, :]
        return (mat[rows][:, rows] * keep).to(device).contiguous()

    return replace(
        ops.to(device),
        z_off=z_off,
        z_mass_band=cut(ops.mass_band),
        z_stiff_band=cut(ops.stiff_band),
        z_mass_dense=block(ops.mass_dense),
        z_stiff_dense=block(ops.stiff_dense),
    )


def _spatial_axes(u_ndim: int, dim: int) -> tuple[int, ...]:
    return tuple(range(u_ndim - dim, u_ndim))


def _slab(whole, z_slab, u, axis: int):
    # a slab's z axis (3D, third from last) takes its own band rows / block
    return whole if z_slab is None or axis % u.ndim != u.ndim - 3 else z_slab


def _apply_1d(ops: LevelOps, which: str, u, axis: int):
    """M1 (``which`` "m") or K1 ("k") along ``axis`` by the level's route."""
    mass = which == "m"
    if ops.mode == "dense":
        mat = _slab(ops.mass_dense if mass else ops.stiff_dense,
                    ops.z_mass_dense if mass else ops.z_stiff_dense, u, axis)
        return apply_dense_1d(mat, u, axis)
    band = _slab(ops.mass_band if mass else ops.stiff_band,
                 ops.z_mass_band if mass else ops.z_stiff_band, u, axis)
    return apply_band(band, u, axis)


def apply_mass(ops: LevelOps, u: torch.Tensor, dim: int) -> torch.Tensor:
    """M u = (M1 (x) ... (x) M1) u; leading axes of ``u`` are batch."""
    for ax in _spatial_axes(u.ndim, dim):
        u = _apply_1d(ops, "m", u, ax)
    return u


def apply_stiffness(ops: LevelOps, u: torch.Tensor, dim: int) -> torch.Tensor:
    """K u with K = sum_k M1 (x) .. K1(axis k) .. (x) M1."""
    axes = _spatial_axes(u.ndim, dim)
    out = None
    for k_ax in axes:
        term = _apply_1d(ops, "k", u, k_ax)
        for ax in axes:
            if ax != k_ax:
                term = _apply_1d(ops, "m", term, ax)
        out = term if out is None else out + term
    return out


def apply_shifted(ops: LevelOps, a, b, u: torch.Tensor, dim: int) -> torch.Tensor:
    """(a M + b K) u with shared 1D intermediates (4 applies in 2D, 7 in
    3D).  ``a`` and ``b`` are scalars or tensors that broadcast against
    ``u`` (``apply_shifted_batched`` passes per-stage ``a``)."""
    axes = _spatial_axes(u.ndim, dim)

    def m(t, ax):
        return _apply_1d(ops, "m", t, ax)

    def k(t, ax):
        return _apply_1d(ops, "k", t, ax)

    if dim == 2:
        ax_x, ax_y = axes
        A = m(u, ax_y)
        B = k(u, ax_y)
        out = m(a * A + b * B, ax_x)
        return out + b * k(A, ax_x)
    if dim == 3:
        ax_x, ax_y, ax_z = axes
        A = m(u, ax_z)
        B = k(u, ax_z)
        C = m(A, ax_y)
        D = k(A, ax_y)
        E = m(B, ax_y)
        out = m(a * C + b * (D + E), ax_x)
        return out + b * k(C, ax_x)
    raise ValueError("dim must be 2 or 3")


def per_stage(s, W: torch.Tensor):
    """A scalar, or a per-stage vector (q,) shaped to broadcast over the
    stage block W (q, ...)."""
    s = torch.as_tensor(s, dtype=W.dtype, device=W.device)
    if s.ndim == 0:
        return s
    return s.reshape(s.shape + (1,) * (W.ndim - 1))


def apply_mass_stiffness_batched(ops: LevelOps, W: torch.Tensor, dim: int):
    """(M W, K W) over a stage block — the two ingredients of the outer
    system vmult (reference "do_reduce_number_of_vmults",
    ``main.cc:1014-1028``).  Leading axes are batch in every apply here."""
    return apply_mass(ops, W, dim), apply_stiffness(ops, W, dim)


def apply_shifted_batched(ops: LevelOps, a_vec, b, W: torch.Tensor, dim: int) -> torch.Tensor:
    """Per-stage (a_i M + b K) W_i — the reference's batched operator
    (``operator.h:701-881``).  ``a_vec``: (q,), ``W``: (q, *spatial)."""
    return apply_shifted(ops, per_stage(a_vec, W), b, W, dim)


def apply_complex(ops: LevelOps, d_re, d_im, tau, z: torch.Tensor, dim: int) -> torch.Tensor:
    """2x2 real-block form of ((d_re + i d_im) M + tau K) on z = (re, im),
    ``z`` of shape (2, *spatial) (the fused complex cell loop, reference
    ``operator.h:616-660``):

        out_re = d_re M re - d_im M im + tau K re
        out_im = d_im M re + d_re M im + tau K im
    """
    s = apply_shifted(ops, d_re, tau, z, dim)  # batch over (re, im)
    mz = apply_mass(ops, z, dim)
    return s + torch.stack([-d_im * mz[1], d_im * mz[0]])


def operator_diagonal(ops: LevelOps, a, b, dim: int) -> torch.Tensor:
    """Exact diagonal of a*M + b*K from the 1D diagonals (replaces
    ``MatrixFreeTools::compute_diagonal``, reference
    ``operator.h:311-329``).  A (q,) ``a`` gives a (q, *spatial) block."""
    dm, dk = ops.mass_diag, ops.stiff_diag
    if dim == 2:
        mass_d = dm[:, None] * dm[None, :]
        stiff_d = dk[:, None] * dm[None, :] + dm[:, None] * dk[None, :]
    elif dim == 3:
        mass_d = dm[:, None, None] * dm[None, :, None] * dm[None, None, :]
        stiff_d = (
            dk[:, None, None] * dm[None, :, None] * dm[None, None, :]
            + dm[:, None, None] * dk[None, :, None] * dm[None, None, :]
            + dm[:, None, None] * dm[None, :, None] * dk[None, None, :]
        )
    else:
        raise ValueError("dim must be 2 or 3")
    a = torch.as_tensor(a, dtype=mass_d.dtype, device=mass_d.device)
    if a.ndim == 1:
        a = a.reshape((-1,) + (1,) * dim)
    return a * mass_d + b * stiff_d
