"""The a*M + b*K operator family on the tensor-product grid, plain torch.

Port of ``dealii_spirk_tpu/ops/mass_laplace.py`` in its "stencil"
(MatrixFree) mode: banded roll-and-scale sweeps along each spatial axis,
with the same shared 1D intermediates and operation order as the JAX
package.  The "dense" (MatrixBased) mode is not ported yet.  The
hand-written CUDA kernels of the main path live in ``ops/cuda/stencil.py``;
this module is the plain torch path they are checked against.

Parity with the reference's L3 layer:

* ``apply_shifted``     <-> ``MassLaplaceOperator::vmult(dst, src, a, b)``
  (reference ``operator.h:15-100``)
* ``operator_diagonal`` <-> ``compute_inverse_diagonal`` (reference
  ``operator.h:311-329``) — exact, via Kronecker structure.
* ``*_batched`` <-> the reference's ``BatchedMassLaplaceOperator``
  (``operator.h:701-881``): a leading stage axis with per-stage shifts.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from ..fem.grid import Level1D
from .banded import apply_band


@dataclass(frozen=True)
class LevelOps:
    """Device-resident 1D operator data for one grid level."""

    mass_band: torch.Tensor  # (2p+1, m)
    stiff_band: torch.Tensor  # (2p+1, m)
    mass_diag: torch.Tensor  # (m,)
    stiff_diag: torch.Tensor  # (m,)
    # One z slab of a 3D level split over the space axis of a mesh
    # (``slab_ops``): its first global plane, and the band rows of its haloed
    # planes (2p+1, nzl + 2p), which the plain operators take along z.  None
    # on a whole level.
    z_off: int = 0
    z_mass_band: torch.Tensor | None = None
    z_stiff_band: torch.Tensor | None = None
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


def level_ops(level: Level1D, dtype=torch.float64, device="cpu") -> LevelOps:
    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device).contiguous()

    return LevelOps(
        mass_band=t(level.mass_band),
        stiff_band=t(level.stiff_band),
        mass_diag=t(level.mass_diag),
        stiff_diag=t(level.stiff_diag),
    )


def slab_ops(ops: LevelOps, z_off: int, nzl: int, device=None) -> LevelOps:
    """``ops`` for the slab of planes ``z_off .. z_off + nzl`` with a p-plane
    halo on either side, on ``device``: haloed plane j is global plane
    ``z_off - p + j`` and takes that row of the bands (zero weights where it
    lies outside the domain; a halo plane's own output is dropped)."""
    p, m = ops.p, ops.m
    device = ops.mass_band.device if device is None else device
    rows = torch.arange(z_off - p, z_off + nzl + p)
    inside = (rows >= 0) & (rows < m)
    rows = rows.clamp(0, m - 1).to(ops.mass_band.device)
    inside = inside.to(ops.mass_band.device)

    def cut(band):
        return (band[:, rows] * inside).to(device).contiguous()

    return LevelOps(
        mass_band=ops.mass_band.to(device),
        stiff_band=ops.stiff_band.to(device),
        mass_diag=ops.mass_diag.to(device),
        stiff_diag=ops.stiff_diag.to(device),
        z_off=z_off,
        z_mass_band=cut(ops.mass_band),
        z_stiff_band=cut(ops.stiff_band),
    )


def _spatial_axes(u_ndim: int, dim: int) -> tuple[int, ...]:
    return tuple(range(u_ndim - dim, u_ndim))


def _band(whole, z_slab, u, axis: int):
    # a slab's z axis (3D, third from last) takes its own band rows
    return whole if z_slab is None or axis % u.ndim != u.ndim - 3 else z_slab


def _m(ops: LevelOps, u, axis: int):
    return apply_band(_band(ops.mass_band, ops.z_mass_band, u, axis), u, axis)


def _k(ops: LevelOps, u, axis: int):
    return apply_band(_band(ops.stiff_band, ops.z_stiff_band, u, axis), u, axis)


def apply_mass(ops: LevelOps, u: torch.Tensor, dim: int) -> torch.Tensor:
    """M u = (M1 (x) ... (x) M1) u; leading axes of ``u`` are batch."""
    for ax in _spatial_axes(u.ndim, dim):
        u = _m(ops, u, ax)
    return u


def apply_stiffness(ops: LevelOps, u: torch.Tensor, dim: int) -> torch.Tensor:
    """K u with K = sum_k M1 (x) .. K1(axis k) .. (x) M1."""
    axes = _spatial_axes(u.ndim, dim)
    out = None
    for k_ax in axes:
        term = _k(ops, u, k_ax)
        for ax in axes:
            if ax != k_ax:
                term = _m(ops, term, ax)
        out = term if out is None else out + term
    return out


def apply_shifted(ops: LevelOps, a, b, u: torch.Tensor, dim: int) -> torch.Tensor:
    """(a M + b K) u with shared 1D intermediates (4 applies in 2D, 7 in
    3D).  ``a`` and ``b`` are scalars or tensors that broadcast against
    ``u`` (``apply_shifted_batched`` passes per-stage ``a``)."""
    axes = _spatial_axes(u.ndim, dim)
    if dim == 2:
        ax_x, ax_y = axes
        A = _m(ops, u, ax_y)
        B = _k(ops, u, ax_y)
        out = _m(ops, a * A + b * B, ax_x)
        return out + b * _k(ops, A, ax_x)
    if dim == 3:
        ax_x, ax_y, ax_z = axes
        A = _m(ops, u, ax_z)
        B = _k(ops, u, ax_z)
        C = _m(ops, A, ax_y)
        D = _k(ops, A, ax_y)
        E = _m(ops, B, ax_y)
        out = _m(ops, a * C + b * (D + E), ax_x)
        return out + b * _k(ops, C, ax_x)
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
