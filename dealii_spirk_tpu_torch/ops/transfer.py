"""Grid-transfer operators for geometric multigrid.

Port of ``dealii_spirk_tpu/ops/transfer.py``: the dim-dimensional
prolongation is the Kronecker product of the 1D interpolation matrix with
itself, applied axis by axis; restriction is its transpose.  Leading axes
(stages) are batch.  Results are contiguous, as the CUDA kernels that
consume them require.
"""

from __future__ import annotations

import torch

from .banded import apply_dense_1d


def _spatial_axes(u_ndim: int, dim: int) -> tuple[int, ...]:
    return tuple(range(u_ndim - dim, u_ndim))


def prolong(P: torch.Tensor, u_coarse: torch.Tensor, dim: int) -> torch.Tensor:
    """Interpolate coarse -> fine: apply P (m_f, m_c) along each axis."""
    u = u_coarse
    for ax in _spatial_axes(u.ndim, dim):
        u = apply_dense_1d(P, u, ax)
    return u.contiguous()


def restrict(P: torch.Tensor, u_fine: torch.Tensor, dim: int) -> torch.Tensor:
    """Residual transfer fine -> coarse: apply P^T along each axis."""
    u = u_fine
    for ax in _spatial_axes(u.ndim, dim):
        u = apply_dense_1d(P.T, u, ax)
    return u.contiguous()
