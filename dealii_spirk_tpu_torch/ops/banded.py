"""1D banded / dense operator applications along an axis of a tensor.

Port of ``dealii_spirk_tpu/ops/banded.py``.  The banded form computes
``out = sum_k w_k * roll(u, -k, axis)`` with ``w_k[i] = Op[i, i+k]``
(``band[p + k, i]``).  Band weights are zero for every coupling that
leaves the domain, so the entries ``roll`` wraps around are multiplied by
zero — the same operation order as the JAX package, so f64 results agree
to round-off.
"""

from __future__ import annotations

import torch


def _wshape(ndim: int, axis: int, m: int) -> tuple[int, ...]:
    shape = [1] * ndim
    shape[axis] = m
    return tuple(shape)


def apply_band(band: torch.Tensor, u: torch.Tensor, axis: int) -> torch.Tensor:
    """Apply a banded 1D operator along ``axis`` of ``u``.

    ``band`` has shape ``(2p+1, m)`` with ``band[p+k, i] = Op[i, i+k]``.
    """
    p = (band.shape[0] - 1) // 2
    m = band.shape[1]
    axis = axis % u.ndim
    shape = _wshape(u.ndim, axis, m)
    out = band[p].reshape(shape) * u
    for k in range(1, p + 1):
        out = out + band[p + k].reshape(shape) * torch.roll(u, -k, axis)
        out = out + band[p - k].reshape(shape) * torch.roll(u, k, axis)
    return out


def apply_dense_1d(mat: torch.Tensor, u: torch.Tensor, axis: int) -> torch.Tensor:
    """Apply a dense 1D operator ``mat`` (n_out, n_in) along ``axis``."""
    axis = axis % u.ndim
    out = torch.tensordot(mat, u, dims=([1], [axis]))
    return torch.movedim(out, 0, axis)
