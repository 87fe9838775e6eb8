"""K10: the V-cycle's grid transfers on the card, with their plain versions
and the row-run form of the 1D prolongation that the kernels read.

A level pair of the (geometric or algebraic) hierarchy moves fields with
the Kronecker product of its 1D prolongation P (m_f, m_c): restriction
applies P^T along each axis, prolongation P.  The plain versions
(``ops/transfer.py``) contract P as a dense matrix axis by axis, as the JAX
package leaves it to XLA's dense dot (``dealii_spirk_tpu/ops/banded.py::
apply_dense_1d``); no Pallas kernel exists, so K10 replaces no TPU kernel.
Every row of P holds one run of at most p + 1 nonzeros (P^T: 4p - 1;
AMG's aggregation 1 and 2), so on the card each transfer is one launch of
``csrc/transfer.cu`` over P's ``row_runs`` form, with the V-cycle's glue
fused in:

* ``restrict_residual(t, rl, ax)``: (P^T (x) P^T (x) P^T)(rl_i - ax_i) per
  lane, the residual formed as the fine values are loaded (LAUNCHES key
  ``transfer_restrict``);
* ``prolong_add(t, x, xc)``: x_i + (P (x) P (x) P) xc_i per lane, written
  once (``transfer_prolong``).

Both kernels sum in the plain versions' order (z, then y, then x, each
sum in ascending order): where cuBLAS sums each column in that order too
(every restriction, and every prolongation but the smallest pairs', where
it picks its small-matrix and split-K kernels) they equal the plain
versions bit for bit.

``transfer_runs`` decides once per level pair, when a hierarchy is built
(``solvers/gmg.py::GMGData``), whether the kernels take its P: run widths
within the instantiated ones, a block's tile spans within its shared
memory and the ring of TRANSFER_RING planes never reused too early.  On CPU
tensors the wrappers run their plain versions; on CUDA they launch, or
raise where the pair's P does not fit (no hierarchy of the port builds
one), as ``stencil.py``'s do.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..transfer import prolong, restrict
from .stencil import LAUNCHES, SMS, _check_field, _launch_raw, _on_cpu

# the run widths csrc/transfer.cu instantiates: P^T's rows (4p - 1 at degree
# p; AMG's 2 padded to 3) and P's (p + 1; AMG's 1 padded to 2)
RESTRICT_WIDTHS = (3, 7, 11, 15)
PROLONG_WIDTHS = (2, 3, 4, 5)
# a block's output tile (rows, columns): restriction coarse (csrc RTY, RTX),
# prolongation fine (PTY, PTX); and the most rows and columns of the other
# grid it reads (RFY, RFX fine; PCY, PCX coarse)
RESTRICT_TILE, RESTRICT_SPAN = (16, 32), (42, 80)
PROLONG_TILE, PROLONG_SPAN = (16, 64), (16, 40)
# planes in a block's ring (csrc TRING): restriction's open coarse sums,
# prolongation's coarse planes
TRANSFER_RING = 6
# resident blocks per SM (csrc __launch_bounds__) and the most planes a
# block marches
RESIDENT = {"restrict": 2, "prolong": 4}
TRANSFER_MAX_CHUNK = 64


@dataclass(frozen=True)
class TransferRuns:
    """A level pair's P as the plain versions read it (dense, (m_f, m_c))
    and in the kernels' row-run form: row r of P holds its nonzeros in
    columns ``start[r] .. start[r] + width - 1`` with the weights
    ``weights[r]`` (zeros past the run); ``start_t``, ``weights_t`` the same
    for P^T.  The tables are None where the kernels do not take P."""

    P: torch.Tensor
    start: torch.Tensor | None = None  # (m_f,) int32
    weights: torch.Tensor | None = None  # (m_f, width)
    start_t: torch.Tensor | None = None  # (m_c,) int32
    weights_t: torch.Tensor | None = None  # (m_c, width_t)

    @property
    def fits(self) -> bool:
        return self.start is not None


def row_runs(A: np.ndarray, widths: tuple[int, ...]):
    """(start, weights) of A's rows, each row's run from its first nonzero,
    padded to the smallest of ``widths`` that holds every row's run; None
    where none does.  Rebuilds A exactly: A[r, start[r] + k] = weights[r, k]
    for the columns inside A."""
    nz = A != 0
    rows, cols = A.shape
    first = np.where(nz.any(axis=1), nz.argmax(axis=1), 0)
    last = np.where(nz.any(axis=1), cols - 1 - nz[:, ::-1].argmax(axis=1), 0)
    need = int((last - first + 1).max())
    width = next((w for w in widths if w >= need), None)
    if width is None:
        return None
    idx = first[:, None] + np.arange(width)
    inside = idx < cols
    weights = np.where(inside, A[np.arange(rows)[:, None], np.minimum(idx, cols - 1)], 0.0)
    return first.astype(np.int32), weights


def _spans(start: np.ndarray, width: int, tile: int) -> int:
    """The most rows of the other grid that a tile of ``tile`` consecutive
    rows reads: max(start + width) - min(start) per tile."""
    return max(int((start[i:i + tile] + width).max() - start[i:i + tile].min())
               for i in range(0, len(start), tile))


def _last(start: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """Each row's last nonzero column (runs start at their first)."""
    return start + weights.shape[1] - 1 - np.argmax(weights[:, ::-1] != 0, axis=1)


def kernel_fits(start: np.ndarray, weights: np.ndarray, start_t: np.ndarray,
                weights_t: np.ndarray, m_c: int) -> bool:
    """Whether csrc/transfer.cu takes this row-run form: every tile's span
    within its block's shared memory, and the ring of TRANSFER_RING planes
    safe.  Restriction: coarse plane J's sum closes at its last nonzero tap
    before J + RING opens.  Prolongation (a block loads coarse plane a once
    the fine planes so far reach it with a nonzero tap, into the slot of a -
    RING): no fine plane from there on reads plane a - RING."""
    width, width_t = weights.shape[1], weights_t.shape[1]
    if _spans(start_t, width_t, RESTRICT_TILE[0]) > RESTRICT_SPAN[0]:
        return False
    if _spans(start_t, width_t, RESTRICT_TILE[1]) > RESTRICT_SPAN[1]:
        return False
    if _spans(start, width, PROLONG_TILE[0]) > PROLONG_SPAN[0]:
        return False
    if _spans(start, width, PROLONG_TILE[1]) > PROLONG_SPAN[1]:
        return False
    r = TRANSFER_RING
    if m_c > r and np.any(start_t[r:] <= _last(start_t, weights_t)[:-r]):
        return False
    need = np.maximum.accumulate(_last(start, weights) + 1)
    later = np.minimum.accumulate(start[::-1])[::-1]
    return bool(np.all(need - 1 - r < later))


def transfer_runs(P: torch.Tensor) -> TransferRuns:
    """P and its row-run forms on P's device, without the forms where the
    kernels do not take this P (``row_runs``, ``kernel_fits``).  Decided
    once per level pair, when a hierarchy is built."""
    A = P.detach().cpu().double().numpy()
    fwd, bwd = row_runs(A, PROLONG_WIDTHS), row_runs(A.T, RESTRICT_WIDTHS)
    if fwd is None or bwd is None:
        return TransferRuns(P=P)
    if not kernel_fits(fwd[0], fwd[1], bwd[0], bwd[1], A.shape[1]):
        return TransferRuns(P=P)

    def t(a, dtype):
        return torch.as_tensor(a, dtype=dtype, device=P.device).contiguous()

    return TransferRuns(P=P, start=t(fwd[0], torch.int32), weights=t(fwd[1], P.dtype),
                        start_t=t(bwd[0], torch.int32), weights_t=t(bwd[1], P.dtype))


@functools.lru_cache(maxsize=None)
def transfer_plan(kind: str, q: int, m_f: int, m_c: int) -> int:
    """The chunk of a K10 launch (``kind`` "restrict": coarse planes per
    block; "prolong": fine planes): the power of two up to
    TRANSFER_MAX_CHUNK that gives the busiest SM the least work, counted as
    its waves of RESIDENT blocks times the planes each block marches (a
    restriction block reads the fine planes of its coarse ones and about 8
    more; a prolongation block loads about half a coarse plane per fine
    plane, and 5 more); of equal ones the longest."""
    n = m_c if kind == "restrict" else m_f
    ty, tx = RESTRICT_TILE if kind == "restrict" else PROLONG_TILE
    tiles = -(-n // ty) * -(-n // tx) * q

    def cost(chunk: int) -> tuple:
        waves = -(-tiles * -(-n // chunk) // (SMS * RESIDENT[kind]))
        per_block = chunk * m_f / m_c + 8 if kind == "restrict" else 1.5 * chunk + 5
        return waves * per_block, -chunk

    cap = min(TRANSFER_MAX_CHUNK, 1 << (n - 1).bit_length())
    return min((2**k for k in range(cap.bit_length()) if 2**k <= cap), key=cost)


def restrict_residual_ref(P: torch.Tensor, rl: torch.Tensor, ax: torch.Tensor) -> torch.Tensor:
    """P^T along each spatial axis of rl - ax (the V-cycle's plain code)."""
    return restrict(P, rl - ax, rl.ndim - 1)


def prolong_add_ref(P: torch.Tensor, x: torch.Tensor, xc: torch.Tensor) -> torch.Tensor:
    """x + P along each spatial axis of xc (the V-cycle's plain code)."""
    return x + prolong(P, xc, x.ndim - 1)


def _check_pair(t: TransferRuns, fine: torch.Tensor, name: str) -> tuple[int, int, int]:
    """(q, m_f, m_c) of a launch on the 3D block ``fine`` (q, m_f, m_f, m_f)
    with ``t``'s run tables (f32, on the block's device)."""
    m_f, m_c = t.P.shape
    if not t.fits:
        raise ValueError(f"K10 does not take this {m_f} <- {m_c} pair's P (transfer_runs)")
    if fine.ndim != 4:
        raise ValueError(f"{name}: K10 takes 3D stage blocks (q, m, m, m)")
    _check_field(fine, (fine.shape[0],) + (m_f,) * 3, name)
    if t.weights.dtype != torch.float32 or t.weights.device != fine.device:
        raise ValueError("K10 takes f32 run tables on the fields' device")
    return fine.shape[0], m_f, m_c


def restrict_residual(t: TransferRuns, rl: torch.Tensor, ax: torch.Tensor) -> torch.Tensor:
    """K10's restriction: (P^T (x) P^T (x) P^T)(rl_i - ax_i) per lane, a new
    (q, m_c, m_c, m_c) block; 3D, one launch."""
    if _on_cpu(rl, ax, t.P):
        return restrict_residual_ref(t.P, rl, ax)
    q, m_f, m_c = _check_pair(t, rl, "rl")
    _check_field(ax, rl.shape, "ax")
    out = rl.new_empty((q, m_c, m_c, m_c))
    _launch_raw("spirk_transfer_restrict", rl.device, rl.data_ptr(), ax.data_ptr(),
                out.data_ptr(), t.start_t.data_ptr(), t.weights_t.data_ptr(), q, m_f, m_c,
                t.weights_t.shape[1], transfer_plan("restrict", q, m_f, m_c))
    LAUNCHES["transfer_restrict"] += 1
    return out


def prolong_add(t: TransferRuns, x: torch.Tensor, xc: torch.Tensor) -> torch.Tensor:
    """K10's prolongation: x_i + (P (x) P (x) P) xc_i per lane, a new
    (q, m_f, m_f, m_f) block; 3D, one launch."""
    if _on_cpu(x, xc, t.P):
        return prolong_add_ref(t.P, x, xc)
    q, m_f, m_c = _check_pair(t, x, "x")
    _check_field(xc, (q,) + (m_c,) * 3, "xc")
    out = torch.empty_like(x)
    _launch_raw("spirk_transfer_prolong", x.device, x.data_ptr(), xc.data_ptr(),
                out.data_ptr(), t.start.data_ptr(), t.weights.data_ptr(), q, m_f, m_c,
                t.weights.shape[1], transfer_plan("prolong", q, m_f, m_c))
    LAUNCHES["transfer_prolong"] += 1
    return out
