"""The main path's four hand-written Hopper kernels, with their plain
torch versions and launch counters.

Each public wrapper dispatches on where its tensors lie: on the CPU it
runs the plain version (``*_ref``, which the CPU tests hold against the
JAX package); on a CUDA device it checks dtype (f32), shape and
contiguity, allocates its outputs with ``torch.empty``, launches the CUDA
kernel (``csrc/``, built by ``build.py``) on the current stream, raises if
the launch is refused, and adds one to its count in ``LAUNCHES``.  There
is no fallback from the kernel to the plain version.

Fields are compact stage blocks ``(q, m, m, m)`` (3D), x fastest — the
JAX package's canonical padding (y to 8, x to 128) is a TPU tiling and is
not needed here: the kernels mask the ragged edge instead.

All four are bound by device memory at p=1 on the H100 (3.35 TB/s
against 67 TFLOP/s f32): each moves 2 to 7 field passes of 4 bytes per
point against under 100 flops per point.  The simple design keeps every
1D intermediate in shared memory so each kernel reads each input about
once from DRAM (halo re-reads come mostly from L2) and writes each output
once.

==  =====================  =================================================
K   wrapper                replaces (dealii_spirk_tpu/ops/pallas/stencil.py)
==  =====================  =================================================
K1  ``ms_mix_apply``       ``fused_ms_mix_apply_canon`` (outer vmult)
K2  ``stage_mix``          ``stage_mix_canon`` (T / T^-1 basis changes)
K3  ``cheb_iter``          ``fused_cheb_iter_canon`` (Chebyshev step)
K4  ``stencil_apply``      ``fused_stencil_apply_canon`` ((a M + b K) u)
==  =====================  =================================================
"""

from __future__ import annotations

import torch

from ..mass_laplace import (
    LevelOps,
    apply_mass_stiffness_batched,
    apply_shifted_batched,
    per_stage,
)

QMAX = 8  # most stages the stage-coupled kernels hold (csrc/common.cuh)

LAUNCHES = {"ms_mix_apply": 0, "stage_mix": 0, "cheb_iter": 0, "stencil_apply": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain torch versions
# ---------------------------------------------------------------------------


def stencil_apply_ref(ops: LevelOps, a, b, u: torch.Tensor) -> torch.Tensor:
    """(a_i M + b K) u_i per stage."""
    return apply_shifted_batched(ops, a, b, u, u.ndim - 1)


def cheb_iter_ref(ops: LevelOps, a, b, c1, c2, d, r, x, invd):
    """r' = r - (a_i M + b K) d; d' = c1_i d + c2_i invd r'; x' = x + d'."""
    r_new = r - stencil_apply_ref(ops, a, b, d)
    d_new = per_stage(c1, d) * d + per_stage(c2, d) * (invd * r_new)
    return r_new, d_new, x + d_new


def stage_mix_ref(mat: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """out_i = sum_j mat[i, j] W_j as a reshaped GEMM."""
    out = mat @ W.reshape(W.shape[0], -1)
    return out.reshape((mat.shape[0],) + W.shape[1:])


def ms_mix_apply_ref(ops: LevelOps, Ainv: torch.Tensor, tau, u: torch.Tensor):
    """out_i = sum_j Ainv[i, j] (M u_j) + tau (K u_i)."""
    MW, KW = apply_mass_stiffness_batched(ops, u, u.ndim - 1)
    return stage_mix_ref(Ainv, MW) + tau * KW


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _on_cpu(*ts: torch.Tensor) -> bool:
    kinds = {t.device.type for t in ts}
    if kinds == {"cpu"}:
        return True
    if kinds != {"cuda"}:
        raise ValueError(f"tensors must all lie on the CPU or all on CUDA: {kinds}")
    return False


def _check_field(t: torch.Tensor, shape: tuple, name: str) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernels take float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_block(ops: LevelOps, u: torch.Tensor, name: str) -> tuple[int, int, int]:
    if u.ndim != 4:
        raise ValueError(f"{name}: the CUDA kernels take 3D stage blocks (q, m, m, m)")
    q, m = u.shape[0], ops.m
    _check_field(u, (q, m, m, m), name)
    for band in (ops.mass_band, ops.stiff_band):
        _check_field(band, tuple(band.shape), "band table")
        if band.device != u.device:
            raise ValueError("band tables and fields must share a device")
    if not 1 <= ops.p <= 4:
        raise ValueError(f"the CUDA kernels take degrees 1-4, got p={ops.p}")
    return q, m, ops.p


def _coefs(q: int, device, *cols) -> torch.Tensor:
    """(q, len(cols)) f32 table of per-stage coefficients, built on the
    device (no host round trip): each column is a Python scalar, a 0-d or
    a (q,) tensor."""
    out = []
    for c in cols:
        if isinstance(c, torch.Tensor):
            out.append(c.to(device=device, dtype=torch.float32).expand(q))
        else:
            out.append(torch.full((q,), float(c), dtype=torch.float32, device=device))
    return torch.stack(out, dim=1).contiguous()


def _launch(name: str, *args) -> None:
    from .build import load_library

    lib = load_library()
    stream = torch.cuda.current_stream().cuda_stream
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    err = getattr(lib, name)(*conv, stream)
    if err != 0:
        msg = lib.spirk_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def stencil_apply(ops: LevelOps, a, b, u: torch.Tensor) -> torch.Tensor:
    """K4: (a_i M + b K) u_i per stage; ``a`` scalar or (q,), ``b`` scalar."""
    if _on_cpu(u, ops.mass_band):
        return stencil_apply_ref(ops, a, b, u)
    q, m, p = _check_block(ops, u, "u")
    out = torch.empty_like(u)
    w = _coefs(q, u.device, a, b)
    _launch("spirk_stencil_apply", u, out, ops.mass_band, ops.stiff_band, w, q, m, p)
    LAUNCHES["stencil_apply"] += 1
    return out


def cheb_iter(ops: LevelOps, a, b, c1, c2, d, r, x, invd):
    """K3: one Chebyshev step, returns new tensors (r', d', x'); the
    inputs are left unchanged (none is updated in place)."""
    if _on_cpu(d, r, x, invd, ops.mass_band):
        return cheb_iter_ref(ops, a, b, c1, c2, d, r, x, invd)
    q, m, p = _check_block(ops, d, "d")
    for t, name in ((r, "r"), (x, "x"), (invd, "invd")):
        _check_field(t, d.shape, name)
    r_out, d_out, x_out = (torch.empty_like(d) for _ in range(3))
    w = _coefs(q, d.device, a, b, c1, c2)
    _launch(
        "spirk_cheb_iter", d, r, x, invd, r_out, d_out, x_out,
        ops.mass_band, ops.stiff_band, w, q, m, p,
    )
    LAUNCHES["cheb_iter"] += 1
    return r_out, d_out, x_out


def ms_mix_apply(ops: LevelOps, Ainv: torch.Tensor, tau, u: torch.Tensor) -> torch.Tensor:
    """K1: out_i = sum_j Ainv[i, j] (M u_j) + tau (K u_i); q <= 8."""
    if _on_cpu(u, Ainv, ops.mass_band):
        return ms_mix_apply_ref(ops, Ainv, tau, u)
    q, m, p = _check_block(ops, u, "u")
    if q > QMAX or tuple(Ainv.shape) != (q, q):
        raise ValueError(f"ms_mix_apply takes q <= {QMAX} and a (q, q) Ainv")
    tau_row = torch.full((1, q), float(tau), dtype=torch.float32, device=u.device)
    mw = torch.cat([Ainv.to(torch.float32), tau_row], dim=0).contiguous()
    out = torch.empty_like(u)
    _launch("spirk_ms_mix_apply", u, out, ops.mass_band, ops.stiff_band, mw, q, m, p)
    LAUNCHES["ms_mix_apply"] += 1
    return out


def stage_mix(mat: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """K2: out_i = sum_j mat[i, j] W_j; ``out`` never aliases ``W``."""
    if _on_cpu(W, mat):
        return stage_mix_ref(mat, W)
    qo, qi = mat.shape
    if W.shape[0] != qi or max(qo, qi) > QMAX:
        raise ValueError(f"stage_mix takes (q_out, q_in) <= {QMAX} matching W")
    _check_field(W, tuple(W.shape), "W")
    n = W[0].numel()
    out = torch.empty((qo,) + tuple(W.shape[1:]), dtype=W.dtype, device=W.device)
    mat32 = mat.to(torch.float32).contiguous()
    _launch("spirk_stage_mix", W, out, mat32, qo, qi, n)
    LAUNCHES["stage_mix"] += 1
    return out
