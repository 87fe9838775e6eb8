"""GMG microbenchmark — port of ``dealii_spirk_tpu/gmg_bench.py`` (the
reference's ``gmg`` executable, ``gmg.cc:56-427``): sweep refinement levels
and measure the cost of GMG-preconditioned CG on ``M + K`` four ways.

Reference modes (``gmg.cc:350-382``) and their realizations here; every
mode's CG runs on the stage-batched layout with a leading lane axis:

1. 1 scalar component                  -> ``scalar``: one lane
                                          (``pcg(batch=False)``)
2. FESystem with 8 components in 1 op  -> ``fesystem8``: ONE scalar
                                          preconditioner (one Chebyshev
                                          estimate, one coarse inverse:
                                          the FESystem operator has a
                                          single preconditioner), its
                                          fields expanded to the 8 lanes
3. 8 sub-communicators x 1 component   -> ``subgroups8``: the component
                                          axis on an (8, 1) slot mesh, one
                                          component per slot, all slots on
                                          the one device
4. batched 8-block op + block GMG      -> ``batched8``: per-component
                                          diagonals and estimates

With the kernels (``--op-mode kernels``: f32 on the card) the CG operator
is K4 (2D: K4-2D) and the V-cycle runs K3, K3dg (``cheb_diag_level``) and
K4; ``subgroups8`` runs the halo kernels K9a, K9c and K9d on the levels
that ``sharded_levels`` splits (3D only) and each slot's unsharded
V-cycle below them.

Reports time / iteration like ``gmg.cc:289-291``: one warm-up solve, then
10 timed solves to reduction 1e-12 (f32: 1e-5) under
ReductionControl(1000, 1e-20, 1e-12); on the card CUDA events around the
ten solves, on the CPU ``perf_counter``.  A mode that runs out of device
memory reports ``oom`` with the error's first line.

Usage: ``python -m dealii_spirk_tpu_torch.gmg_bench [--dim 2|3]
[--min-ref N] [--max-ref N] [--degree p] [--precision f32|f64]
[--modes a,b] [--op-mode auto|stencil|dense|kernels] [--device cuda|cpu]``
"""

from __future__ import annotations

import argparse
import json
import math
import time
from typing import NamedTuple

import numpy as np
import torch

from .fem.grid import make_space
from .ops.cuda import sharded as shk
from .ops.cuda import stencil as st
from .parallel.mesh import make_mesh
from .parallel.sharding import scatter
from .problem import require_device
from .solvers.gmg import GMGPrec, build_gmg_data, gmg_reinit, scatter_prec, threefry_uniform, vcycle
from .solvers.krylov import _dot, pcg
from .utils.table import ConvergenceTable

N_REPETITIONS = 10  # gmg.cc:213
N_COMPONENTS = 8  # gmg.cc:350-382
MAXITER = 1000  # ReductionControl(1000, 1e-20, 1e-12)
RHS_SEED = 7  # the JAX package's jax.random.PRNGKey(7)
# label: (components, one shared scalar preconditioner, on the slot mesh)
MODES = {
    "scalar": (1, False, False),
    "fesystem8": (N_COMPONENTS, True, False),
    "batched8": (N_COMPONENTS, False, False),
    "subgroups8": (N_COMPONENTS, False, True),
}


class BenchResult(NamedTuple):
    seconds: float  # per solve: the timed solves' mean, or the warm-up's alone
    iterations: int  # CG iterations, the most over the lanes
    true_residual: float  # max over the lanes of |rhs - A x| / |rhs| after the last solve


def reltol_of(dtype: torch.dtype) -> float:
    """gmg.cc's ReductionControl reduction 1e-12 lies below f32's
    resolution, so f32 solves reduce by 1e-5 (the JAX package's rule)."""
    return 1e-12 if dtype == torch.float64 else 1e-5


def normal_rhs(seed: int, shape: tuple[int, ...], dtype=torch.float64,
               device="cpu") -> torch.Tensor:
    """The JAX package's right-hand side ``jax.random.normal(PRNGKey(seed),
    shape, dtype)``, drawn on ``device``: JAX's uniform in
    ``(nextafter(-1, 0), 1)`` from the same Threefry bits
    (``threefry_uniform``), then ``sqrt(2) erfinv(u)`` with erfinv in f64,
    cast to ``dtype``."""
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    lo = np.nextafter(np_dt(-1), np_dt(0))
    u = threefry_uniform(seed, shape, dtype, device) * float(np_dt(1) - lo) + float(lo)
    u = torch.clamp_min(u, float(lo))
    return (math.sqrt(2) * torch.special.erfinv(u.double())).to(dtype)


def _shared(prec: GMGPrec, n: int) -> GMGPrec:
    """A one-lane preconditioner state as n equal lanes, contiguous (the
    kernels take contiguous fields)."""
    def lanes(t: torch.Tensor) -> torch.Tensor:
        return t.expand((n,) + tuple(t.shape[1:])).contiguous()

    return GMGPrec(
        inv_diags=tuple(map(lanes, prec.inv_diags)),
        thetas=tuple(map(lanes, prec.thetas)),
        deltas=tuple(map(lanes, prec.deltas)),
        coarse_inv=lanes(prec.coarse_inv),
    )


def _timed(fn, n: int, device: torch.device):
    """(fn's last result, seconds per call) over n calls: CUDA events on
    the card, ``perf_counter`` on the CPU."""
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end) / 1e3 / n
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn()
    return out, (time.perf_counter() - t0) / n


def prepare_mode(space, gmg, dim: int, label: str, dtype, *, kernels: bool, device,
                 rhs=None):
    """One benchmark mode (``MODES``) made ready to solve: the preconditioner
    state and the right-hand side (shape ``space.shape`` for ``scalar``,
    ``(8, *space.shape)`` otherwise; default ``normal_rhs(RHS_SEED)``, the
    JAX package's draw).  Returns ``(solve, true_residual)``: ``solve()``
    runs the CG solve, ``true_residual(res)`` is the most over the lanes of
    |rhs - A x| / |rhs| for its result (one more operator apply)."""
    device = torch.device(device)
    n_comp, shared, sharded = MODES[label]
    a, b = torch.ones(n_comp, dtype=dtype, device=device), 1.0  # gmg.cc: M + K
    shape = (n_comp,) + space.shape
    if rhs is None:
        rhs = normal_rhs(RHS_SEED, shape, dtype, device)
    else:
        rhs = torch.as_tensor(np.array(rhs), dtype=dtype, device=device).reshape(shape)
    if shared:
        prec = _shared(gmg_reinit(gmg, a[:1], b, dim), n_comp)
    else:
        prec = gmg_reinit(gmg, a, b, dim)
    fine = gmg.level_ops[-1]
    if sharded:
        mesh = make_mesh(n_comp, devices=[device] * n_comp)
        mprec = scatter_prec(gmg, prec, a, dim, mesh)
        level = shk.shard_level(fine, mesh, dim)
        rhs = scatter(rhs, mesh, kind=None)

        def A(w):
            return shk.sharded_stencil_apply(level, a, b, w, kernels=kernels)

        def M(r):
            return vcycle(gmg, mprec, a, b, r, dim, kernels=kernels, mesh=mesh)
    else:
        apply = st.stencil_apply if kernels else st.stencil_apply_ref

        def A(w):
            return apply(fine, a, b, w)

        def M(r):
            return vcycle(gmg, prec, a, b, r, dim, kernels=kernels)

    def solve():
        return pcg(A, rhs, M=M, maxiter=MAXITER, abstol=1e-20, reltol=reltol_of(dtype),
                   batch=n_comp > 1)

    def true_residual(res) -> float:
        r = rhs - A(res.x)
        return float(torch.sqrt(_dot(r, r, True) / _dot(rhs, rhs, True)).max())

    return solve, true_residual


def _bench_mode(space, gmg, dim: int, label: str, dtype, *, kernels: bool, device,
                rhs=None, repetitions: int = N_REPETITIONS) -> BenchResult:
    """One benchmark mode (``prepare_mode``): one warm-up solve,
    ``repetitions`` timed solves, then the true residual."""
    device = torch.device(device)
    solve, true_residual = prepare_mode(space, gmg, dim, label, dtype, kernels=kernels,
                                        device=device, rhs=rhs)
    res, seconds = _timed(solve, 1, device)  # warm-up (gmg.cc:226-239)
    if repetitions:
        res, seconds = _timed(solve, repetitions, device)
    return BenchResult(seconds, int(torch.as_tensor(res.n_iterations).max()), true_residual(res))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="dealii_spirk_tpu_torch.gmg_bench")
    parser.add_argument("--dim", type=int, default=3, choices=(2, 3))
    parser.add_argument("--min-ref", type=int, default=3)
    parser.add_argument(
        "--max-ref", type=int, default=None,
        help="default: 8 on cuda (a vector of the 8-component modes is 0.53 GB in f32 "
        "there), 6 on the CPU (wall time)",
    )
    parser.add_argument("--degree", type=int, default=1)
    parser.add_argument("--precision", default="f64", choices=("f32", "f64"))
    parser.add_argument(
        "--modes", default="",
        help="comma-separated subset of " + ",".join(MODES) + " (default: all)",
    )
    parser.add_argument(
        "--op-mode", default="auto", choices=("auto", "stencil", "dense", "kernels"),
        help="operator execution; auto = the CUDA kernels on cuda in f32, the plain "
        "banded (stencil) operators otherwise; dense = the MatrixBased levels",
    )
    parser.add_argument(
        "--device", default="cuda", help="torch device to run on: cuda (default) or cpu"
    )
    return parser


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    try:
        device = require_device(args.device)
    except RuntimeError as err:
        parser.error(str(err))
    dtype = torch.float64 if args.precision == "f64" else torch.float32
    op_mode = args.op_mode
    if op_mode == "auto":
        op_mode = "kernels" if device.type == "cuda" and dtype == torch.float32 else "stencil"
    if op_mode == "kernels" and device.type == "cuda" and dtype != torch.float32:
        parser.error("the CUDA kernels take f32: --op-mode kernels on cuda needs --precision f32")
    if args.max_ref is None:
        args.max_ref = 8 if device.type == "cuda" else 6
    modes = list(MODES)
    if args.modes:
        keep = set(args.modes.split(","))
        modes = [m for m in modes if m in keep]
    table = ConvergenceTable()
    for ref in range(args.min_ref, args.max_ref + 1):
        space = make_space(args.dim, args.degree, ref)
        gmg = build_gmg_data(space, dtype=dtype, device=device, with_dense=op_mode == "dense")
        row = {"refinement": ref, "n_dofs": space.n_dofs}
        for label in modes:
            try:
                res = _bench_mode(space, gmg, args.dim, label, dtype,
                                  kernels=op_mode == "kernels", device=device)
            except torch.cuda.OutOfMemoryError as e:  # a measured limit, not a default
                msg = str(e)
                first = msg.splitlines()[0] if msg else type(e).__name__
                print(f"# {label} r{ref}: oom ({first[:160]})")
                row[f"t_{label}"] = "oom"
                row[f"it_{label}"] = 0
                row[f"t_per_it_{label}"] = "oom"
                continue
            row[f"t_{label}"] = res.seconds
            row[f"it_{label}"] = res.iterations
            row[f"t_per_it_{label}"] = res.seconds / max(res.iterations, 1)
        for k, v in row.items():
            table.add_value(k, v)
            if k.startswith("t") and isinstance(v, float):
                table.set_scientific(k, True)
        table.commit_row()
        print(json.dumps({k: (float(v) if isinstance(v, float) else v) for k, v in row.items()}))
    print()
    print(table.to_string())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
