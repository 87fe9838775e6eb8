#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path — ``irk_batched``, 3D, Q1, q=4, refinement 7
(127^3 interior DoFs per stage), MatrixFree + GMG, InnerTolerance 0,
OuterTolerance 1e-4, f32, dt 0.1 — through ``run_config`` on ``cuda``, in
phases, and fails (non-zero exit) if any phase fails:

1. device: a CUDA device must be present (no CPU fallback); prints the
   ``nvidia-smi`` name and power limit;
2. build: compiles ``dealii_spirk_tpu_torch/csrc`` with nvcc;
3. kernels: K1-K4 against their plain torch versions on the card at the
   slice's level shapes (q=4, m = 15, 31, 63, 127; K4 also at p=2), with
   CUDA-event times of kernel and plain version at m=127;
4. slice: 3 timesteps through the kernels; checks the L2 error, the
   launch counts the V-cycle structure implies, and per-step times;
5. plain arm: the same run on the plain torch operators; per-step counts
   must agree within 1 and the solutions closely.

Prints the kernel summary as one JSON line, then as its last line
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

REL_TOL = 1e-5  # max|kernel - plain| <= REL_TOL * max|plain|: f32, other summation order
SLICE = {
    "FEDegree": 1,
    "NRefinements": 7,
    "TimeIntegrationScheme": "irk_batched",
    "IRKStages": 4,
    "TimeStepSize": 0.1,
    "EndTime": 0.3,
    "OperatorType": "MatrixFree",
    "BlockPreconditionerType": "GMG",
    "InnerTolerance": 0.0,
    "OuterTolerance": 1e-4,
    "Precision": "f32",
    "DoOutputParaview": False,
}
KERNELS = {
    # name: (C source, TPU kernel body it replaces)
    "ms_mix_apply": ("dealii_spirk_tpu_torch/csrc/ms_mix_apply.cu",
                     "dealii_spirk_tpu/ops/pallas/stencil.py:2879"),
    "stage_mix": ("dealii_spirk_tpu_torch/csrc/stage_mix.cu",
                  "dealii_spirk_tpu/ops/pallas/stencil.py:2749"),
    "cheb_iter": ("dealii_spirk_tpu_torch/csrc/cheb_iter.cu",
                  "dealii_spirk_tpu/ops/pallas/stencil.py:3196"),
    "stencil_apply": ("dealii_spirk_tpu_torch/csrc/stencil_apply.cu",
                      "dealii_spirk_tpu/ops/pallas/stencil.py:682"),
}


def say(*args) -> None:
    print(*args, flush=True)


def cuda_ms(fn, reps: int = 50) -> float:
    """Mean milliseconds per call from CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_cases(ops, q: int, device, seed: int):
    """(name, kernel call, plain call) at one level: the same numpy inputs
    for both."""
    from dealii_spirk_tpu_torch.ops.cuda import stencil as st

    rng = np.random.default_rng(seed)
    m = ops.m

    def field(lo=-1.0, hi=1.0):
        return torch.as_tensor(rng.uniform(lo, hi, (q, m, m, m)), dtype=torch.float32,
                               device=device)

    def vec(lo, hi, shape=(q,)):
        return torch.as_tensor(rng.uniform(lo, hi, shape), dtype=torch.float32,
                               device=device)

    a, c1, c2 = vec(0.5, 2.0), vec(0.2, 0.9), vec(0.1, 0.5)
    b = 0.1
    u, d, r, x = field(), field(), field(), field()
    invd = field(0.5, 1.5)
    ainv, mat = vec(-2.0, 2.0, (q, q)), vec(-1.0, 1.0, (q, q))
    return [
        ("ms_mix_apply", lambda: st.ms_mix_apply(ops, ainv, b, u),
         lambda: st.ms_mix_apply_ref(ops, ainv, b, u)),
        ("stage_mix", lambda: st.stage_mix(mat, u), lambda: st.stage_mix_ref(mat, u)),
        ("cheb_iter", lambda: st.cheb_iter(ops, a, b, c1, c2, d, r, x, invd),
         lambda: st.cheb_iter_ref(ops, a, b, c1, c2, d, r, x, invd)),
        ("stencil_apply", lambda: st.stencil_apply(ops, a, b, u),
         lambda: st.stencil_apply_ref(ops, a, b, u)),
    ]


def max_err(got, want) -> tuple[float, float]:
    """max|got - want| (a device sync: faults surface here) and max|want|."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    scale = max(float(w.abs().max()) for w in want)
    return err, scale


def check_kernels(device, q: int = 4, refinements=(4, 5, 6, 7), timed: int = 7) -> dict:
    """Phase 3: every kernel against its plain version at each level
    (p=1), K4 also at p=2, m=63; times at refinement ``timed``."""
    from dealii_spirk_tpu_torch.fem.grid import make_level
    from dealii_spirk_tpu_torch.ops.mass_laplace import level_ops

    report = {name: {"max_abs_err": 0.0} for name in KERNELS}
    cases = [(ref, 1, None) for ref in refinements] + [(5, 2, {"stencil_apply"})]
    for ref, p, only in cases:
        ops = level_ops(make_level(ref, p), torch.float32, device)
        for name, kern, plain in kernel_cases(ops, q, device, seed=ref * 10 + p):
            if only is not None and name not in only:
                continue
            got = kern()
            want = plain()
            err, scale = max_err(got, want)
            ok = err <= REL_TOL * scale
            say(f"kernel {name:14s} p={p} m={ops.m:3d} q={q}: max|err|={err:.3e} "
                f"max|ref|={scale:.3e} tol={REL_TOL:g}*max|ref| {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} disagrees with its plain version at m={ops.m}")
            report[name]["max_abs_err"] = max(report[name]["max_abs_err"], err)
            if ref == timed and p == 1 and torch.device(device).type == "cuda":
                report[name]["ms"] = cuda_ms(kern)
                report[name]["plain_ms"] = cuda_ms(plain)
                say(f"  time at m={ops.m}, q={q}: kernel {report[name]['ms']:.4f} ms, "
                    f"plain torch {report[name]['plain_ms']:.4f} ms")
    return report


def run_slice(device, params_dict: dict, kernels: bool):
    from dealii_spirk_tpu_torch.config import Parameters
    from dealii_spirk_tpu_torch.runner import run_config

    params = Parameters.from_dict(params_dict, dim=3)
    return run_config(params, device=device, verbose=False, kernels=kernels)


def expected_launches(out) -> dict:
    """Launch counts the solve structure implies.  Per GMRES solve: one
    preconditioner (V-cycle) at the start, one vmult + one V-cycle per
    iteration, one of each per restart.  Per V-cycle: on each of the L
    smoothed levels two smooths of 4 fused Chebyshev steps (K3), the
    post-smooth entry residual and the restriction residual (K4); the
    T^-1 and T mixes around it (K2)."""
    scheme = out["scheme"]
    L = len(scheme.gmg.level_ops) - 1
    log = scheme.step_log
    for s in log:
        if s["n_inner"] != s["n_outer"] + 1 + s["n_restarts"]:
            raise AssertionError(f"V-cycle count off the GMRES structure: {s}")
    n_vmult = sum(s["n_outer"] + s["n_restarts"] for s in log)
    n_vcycle = sum(s["n_inner"] for s in log)
    return {
        "ms_mix_apply": n_vmult,
        "stage_mix": 2 * n_vcycle,
        "cheb_iter": 8 * L * n_vcycle,
        "stencil_apply": 2 * L * n_vcycle,
    }


def slice_phase(device, params_dict: dict, expect_launches: bool = True):
    """Phase 4: the kernel arm, with the launch counts of its run."""
    from dealii_spirk_tpu_torch.ops.cuda import stencil as st

    st.reset_launches()
    out = run_slice(device, params_dict, kernels=True)
    launches = dict(st.LAUNCHES)
    scheme = out["scheme"]
    L = len(scheme.gmg.level_ops) - 1
    say(f"slice (kernels): {out['n_timesteps']} steps, smoothed levels L={L} "
        f"(m = {[o.m for o in scheme.gmg.level_ops[1:]]}, coarse m={scheme.gmg.level_ops[0].m})")
    for i, s in enumerate(scheme.step_log, 1):
        say(f"  step {i}: n_outer={s['n_outer']} n_inner={s['n_inner']} "
            f"restarts={s['n_restarts']}")
    say(f"  step times (steps >= 2): {[f'{t * 1e3:.3f} ms' for t in out['step_seconds']]}")
    say(f"  L2 error {out['error_L2']:.6e}, Linf error {out['error_Linf']:.6e}")
    say(f"  launches: {launches}")
    if not (out["error_L2"] < 1e-2 and np.isfinite(out["error_Linf"])):
        raise AssertionError(f"slice solution error off: L2={out['error_L2']}")
    if expect_launches:
        if L != 4:
            raise AssertionError(f"refinement 7 keeps 4 smoothed levels, got {L}")
        want = expected_launches(out)
        say(f"  launches the structure implies: {want}")
        if launches != want:
            raise AssertionError(f"launch counts {launches} != structure {want}")
        missing = [k for k, n in launches.items() if n == 0]
        if missing:
            raise AssertionError(f"kernels never launched on the main path: {missing}")
    return out, launches


def plain_phase(device, params_dict: dict, kern_out):
    """Phase 5: the plain torch arm; counts within 1 per step, solutions
    close."""
    out = run_slice(device, params_dict, kernels=False)
    say("slice (plain torch):")
    for i, (sk, sp) in enumerate(zip(kern_out["scheme"].step_log, out["scheme"].step_log), 1):
        say(f"  step {i}: n_outer {sk['n_outer']} (kernels) vs {sp['n_outer']} (plain), "
            f"n_inner {sk['n_inner']} vs {sp['n_inner']}")
        if abs(sk["n_outer"] - sp["n_outer"]) > 1 or abs(sk["n_inner"] - sp["n_inner"]) > 1:
            raise AssertionError("kernel and plain arms' counts differ by more than 1")
    say(f"  step times (steps >= 2): kernels "
        f"{[f'{t * 1e3:.3f} ms' for t in kern_out['step_seconds']]}, plain "
        f"{[f'{t * 1e3:.3f} ms' for t in out['step_seconds']]}")
    du = float((kern_out["u"] - out["u"]).abs().max() / out["u"].abs().max())
    say(f"  L2 error {out['error_L2']:.6e} (plain) vs {kern_out['error_L2']:.6e} (kernels); "
        f"max|u_k - u_p| / max|u_p| = {du:.3e} (tol 1e-3)")
    if du > 1e-3:
        raise AssertionError("kernel and plain arms' solutions differ")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device — this smoke run needs the GPU")
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    say(smi)

    from dealii_spirk_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    lib = build.build()
    say(f"build: {time.perf_counter() - t0:.2f} s -> {lib.name}")
    entry = "?"
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "entry function" in line:
            entry = line.split("'")[1] if "'" in line else line.strip()
        elif "registers" in line or ("spill" in line and " 0 bytes spill" not in line):
            say(f"  ptxas {entry}: {line.split(':', 1)[-1].strip()}")

    report = check_kernels(device)
    kern_out, launches = slice_phase(device, SLICE)
    plain_out = plain_phase(device, SLICE, kern_out)
    say(f"per-step ms (steps >= 2) on {smi}: kernels "
        f"{[round(t * 1e3, 3) for t in kern_out['step_seconds']]}, plain "
        f"{[round(t * 1e3, 3) for t in plain_out['step_seconds']]}")

    summary = {
        "kernels": [
            {
                "name": name,
                "route": "cuda",
                "source": src,
                "replaces": replaces,
                "launches": launches[name],
                "max_abs_err": report[name]["max_abs_err"],
                "ms": report[name]["ms"],
                "plain_ms": report[name]["plain_ms"],
            }
            for name, (src, replaces) in KERNELS.items()
        ]
    }
    say(json.dumps(summary))
    say(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
