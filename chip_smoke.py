#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives twenty-one paths of the port on ``cuda``: P1-P11, P13 and P15-P21
through ``run_config``, MatrixFree, InnerTolerance 0, OuterTolerance 1e-4,
Q1 (P15: Q2; P16: Q3; P17-P21: Q4), f32, dt 0.1, 3 timesteps, with GMG
(P13, P21: AMG); P12 through the CLI; P14 through ``gmg_bench``'s CLI:

* P1: ``irk_batched``, 3D, q=4, refinement 7 (127^3 DoFs per stage) —
  kernels K1 (the z march's Mix mode), K2, K3, K4;
* P2: ``irk`` (sequential stage solves; json/irk.json's widths: 3D, q=5,
  refinement 7) — K5, K2, and K3/K4 on one stage at a time;
* P3: ``irk_batched``, 2D, q=4, refinement 10 (1023^2 DoFs per stage) —
  K5-2D, K2, K4-2D;
* P4: ``complex_irk_batched``, 3D, q=5 (3 pairs, 6 V-cycle lanes),
  refinement 8 (255^3 DoFs per lane) — K5 + K2 pair vmult, K2 maps,
  K3dg on the 255 level, K3/K4 below, the 12-column GMRES basis;
* P5: ``complex_irk`` with PRESB (json/complex_irk.json's widths: 3D,
  q=5, refinement 7) — K5 + K2 vmult, K2 maps, K4 and two 3-lane
  V-cycles (K3/K4) per preconditioner application;
* P6: ``spirk`` (json/spirk.json's widths: 3D, q=5, refinement 7), ring
  mixer, on a (5, 2) slot mesh — ten slots, all on the one card, z slabs
  of 64 and 63 planes — through the halo kernels K9a, K9b, K9c;
* P7: ``spirk`` with UseSharedMemory (json/spirk_sm.json's widths: 3D,
  q=2, refinement 8; the all-gather mixer) on a (2, 2) mesh — K9d on the
  255 level, K9a/K9b/K9c, the 12-column GMRES basis;
* P8: ``complex_spirk_batched`` (json/complex_spirk_batched.json's widths:
  3D, q=5, refinement 7) on a (3, 2) mesh, a pair per stage row — six
  slots, z slabs of 64 and 63 planes: K9b + the row-local 2x2 pair block,
  one 6-lane mesh V-cycle (K9a/K9c) per application, the T^-1 / T maps
  (K2) unsharded;
* P9: ``complex_spirk`` with PRESB (json/complex_spirk.json's widths) on a
  (3, 2) mesh — two 3-lane mesh V-cycles and one K9a (``M x0``) per
  application;
* P10: P4 with ``cheb_pair=True`` — K8 takes the 255 level's Chebyshev
  steps two at a time (half P4's K3dg launches, no K3dg), kernel arm only:
  its plain arm would be P4's (the plain pair step is two plain K3dg
  steps), so it is held against both of P4's arms;
* P11: ``ost`` (Crank-Nicolson, CG warm started at u^n to 1e-8 ||rhs||
  under the f32 floor of 32 eps ||r0||, one V-cycle per CG step), 3D,
  refinement 7 — K4 at q=1 (the rhs, the start residual and every CG
  vmult) and the one-lane V-cycle (K3/K4);
* P12: ``json/ost.json`` as shipped, through the port's CLI: Q4, refinement 5
  (127^3), MatrixBased + AMG, f64, dt 0.1 to 0.5 — the plain torch dense
  route on the card, no kernel (as the JAX package runs it through XLA),
  held against a MatrixFree + GMG run of the same widths in f64;
* P13: P1 with ``BlockPreconditionerType: "AMG"`` — the kernels (K1, K2,
  K3, K4) on the aggregation levels m = 127, 64, 32, 16 (even m, the last
  aggregate's band rows apart), the 8^3 level solved densely;
* P14: the GMG microbenchmark (``gmg_bench``, the reference's ``gmg``
  executable) in 3D, f32, on the kernels: CG with one V-cycle per step on
  M + K, Q1 refinements 3-8 in its four modes (``scalar``, ``fesystem8``,
  ``batched8``, ``subgroups8`` on an (8, 1) slot mesh) and Q2 refinements
  3-6 in ``scalar`` and ``batched8`` — K4 and K3, K3dg on the 255 level,
  and in ``subgroups8`` K9a, K9c, K9d;
* P15: ``irk_batched``, 3D, q=4, Q2, refinement 6 (127^3 DoFs per stage,
  P1's) — K1 (8-row tile at p = 2), K2, K3, K4 at degree 2;
* P16, P17: the paper's degree sweep (``irk_batched`` 3D q=4) at Q3 and
  Q4, refinement 6 (191^3 and 255^3 DoFs per stage; P17 past the compact
  GMRES threshold) — K1 on its 16-row tile (p = 3) and as its route K2 +
  ms_mix_apply_split (p = 4), K2, K3dg on the finest level, K3 and K4
  below;
* P18: ``spirk`` 3D q=4 Q4 refinement 5 on a (4, 2) slot mesh (slabs of
  64 + 63 planes with 4-plane halos) — K9a, K9b, K9c at p = 4; held to an
  unsharded ``irk`` run at its widths;
* P19: ``irk_batched`` 3D Q4 refinement 6 at P19_STAGES = 5 stages, where
  no K1 block holds the q rings — K1's route K2 + ms_mix_apply_split in a
  solve, K3dg on 255;
* P20: ``complex_irk_batched`` 3D q=5 Q4 refinement 5 — K5 + K2 vmult at
  p = 4, K2's maps, the six-lane V-cycle (K3, K4) at p = 4;
* P21: P19 with AMG — the kernels on the aggregation levels 128, 64, 32,
  16 at p = 4 and K3dg on 255; GMRES passes the compact basis's 12 columns
  and restarts in every step (RESTARTS).

Phases; any failure exits non-zero:

1. device: a CUDA device must be present (no CPU fallback); prints the
   ``nvidia-smi`` name and power limit;
2. build: compiles ``dealii_spirk_tpu_torch/csrc`` with nvcc, one process
   per source, all started together;
3. kernels: the 2D kernels of P3 on a smooth field at its finest level,
   K3dg, K8, K4, K5 and K9b at P4's, K3 at P4's 127 level and K1 at P1's
   finest level, and at degrees 3 and 4 K3dg, K4 and K5 at P16's and
   P17's finest levels, K3 one level down, K1 at P16's and P17's, its
   route at P19's and K9b on P18's first slab (``smooth_bias``): each
   kernel's mean error against the f64 plain version within SMOOTH_BIAS
   times its f32 plain version's (a rounding error that follows the field
   moves the solution); then
   every kernel against its plain torch version on the card at
   every shape the paths give it and at degrees 2-4 on small levels (K1
   also at q=8, on its route K2 + ms_mix_apply_split at p=4), to
   1e-5 max|ref| (K8, two chained f32 steps: 2e-5), with CUDA-event times
   of kernel, plain version and, where one PyTorch call computes the same
   function, that call (``library_ms``; held against the plain version,
   used nowhere in the port) at the paths' finest levels; the halo kernels
   K9a-K9d through the space-sharded layer (2 and 4 space slots, degrees
   1-4): gathered, against the same layer over their plain versions, and
   ``torch.equal`` to the whole-field kernel; K8 also against two chained
   K3dg launches (timed beside them; whether it equals them bit for bit,
   and its launches' registers and shared bytes from the profiler's
   trace, are printed), and a mesh V-cycle at P7's levels asked for pair
   steps launches no K8;
   K3 and K4 also on AMG level tables (AMG_CASES: m = 64 and 16 at p = 1,
   m = 32 of a Q4 hierarchy and P21's 128 and 64 at p = 4); K10's
   restriction and prolongation on every level pair of TRANSFER_CASES'
   hierarchies (degrees 1-4, 1 to 8 lanes, P13's and P21's aggregation),
   timed at the benchmark cells' finest pairs;
3b. measurement (``measure_kernels``, MEASURE_CASES): K2 and K4-2D at P3's
   finest shape, K4-2D at m=255, K2 at the 3D shapes of P1, P2 and P4's
   maps, K4 at P1's and P4's finest levels and K9a at P6's and P7's slabs,
   K1 at P1's shape and m=31, K5 at P4's finest level and the shapes of P2
   and P5, K9b at P6's and P7's slabs, each beside its library call, and
   K3 at P1's finest level and P4's 127 level, K3dg at P4's finest level,
   K9c at P6's slab, K9d at P7's and K1's split march at P1's shape, which
   have none, K8 at P4's finest level beside two K3dg launches, and K5-2D
   at P3's finest level and m=255 beside a grouped conv2d, and at degrees
   3 and 4 (no library call) K3dg at P16's and P17's finest levels, K3 and
   K4 at P20's, K1 at P17's (its route: the device time of the whole
   call), K2 and ms_mix_apply_split at P19's, K9c on P18's first slab and
   K3dg at P19's, K3 at P16's 95 and P17's 127 levels, K4 at P16's 191
   and P17's and P19's 255 levels, K9a and K9b on P18's first slab, K5 at
   P20's vmult and at P16's shape (p = 3), K1 at P16's finest level and
   its route there (K2 and ms_mix_apply_split), and K10 at the benchmark
   cells' finest pairs (511 <- 255 one lane at Q4, 255 <- 127 six lanes at
   Q1) beside its plain version: device time per
   launch from
   ``torch.profiler`` (only sessions in which every timed launch left its
   record, ``profiler_session``), time per call from CUDA events in turns (kernel,
   library, library, kernel), L2-warm and L2-cold; printed and kept in the
   kernels line (``device_ms``, ``cold_ms``, ``measured``), not a gate,
   but a turn that reads below the DRAM bound (``sub_bound``) is printed as
   dropped and left out, and a case whose every turn drops fails; the
   least of the kept turns is printed with their median;
3c. K3dg's, K3's, K4's, K5's and K1's diagnostic arms (``measure_arms``,
   ARM_CASES: K3dg at P4's 255 level at p = 1, P16's 191 and P17's 255
   levels, K3 at P20's and P17's 127 levels, K4 at P20's 127 and P17's 255
   levels, K5 at P20's vmult, K1 at P16's finest level): the
   kernel, its passes alone on resident planes and its copies alone,
   device time L2-cold; numbers, printed and kept in a line of their own
   (``march_arms``) before the kernels line, not gates;
4. per path, the kernel arm: the launch counts (all set to 0 just before
   the run, read just after) must equal what the solve structure implies
   (a 3D kernel V-cycle: one K10 restriction and one prolongation per level
   pair)
   and include every kernel of the path (REQUIRED: K3dg on P16, P17, P19
   and P21, K1's route on P19 and P21); a RESTARTS path restarts in every
   step after the first and warns where it passed the compact basis; L2
   error < 1e-2; on a mesh the
   bytes passed between slots, by kind, must equal the structure's too,
   with no message above p (grid transfers: h) planes and, for the pair
   schemes, no stage mix at all; K8 runs on P10 only;
5. per path, the plain arm: the same run on the plain torch operators;
   per-step outer and per-stage (per-pair) inner counts within 1 of the
   kernel arm, solutions close (P10: against P4's two arms), the L2 within
   ARM_L2 (P3, P18, P20) or ARM_L2_SHARE of the kernel arm's;
6. the mutual oracles: P5's, P6's and P9's L2 error within 1% of P2's
   (same q, refinement and tolerances, four different schemes), P8's
   within 3% (the tolerance's solve error, ORACLES), P10's within 1% of P4's; P6's outer count
   per step within 1 of an unsharded ``irk_batched`` run's, P8's per-pair
   outer counts within 1 of an unsharded ``complex_irk_batched`` run's and
   its L2 within 1% of that run's, P9's per-pair outer and inner counts
   within 1 of P5's, P13's L2 within 1% of P1's; P18's counts within 1 and
   L2 within P18_TWIN_L2 of an unsharded ``irk`` run's;
7. P12 (``run_p12``, in a temporary directory): no launch at all, L2 <
   1e-2, and its L2 within P12_REL of the MatrixFree + GMG twin's: the
   preconditioner and the operator route change the counts, not the
   solution; its ParaView series (``result.pvd`` listing every step and
   step 0, the last ``.vtr`` equal to the final field with its zero
   boundary, in f64, bit for bit);
8. P14 (``run_p14``): every mode at every refinement gives a result (no
   ``oom``), its launches equal the structure (``bench_launches``), its
   true residual |rhs - A x| / |rhs| is at most twice the reduction asked
   for, ``fesystem8`` and ``batched8`` take equal counts and
   ``subgroups8`` within 1 of them; a plain arm solving once (P14_PLAIN)
   takes counts within 1 of the kernel arm's; Q1 refinements 3-8 in all
   four modes, Q2-Q4 refinements 3-6 in ``scalar`` and ``batched8``.

Prints K3dg's arms as one JSON line, the kernel summary as another, then
as its last line ``{"ok": true, "device": {...}}``.  Imports nothing of
JAX.
"""

from __future__ import annotations

import base64
import gc
import json
import os
import re
import struct
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

REL_TOL = 1e-5  # max|kernel - plain| <= REL_TOL * max|plain|: f32, other summation order
# the library calls pick their own algorithms and summation order (cuDNN's
# convolutions); they are yardsticks of time, held to 1e-4 max|plain|
LIB_TOL = 1e-4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (data sheet)
F32_FLOPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores (data sheet)
_COMMON = {
    "FEDegree": 1,
    "TimeStepSize": 0.1,
    "EndTime": 0.3,
    "OperatorType": "MatrixFree",
    "BlockPreconditionerType": "GMG",
    "InnerTolerance": 0.0,
    "OuterTolerance": 1e-4,
    "Precision": "f32",
    "DoOutputParaview": False,
}
# P19's stages: the fewest at which no K1 block holds the q rings at Q4, so
# its vmult takes K2 + ms_mix_apply_split (as P17's four stages do too,
# since mix_tile takes the route at p = 4 wherever no tile lets two Mix
# blocks share an SM).  Not
# the q sweep's 8: the stage mixes T and T^-1 of Radau IIA lose
# cond(T) * eps in f32, and cond(T) grows about 8x per stage (231 at q=4,
# 1.4e3 at 5, 1.2e4 at 6, 7.3e5 at 8), so at q=8 an f32 solve stops on its
# preconditioned residual with a true residual of 0.15 to 0.68 and an L2
# 2.6x (Q4 refinement 2) to 75x (refinement 3) that of f64; the JAX
# package's f32 runs end 2.3x and 60x off (scripts/torch_stage_precision.py;
# PERF.md, section 6)
P19_STAGES = 5
# name: (dim, configuration, smoothed GMG levels)
PATHS = {
    "P1": (3, {**_COMMON, "NRefinements": 7, "TimeIntegrationScheme": "irk_batched",
               "IRKStages": 4}, 4),
    "P2": (3, {**_COMMON, "NRefinements": 7, "TimeIntegrationScheme": "irk",
               "IRKStages": 5}, 4),
    "P3": (2, {**_COMMON, "NRefinements": 10, "TimeIntegrationScheme": "irk_batched",
               "IRKStages": 4}, 5),
    "P4": (3, {**_COMMON, "NRefinements": 8, "TimeIntegrationScheme": "complex_irk_batched",
               "IRKStages": 5}, 5),
    "P5": (3, {**_COMMON, "NRefinements": 7, "TimeIntegrationScheme": "complex_irk",
               "IRKStages": 5}, 4),
    "P6": (3, {**_COMMON, "NRefinements": 7, "TimeIntegrationScheme": "spirk",
               "IRKStages": 5}, 4),
    "P7": (3, {**_COMMON, "NRefinements": 8, "TimeIntegrationScheme": "spirk",
               "IRKStages": 2, "UseSharedMemory": True, "DoRowMajor": True, "Padding": 0}, 5),
    "P8": (3, {**_COMMON, "NRefinements": 7, "TimeIntegrationScheme": "complex_spirk_batched",
               "IRKStages": 5}, 4),
    "P9": (3, {**_COMMON, "NRefinements": 7, "TimeIntegrationScheme": "complex_spirk",
               "IRKStages": 5}, 4),
    "P10": (3, {**_COMMON, "NRefinements": 8, "TimeIntegrationScheme": "complex_irk_batched",
                "IRKStages": 5}, 5),
    "P11": (3, {**_COMMON, "NRefinements": 7, "TimeIntegrationScheme": "ost"}, 4),
    "P13": (3, {**_COMMON, "NRefinements": 7, "TimeIntegrationScheme": "irk_batched",
                "IRKStages": 4, "BlockPreconditionerType": "AMG"}, 4),
    "P15": (3, {**_COMMON, "FEDegree": 2, "NRefinements": 6,
                "TimeIntegrationScheme": "irk_batched", "IRKStages": 4}, 4),
    # the paper's degree sweep at Q3 and Q4: sweep_p's irk_batched q=4 (P16,
    # P17) and spirk (P18); K1's route in a solve (P19); the complex p=4
    # row (P20)
    "P16": (3, {**_COMMON, "FEDegree": 3, "NRefinements": 6,
                "TimeIntegrationScheme": "irk_batched", "IRKStages": 4}, 5),
    "P17": (3, {**_COMMON, "FEDegree": 4, "NRefinements": 6,
                "TimeIntegrationScheme": "irk_batched", "IRKStages": 4}, 5),
    "P18": (3, {**_COMMON, "FEDegree": 4, "NRefinements": 5, "TimeIntegrationScheme": "spirk",
                "IRKStages": 4}, 4),
    "P19": (3, {**_COMMON, "FEDegree": 4, "NRefinements": 6,
                "TimeIntegrationScheme": "irk_batched", "IRKStages": P19_STAGES}, 5),
    "P20": (3, {**_COMMON, "FEDegree": 4, "NRefinements": 5,
                "TimeIntegrationScheme": "complex_irk_batched", "IRKStages": 5}, 4),
    # P19 with AMG: plain aggregation at Q4 converges slowly enough (5, 7,
    # 10 outer iterations at refinements 2-4 on the CPU) that refinement 6
    # passes the compact basis's 12 columns at OuterTolerance 1e-4, clear
    # of the f32 floor, where GMG never does (P19_STAGES)
    "P21": (3, {**_COMMON, "FEDegree": 4, "NRefinements": 6, "TimeIntegrationScheme": "irk_batched",
                "IRKStages": P19_STAGES, "BlockPreconditionerType": "AMG"}, 5),
}
# paths whose GMRES must restart its compact basis in every step after the
# first, with check_outer's RuntimeWarning in each such step
RESTARTS = ("P21",)
# P12: the shipped configuration as the file gives it (MatrixBased + AMG, Q4,
# refinement 5, f64, dt 0.1 to 0.5), run once, and its MatrixFree + GMG twin
ROOT = os.path.dirname(os.path.abspath(__file__))
P12_JSON = "json/ost.json"
P12_TWIN = {"OperatorType": "MatrixFree", "BlockPreconditionerType": "GMG"}
# its L2 within this share of the twin's: on the CPU at f64 the two routes'
# L2 lie 1.4e-7, 1.1e-8 and 7.7e-9 apart at refinements 2, 3 and 4 (CG's
# 1e-8 ||rhs|| leaves the rest; PERF.md)
P12_REL = 1e-6
# P14: gmg_bench in 3D, f32, on the kernels: (degree, first and last
# refinement, modes), and the (degree, refinement, modes) its plain arm
# solves once at
P14_SWEEPS = ((1, 3, 8, ("scalar", "fesystem8", "batched8", "subgroups8")),
              (2, 3, 6, ("scalar", "batched8")),
              (3, 3, 6, ("scalar", "batched8")),
              (4, 3, 6, ("scalar", "batched8")))
P14_PLAIN = ((1, 7, ("scalar", "fesystem8", "batched8", "subgroups8")),
             (1, 8, ("scalar",)),
             (2, 6, ("scalar", "batched8")),
             (4, 6, ("scalar",)))
# kernels a path must launch whatever its counts (the structure implies
# them too): K3dg on the degree sweep's finest levels, K1's route on P19
REQUIRED = {"P16": ("cheb_iter_dg",), "P17": ("cheb_iter_dg",),
            "P19": ("cheb_iter_dg", "ms_mix_apply_split"),
            "P21": ("cheb_iter_dg", "ms_mix_apply_split")}
# slots of the (stage, space) mesh, all on the one card
SLOTS = {"P6": 10, "P7": 4, "P8": 6, "P9": 6, "P18": 8}
# paths run with cheb_pair=True (K8), kernel arm only: the path whose two
# arms each is held against
PAIR_STEPPED = {"P10": "P4"}
# L2 of a path's kernel arm within this share of its plain arm's (default
# ARM_L2_SHARE; P1-P15's arms lay at most 0.26% apart, P15's).  P3 at
# 5%: the two f32 arms end 1.9% apart (2.821864e-06 / 2.875072e-06, the f64
# value 2.875756e-06; 5.4e-8 in absolute L2, at the f32 rounding of u), where
# the K5-2D fault put the kernel arm 155% off (PERF.md, section 6).  P18 at
# 5%, and its unsharded irk twin too (P18_TWIN_L2): at Q4 refinement 5 the
# f32 L2 (2.3e-6) is f32 rounding, 25x f64's 9.1e-8 at the same tolerance;
# spirk and irk, kernels and plain, end 2.28e-6 to 2.36e-6 apart at
# OuterTolerance 1e-4 (3.1%) and 0.99% apart at 1e-6, in equal counts
# (scripts/torch_l2_tolerance.py --degree 4 --refinement 5 --stages 4
# --schemes spirk,irk --slots 8; PERF.md, section 6).  P20 at 5%, P18's
# grid and its rationale: at OuterTolerance 1e-4 its f32 arms (kernels,
# kernels but K10, plain) end up to 1.15% apart over the step sizes 0.08 to
# 0.12, the arm without K10 1.13% off the plain arm at dt 0.12 and the f32
# plain arm 3.9% off f64 there; at P18's size irk_batched's arm without
# K10 reads 1.5-3.0% off the plain arm (--degree 4 --refinement 5 --stages
# 5 --schemes complex_irk_batched and --stages 4 --schemes irk_batched,
# --dt 0.08-0.12; PERF.md, section 6)
ARM_L2 = {"P3": 0.05, "P18": 0.05, "P20": 0.05}
ARM_L2_SHARE = 0.01
P18_TWIN_L2 = ARM_L2["P18"]
# L2 of the first within this share of the second's.  P8 within 3%: at
# OuterTolerance 1e-4 the block-preconditioned pair GMRES of the batched
# complex scheme stops where its solve error moves L2 by 2.27% from irk's,
# in f64 as in f32 and at the same counts; at 1e-6 both precisions come
# within 0.004% (scripts/torch_l2_tolerance.py, PERF.md).  P8 is held to 1%
# of the unsharded complex_irk_batched run at its widths too (run_paths).
ORACLES = (("P5", "P2", 0.01), ("P6", "P2", 0.01), ("P8", "P2", 0.03), ("P9", "P2", 0.01),
           ("P10", "P4", 0.01), ("P13", "P1", 0.01))
_ST = "dealii_spirk_tpu/ops/pallas/stencil.py"
_SH = "dealii_spirk_tpu/ops/pallas/sharded.py"
_CS = "dealii_spirk_tpu_torch/csrc/"
_DENSE = "none (XLA's dense dot: dealii_spirk_tpu/ops/banded.py::apply_dense_1d)"
KERNELS = {
    # LAUNCHES key: (C source, TPU kernel it replaces)
    "ms_mix_apply": (_CS + "march.cuh", f"{_ST}:2879"),
    "ms_mix_apply_split": (_CS + "march.cuh", f"{_ST}:2879"),
    "stage_mix": (_CS + "stage_mix.cu", f"{_ST}:2749"),
    "cheb_iter": (_CS + "march.cuh", f"{_ST}:3196"),
    "cheb_iter_dg": (_CS + "march.cuh", f"{_ST}:2503"),
    "cheb_pair_dg": (_CS + "march.cuh", f"{_ST}:2215"),
    "stencil_apply": (_CS + "march.cuh", f"{_ST}:682"),
    "stencil_apply_2d": (_CS + "stencil_apply.cu", f"{_ST}:832"),
    "mass_stiffness_apply": (_CS + "march.cuh", f"{_ST}:762"),
    "mass_stiffness_apply_2d": (_CS + "mass_stiffness_apply.cu", f"{_ST}:863"),
    "stencil_apply_halo": (_CS + "march.cuh", f"{_SH}:102"),
    "mass_stiffness_apply_halo": (_CS + "march.cuh", f"{_SH}:136"),
    "cheb_iter_halo": (_CS + "march.cuh", f"{_SH}:164"),
    "cheb_iter_dg_halo": (_CS + "march.cuh", f"{_SH}:187"),
    # K10: no Pallas kernel; XLA's dense dot of the JAX package's transfers
    "transfer_restrict": (_CS + "transfer.cu", _DENSE),
    "transfer_prolong": (_CS + "transfer.cu", _DENSE),
}
HALO = {  # halo kernel: its whole-field kernel
    "stencil_apply_halo": "stencil_apply",
    "mass_stiffness_apply_halo": "mass_stiffness_apply",
    "cheb_iter_halo": "cheb_iter",
    "cheb_iter_dg_halo": "cheb_iter_dg",
}
# field passes each kernel must make (each input read once, each output
# written once): K1 u -> out; K1's route v, u -> out; K3 d, r, x, D^-1 ->
# r', d', x'; K3dg without D^-1; K8 d, r, x -> r'', d'', x'' for two steps;
# K4 u -> out; K5 u -> M u, K u.  K2 moves q_in + q_out fields.
PASSES = {
    "ms_mix_apply": 2,
    "ms_mix_apply_split": 3,
    "cheb_iter": 7,
    "cheb_iter_dg": 6,
    "cheb_pair_dg": 6,
    "stencil_apply": 2,
    "stencil_apply_2d": 2,
    "mass_stiffness_apply": 3,
    "mass_stiffness_apply_2d": 3,
}
K3D = ("ms_mix_apply", "ms_mix_apply_split", "stage_mix", "cheb_iter", "cheb_iter_dg",
       "stencil_apply", "mass_stiffness_apply")
K2D = ("stencil_apply_2d", "mass_stiffness_apply_2d", "stage_mix")
VCYCLE = ("cheb_iter", "stencil_apply")
# (dim, q, refinement, degree, kernels checked, kernels timed)
KERNEL_CASES = [
    (3, 4, 4, 1, K3D, ()),
    (3, 4, 5, 1, K3D, ()),
    (3, 4, 6, 1, K3D, ()),
    (3, 4, 7, 1, K3D, ("ms_mix_apply", "ms_mix_apply_split", "stage_mix", "cheb_iter",
                       "stencil_apply")),  # P1
    (3, 5, 7, 1, ("mass_stiffness_apply", "stage_mix"),
     ("mass_stiffness_apply", "stage_mix")),  # P2's vmult and mixes
    (3, 1, 4, 1, VCYCLE, ()),  # P2's one-stage V-cycle, on every smoothed level
    (3, 1, 5, 1, VCYCLE, ()),
    (3, 1, 6, 1, VCYCLE, ()),
    (3, 1, 7, 1, VCYCLE, VCYCLE),
    (2, 4, 6, 1, K2D, ()),  # P3's smoothed levels
    (2, 4, 7, 1, K2D, ()),
    (2, 4, 8, 1, K2D, ()),
    (2, 4, 9, 1, K2D, ()),
    (2, 4, 10, 1, K2D, K2D),  # P3's finest level
    (3, 6, 4, 1, VCYCLE, ()),  # P4's six-lane V-cycle below its finest level
    (3, 6, 5, 1, VCYCLE, ()),
    (3, 6, 6, 1, VCYCLE, ()),
    (3, 6, 7, 1, VCYCLE + ("mass_stiffness_apply", "stage_mix"), ()),  # + P5's vmult
    (3, 6, 8, 1, ("cheb_iter_dg", "stencil_apply", "mass_stiffness_apply", "stage_mix"),
     ("cheb_iter_dg", "stencil_apply", "mass_stiffness_apply")),  # P4's finest level
    (3, 3, 8, 1, ("cheb_iter_dg",), ()),
    (3, 8, 3, 1, VCYCLE, ()),  # P14's 8-lane modes: the CG operator and V-cycle
    (3, 8, 4, 1, VCYCLE, ()),
    (3, 8, 7, 1, VCYCLE, ()),
    (3, 8, 8, 1, ("cheb_iter_dg", "stencil_apply"), ()),
    (3, 1, 3, 1, VCYCLE, ()),  # P14's scalar mode at refinement 3
    (3, 1, 8, 1, ("cheb_iter_dg", "stencil_apply"), ()),
    (3, 8, 3, 2, VCYCLE, ()),  # P14's Q2 sweep, 8 lanes and 1 (P15's q=4 below)
    (3, 8, 6, 2, VCYCLE, ()),
    (3, 1, 3, 2, VCYCLE, ()),
    (3, 1, 6, 2, VCYCLE, ()),
    (3, 4, 6, 2, K3D, ()),  # P15's finest level
    (3, 3, 4, 1, VCYCLE, ()),  # P5's three-lane PRESB V-cycles and M x0
    (3, 3, 5, 1, VCYCLE, ()),
    (3, 3, 6, 1, VCYCLE, ()),
    (3, 3, 7, 1, VCYCLE, ()),
    # degrees 2-4, which operator_mode also sends to the kernels
    (3, 4, 5, 2, K3D, ()),
    (3, 4, 4, 3, K3D, ()),
    (3, 4, 4, 4, K3D, ()),
    # K1 at QMAX stages: a tile height of 8 at p = 1; at p = 4 no tile holds
    # the q rings and K1 takes the route K2 + ms_mix_apply_split
    (3, 8, 5, 1, ("ms_mix_apply",), ()),
    (3, 8, 3, 4, ("ms_mix_apply", "ms_mix_apply_split", "stage_mix"), ()),
    # K1's other forms (mix_tile): the 16-row tile at p = 2 and 4 (q=1), the
    # 8-row tile at p = 3 and 4 (q=2; at p = 4 also at the 255 level) and
    # the route at p = 3 (q=7)
    (3, 1, 4, 2, ("ms_mix_apply",), ()),
    (3, 1, 4, 4, ("ms_mix_apply",), ()),
    (3, 2, 4, 3, ("ms_mix_apply",), ()),
    (3, 2, 4, 4, ("ms_mix_apply",), ()),
    (3, 2, 6, 4, ("ms_mix_apply",), ()),
    (3, 7, 3, 3, ("ms_mix_apply", "ms_mix_apply_split", "stage_mix"), ()),
    (2, 4, 6, 2, K2D, ()),
    (2, 4, 6, 3, K2D, ()),
    (2, 4, 6, 4, K2D, ()),
    # m >= 512: K4-2D's tasks take two row groups, carrying 2p rows from the
    # first to the second, and the last task a partial second group
    (2, 4, 9, 2, K2D, ()),  # m = 1023
    (2, 4, 8, 3, K2D, ()),  # m = 767
    (2, 4, 8, 4, K2D, ()),  # m = 1023
    # P16 (Q3) and P17 (Q4), q=4: K1 (P16 its 16-row tile, P17 its route K2
    # + ms_mix_apply_split), K2 and K3dg at the finest level (191, 255), the
    # V-cycle below
    (3, 4, 3, 3, VCYCLE, ()),
    (3, 4, 5, 3, VCYCLE, ()),
    (3, 4, 6, 3, ("ms_mix_apply", "stage_mix", "cheb_iter_dg", "stencil_apply"), ()),
    (3, 4, 5, 4, VCYCLE, ()),
    (3, 4, 6, 4, ("ms_mix_apply", "stage_mix", "cheb_iter_dg", "stencil_apply"), ()),
    # P19 (Q4, P19_STAGES): K1's route K2 + ms_mix_apply_split at 255
    (3, P19_STAGES, 3, 4, VCYCLE, ()),
    (3, P19_STAGES, 5, 4, VCYCLE, ()),
    (3, P19_STAGES, 6, 4, K3D, ()),
    # P20 (Q4, three pairs): the six-lane V-cycle, K5 + K2 vmult at 127
    (3, 6, 3, 4, VCYCLE, ()),
    (3, 6, 4, 4, VCYCLE, ()),
    (3, 6, 5, 4, VCYCLE + ("mass_stiffness_apply", "stage_mix"), ()),
    # P14's Q3 and Q4 sweeps: one lane and 8 at refinements 3 and 6
    (3, 1, 3, 3, VCYCLE, ()),
    (3, 1, 6, 3, ("cheb_iter_dg", "stencil_apply"), ()),
    (3, 8, 3, 3, VCYCLE, ()),
    (3, 8, 6, 3, ("cheb_iter_dg", "stencil_apply"), ()),
    (3, 1, 3, 4, VCYCLE, ()),
    (3, 1, 6, 4, ("cheb_iter_dg", "stencil_apply"), ()),
    (3, 8, 6, 4, ("cheb_iter_dg", "stencil_apply"), ()),
]
# K3 and K4 on the band tables of AMG levels (solvers/amg.py): (q, degree,
# refinement of the space, m of the level) — even m, whose last aggregate
# is a single point and so its band rows differ from the others'
AMG_CASES = [
    (4, 1, 7, 64),  # P13's second level
    (4, 1, 7, 16),
    (4, 4, 4, 32),  # a Q4 hierarchy: 63 -> 32 -> 16 -> 8
    (P19_STAGES, 4, 6, 128),  # P21's: 255 -> 128 -> 64 -> 32 -> 16 -> 8
    (P19_STAGES, 4, 6, 64),
]
# K10 (restriction of r - A x, prolongation with the correction) on every
# level pair of a hierarchy, against its plain version: (q, degree,
# refinement of the space, AMG, timed at the finest pair).  A's finest pair
# (511 <- 255, one lane, p = 4) and B's (255 <- 127, the six lanes of its
# pair V-cycle, p = 1), the degree sweep's lanes at p = 2-4, one-lane and
# 8-lane V-cycles, and the aggregation hierarchies of P13 and P21 (even m)
TRANSFER_CASES = [
    (1, 4, 7, False, True),  # irk_q4_p4's V-cycle
    (6, 1, 8, False, True),  # cirkb_q5_p1's
    (4, 1, 7, False, False),  # P1
    (4, 2, 6, False, False),  # P15
    (4, 3, 6, False, False),  # P16
    (6, 4, 5, False, False),  # P20
    (8, 1, 4, False, False),
    (3, 4, 3, False, False),
    (4, 1, 7, True, False),  # P13: 127 -> 64 -> 32 -> 16 -> 8
    (P19_STAGES, 4, 6, True, False),  # P21: 255 -> 128 -> ... -> 8
]
# the halo kernels through the sharded layer: (q, refinement, degree, space
# slot counts, timed at one slab of the first count); one stage per stage
# row, as P6 and P7 launch them
HALO_CASES = [
    (5, 7, 1, (2, 4), True),  # P6's finest level: slabs of 64 + 63 planes
    (5, 6, 1, (2, 4), False),
    (5, 5, 1, (2, 4), False),
    (5, 4, 1, (2,), False),
    (2, 8, 1, (2, 4), True),  # P7's finest level: slabs of 128 + 127 planes
    (2, 7, 1, (2,), False),
    (2, 6, 1, (2,), False),
    (2, 5, 1, (2,), False),
    (2, 4, 1, (2,), False),
    (4, 4, 2, (2, 4), False),  # degrees 2-4
    (4, 4, 3, (2, 4), False),
    (4, 3, 4, (2, 4), False),
    (8, 8, 1, (1,), False),  # P14's subgroups8: one slot per lane, one z slab
    (8, 4, 1, (1,), False),
    (8, 3, 1, (1,), False),  # the CG operator's K9a on the unsplit 7^3 level
    (4, 5, 4, (2,), False),  # P18's finest level: slabs of 64 + 63 planes, 4-plane halos
    (4, 4, 4, (2,), False),
    (4, 2, 4, (2,), False),
]
# K8 against its plain version and two chained K3dg launches: (q, refinement,
# degree, timed); m = 255 and 127 are no multiple of the 16 x 64 tile, 15 is
# less than one tile along x (and m = 15 leaves chunks of one plane), p = 2
# and 4 take pair_tile's 8-row tile, p = 3 the 16-row one
PAIR_CASES = [
    (6, 8, 1, True),  # P10's 255 level: P4's shape
    (3, 7, 1, False),
    (2, 4, 1, False),
    (4, 5, 2, False),
    (4, 4, 3, False),
    (4, 4, 4, False),
]
# two chained f32 steps: the second step's apply carries the first step's
# round-off, so K8 is held to twice the one-step tolerance
PAIR_TOL = 2 * REL_TOL
# K2 at the complex maps' shapes: (dim, q_in, q_out, refinement, timed) —
# T^-1 (2 n2 x q), T (q x 2 n2), the vmult's 2x2 pair blocks (2 n2 x 2 n2)
MIX_CASES = [
    (3, 5, 6, 8, True),  # P4
    (3, 6, 5, 8, False),
    (3, 5, 6, 7, False),  # P5
    (3, 6, 5, 7, False),
]
# The measurement phase (``measure_kernels``): (LAUNCHES key, dim, q_in,
# q_out, refinement, degree).  K2 and K4-2D at P3's finest shape, K4-2D also at m=255
# (launch latency), K2 at the 3D shapes of P1, P2 and P4's T^-1 / T maps;
# K3 at P1's finest level (q=4, m=127) and P4's 127 level (six lanes), K4 at
# P1's and at P4's 255 level, both also at m=31 (P1's third level: launch
# latency); K3dg at P4's 255 level (six lanes); the halo kernels on one
# stage at the first of two slabs: K9c and K9a at P6's (64 planes of 127^2),
# K9a and K9d at P7's (128 planes of 255^2).  K1 at P1's shape and at m=31;
# K5 at P4's 255 level (six lanes), P2's (q=5, m=127) and P5's (q=6, m=127)
# shapes; K9b at P6's and P7's slabs; K8 at P4's 255 level (P10's, beside
# two K3dg launches); K5-2D at P3's finest level and m=255.  K4, K5, K9a and
# K9b beside cuDNN's grouped conv3d, K5-2D beside a grouped conv2d, K1
# beside a dense conv3d (``ms_mix_conv``); no PyTorch call computes K3,
# K3dg, K8, K9c or K9d.
MEASURE_CASES = [
    ("stage_mix", 2, 4, 4, 10, 1),
    ("stencil_apply_2d", 2, 4, 4, 10, 1),
    ("stencil_apply_2d", 2, 4, 4, 8, 1),
    ("stage_mix", 3, 4, 4, 7, 1),
    ("stage_mix", 3, 5, 5, 7, 1),
    ("stage_mix", 3, 5, 6, 8, 1),
    ("stage_mix", 3, 6, 5, 8, 1),
    ("cheb_iter", 3, 4, 4, 7, 1),
    ("cheb_iter", 3, 6, 6, 7, 1),
    ("cheb_iter", 3, 4, 4, 5, 1),
    ("stencil_apply", 3, 4, 4, 7, 1),
    ("stencil_apply", 3, 6, 6, 8, 1),
    ("stencil_apply", 3, 4, 4, 5, 1),
    ("cheb_iter_dg", 3, 6, 6, 8, 1),
    ("cheb_iter_halo", 3, 1, 1, 7, 1),
    ("stencil_apply_halo", 3, 1, 1, 7, 1),
    ("stencil_apply_halo", 3, 1, 1, 8, 1),
    ("cheb_iter_dg_halo", 3, 1, 1, 8, 1),
    ("ms_mix_apply", 3, 4, 4, 7, 1),
    ("ms_mix_apply", 3, 4, 4, 5, 1),
    ("mass_stiffness_apply", 3, 6, 6, 8, 1),
    ("mass_stiffness_apply", 3, 5, 5, 7, 1),
    ("mass_stiffness_apply", 3, 6, 6, 7, 1),
    ("mass_stiffness_apply_halo", 3, 1, 1, 7, 1),
    ("mass_stiffness_apply_halo", 3, 1, 1, 8, 1),
    ("ms_mix_apply_split", 3, 4, 4, 7, 1),
    ("cheb_pair_dg", 3, 6, 6, 8, 1),
    ("mass_stiffness_apply_2d", 2, 4, 4, 10, 1),
    ("mass_stiffness_apply_2d", 2, 4, 4, 8, 1),
    # the degree sweep: K3dg at P16's 191 and P17's 255 levels (q=4); K3 and
    # K4 at P20's 127 level (six lanes, Q4); K1 at P17's finest level (its
    # route, mix_tile); K1's route at P19's (K2, then ms_mix_apply_split);
    # K9c on P18's first slab
    ("cheb_iter_dg", 3, 4, 4, 6, 3),
    ("cheb_iter_dg", 3, 4, 4, 6, 4),
    ("cheb_iter", 3, 6, 6, 5, 4),
    ("stencil_apply", 3, 6, 6, 5, 4),
    ("ms_mix_apply", 3, 4, 4, 6, 4),
    ("stage_mix", 3, P19_STAGES, P19_STAGES, 6, 4),
    ("ms_mix_apply_split", 3, P19_STAGES, P19_STAGES, 6, 4),
    ("cheb_iter_halo", 3, 1, 1, 5, 4),
    # K3dg at P19's 255 level (P19_STAGES lanes, Q4)
    ("cheb_iter_dg", 3, P19_STAGES, P19_STAGES, 6, 4),
    # K3 at P16's 95 level (q=4, Q3) and P17's 127 level (q=4, Q4)
    ("cheb_iter", 3, 4, 4, 5, 3),
    ("cheb_iter", 3, 4, 4, 5, 4),
    # K4 at P17's and P19's 255 levels (q=4, 5) and P16's 191 level (q=4,
    # Q3); K9a on P18's first slab; K5 at P20's vmult (six lanes, Q4) and
    # K9b on P18's first slab; K1 at P16's finest level (Q3)
    ("stencil_apply", 3, 4, 4, 6, 4),
    ("stencil_apply", 3, P19_STAGES, P19_STAGES, 6, 4),
    ("stencil_apply", 3, 4, 4, 6, 3),
    ("stencil_apply_halo", 3, 1, 1, 5, 4),
    ("mass_stiffness_apply", 3, 6, 6, 5, 4),
    ("mass_stiffness_apply_halo", 3, 1, 1, 5, 4),
    ("ms_mix_apply", 3, 4, 4, 6, 3),
    # K1's route at P16's shape (K2, then ms_mix_apply_split) beside its Mix
    # form, and K5 at the same shape (p = 3)
    ("stage_mix", 3, 4, 4, 6, 3),
    ("ms_mix_apply_split", 3, 4, 4, 6, 3),
    ("mass_stiffness_apply", 3, 4, 4, 6, 3),
    # K10 at the cells' finest pairs: irk_q4_p4's (one lane, 511 <- 255,
    # Q4) and cirkb_q5_p1's (six lanes, 255 <- 127, Q1), beside the plain
    # version (the dense 1D transfers with their elementwise passes)
    ("transfer_restrict", 3, 1, 1, 7, 4),
    ("transfer_prolong", 3, 1, 1, 7, 4),
    ("transfer_restrict", 3, 6, 6, 8, 1),
    ("transfer_prolong", 3, 6, 6, 8, 1),
]
# the device kernels of a LAUNCHES key, by name in the profiler (default the
# key itself): the z march of each mode and its pair form (csrc/march.cuh),
# or the kernels it replaced (the tile kernels cheb_iter_kernel,
# stencil_apply_kernel, ms_mix_kernel, mass_stiffness_kernel and
# cheb_pair_kernel, the first z march cheb_dg_march), so that an older
# tree's arm is measured too
DEVICE_NAMES = {
    "ms_mix_apply": ("Mix<", "ms_mix_kernel"),
    "ms_mix_apply_split": ("MixSplit",),
    "mass_stiffness_apply": ("MassStiff", "mass_stiffness_kernel"),
    "mass_stiffness_apply_halo": ("MassStiff", "mass_stiffness_kernel"),
    "cheb_iter": ("ChebInvd", "cheb_iter_kernel"),
    "cheb_iter_halo": ("ChebInvd", "cheb_iter_kernel"),
    "stencil_apply": ("::Apply", "stencil_apply_kernel"),
    "stencil_apply_halo": ("::Apply", "stencil_apply_kernel"),
    "cheb_iter_dg": ("ChebDiag", "cheb_dg_march", "cheb_iter_kernel"),
    "cheb_iter_dg_halo": ("ChebDiag", "cheb_dg_march", "cheb_iter_kernel"),
    "cheb_pair_dg": ("pair_march", "cheb_pair_kernel"),
    "mass_stiffness_apply_2d": ("mass_stiffness_2d_kernel",),
}
TURNS = 3  # each: kernel, library, library, kernel
# smooth_bias: a kernel's mean error on P3's smooth block within this many
# times its plain version's, plus this share of max|f64| (the f32 round-off
# of a mean over 4.2 M points).  K5-2D's x pass that mixed mass and
# stiffness taps in one accumulator read 7.2e-9 against the plain 5.3e-11
# (PERF.md, section 6); the 2D kernels now read 8.7e-11 and 1.0e-10.
SMOOTH_BIAS, SMOOTH_FLOOR = 2.0, 1e-10
SMOOTH_B = 0.1  # b of the 3D smooth-field cases
L2_CACHE_BYTES = 50 * 2**20  # H100 L2; the L2-cold loops rotate over twice this


def say(*args) -> None:
    print(*args, flush=True)


def timed_calls(fn, reps: int = 20) -> tuple[float, float]:
    """(milliseconds per call from CUDA events, milliseconds per call the
    host took to issue them) over ``reps`` back-to-back calls after a
    warm-up: where the host is the slower, the two agree."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    host = (time.perf_counter() - t0) * 1e3 / reps
    end.synchronize()
    return start.elapsed_time(end) / reps, host


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean milliseconds per call from CUDA events, after a warm-up."""
    return timed_calls(fn, reps)[0]


def bound(name: str, q_in: int, q_out: int, points: int, p: int, dim: int,
          halo_points: int = 0) -> tuple[float, str]:
    """(ms, what binds) of the least time the H100 could take: the larger
    of the bytes the function must move over the HBM rate and its f32
    operations over the f32 peak.  Operations per output point of one
    stage, nb = 2p + 1 taps per axis: the shifted 3D apply 14 nb (z pass
    two sums, y pass C and D, x pass one sum of two products), K5 16 nb,
    K1 K5's plus 2 q for the mix, K1's route 16 nb (three z sums, Apply's
    y and x passes), the Chebyshev update 8 more, K3dg's
    diagonal 10 more, K8 two K3dg steps; 2D apply and K5-2D 10 nb; K2
    2 q_in.  A halo
    kernel is its whole-field kernel on the slab's ``points``, plus the
    ``halo_points`` of the 2p neighbour planes that its operand carries."""
    nb = 2 * p + 1
    name = HALO.get(name, name)
    if name == "stage_mix":
        nbytes = 4 * (q_in + q_out) * points
        flops = 2 * q_in * q_out * points
    else:
        nbytes = 4 * q_in * (PASSES[name] * points + halo_points)
        per_point = {
            "ms_mix_apply": 16 * nb + 2 * q_in,
            "ms_mix_apply_split": 16 * nb,
            "cheb_iter": 14 * nb + 8,
            "cheb_iter_dg": 14 * nb + 18,
            "cheb_pair_dg": 2 * (14 * nb + 18),
            "stencil_apply": 14 * nb,
            "mass_stiffness_apply": 16 * nb,
            "stencil_apply_2d": 10 * nb,
            "mass_stiffness_apply_2d": 10 * nb,
        }[name]
        flops = per_point * q_in * points
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _outer(vs):
    out = vs[0]
    for v in vs[1:]:
        out = torch.tensordot(out, v, dims=0)
    return out


def library_calls(ops, q: int, dim: int, a, b, u, mat, z_halo: bool = False,
                  ainv=None) -> dict:
    """The one PyTorch call that computes each kernel's function, where
    there is one: K2 is ``mat @ W``; K4 and K5 at p = 1 a grouped
    convolution with a 3^dim tensor-product weight per stage (zero
    padding; two output channels per stage for K5), K1 (``ainv`` given, tau
    = ``b``) one dense conv3d (``ms_mix_conv``).  ``z_halo``: ``u`` is a
    slab that carries its z halo, so the convolution does not pad z (a slab
    away from the upper domain end: the Q1 rows are all alike).  Timed
    only."""
    calls = {}
    if mat is not None:
        calls["stage_mix"] = lambda: (mat @ u.reshape(q, -1)).view(u.shape)
    if ops.p != 1:
        return calls
    pad = (0, 1, 1) if z_halo else 1
    sfx = "" if dim == 3 else "_2d"
    shifted = shifted_conv(ops, q, dim, a, b, pad)
    calls["stencil_apply" + sfx] = lambda: shifted(u)
    ms = ms_conv(ops, q, dim, pad)
    calls["mass_stiffness_apply" + sfx] = lambda: ms(u)
    if ainv is not None and dim == 3:
        mix = ms_mix_conv(ops, ainv, b)
        calls["ms_mix_apply"] = lambda: mix(u)
    return calls


def _q1_weights(ops, dim: int):
    """The 3^dim tensor-product mass and stiffness weights of a Q1 level:
    its 3-tap rows are the same on every row, boundary rows included (the
    band's zero weights there are the zero padding)."""
    wm, wk = ops.mass_band[:, ops.m // 2], ops.stiff_band[:, ops.m // 2]
    mass = _outer([wm] * dim)
    stiff = sum(_outer([wk if j == i else wm for j in range(dim)]) for i in range(dim))
    return mass, stiff


def ms_conv(ops, q: int, dim: int, pad=1):
    """(M u_i, K u_i) at p = 1 as one grouped convolution of u with two
    output channels per stage."""
    mass, stiff = _q1_weights(ops, dim)
    conv = torch.nn.functional.conv3d if dim == 3 else torch.nn.functional.conv2d
    w = torch.stack([mass, stiff]).repeat(q, *([1] * dim))[:, None].contiguous()

    def call(u):
        out = conv(u[None], w, padding=pad, groups=q)[0]
        return out[0::2], out[1::2]

    return call


def ms_mix_conv(ops, ainv, tau):
    """K1 at p = 1, sum_j Ainv[i, j] M u_j + tau K u_i, as one dense conv3d
    with q input and q output channels: weight[i, j] = Ainv[i, j] M3 +
    delta_ij tau K3 (M3, K3 the 3^3 stencils of ``_q1_weights``)."""
    mass, stiff = _q1_weights(ops, 3)
    ainv = ainv.to(dtype=mass.dtype, device=mass.device)
    eye = torch.eye(ainv.shape[0], dtype=mass.dtype, device=mass.device)
    w = (ainv[:, :, None, None, None] * mass
         + (tau * eye)[:, :, None, None, None] * stiff).contiguous()
    return lambda u: torch.nn.functional.conv3d(u[None], w, padding=1)[0]


def shifted_conv(ops, q: int, dim: int, a, b, pad=1):
    """(a_i M + b K) u_i at p = 1 as one grouped convolution of u."""
    mass, stiff = _q1_weights(ops, dim)
    conv = torch.nn.functional.conv3d if dim == 3 else torch.nn.functional.conv2d
    w = (a.reshape((q,) + (1,) * dim) * mass + b * stiff)[:, None].contiguous()
    return lambda u: conv(u[None], w, padding=pad, groups=q)[0]


def device_generator(device, seed: int) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed``: the kernels' random
    fields are drawn where they are used (up to 133 M numbers a field at
    255^3 with 8 lanes, seconds each when drawn on the host)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def uniform_field(shape, lo: float, hi: float, device, gen: torch.Generator) -> torch.Tensor:
    """An f32 field of ``shape`` on ``device``, uniform in [lo, hi)."""
    return torch.empty(shape, dtype=torch.float32, device=device).uniform_(lo, hi, generator=gen)


def kernel_cases(ops, q: int, dim: int, device, seed: int):
    """(LAUNCHES key, kernel call, plain call) at one level, and the
    library calls of ``library_calls``: the same inputs for all (fields
    drawn on the device, coefficients from numpy)."""
    from dealii_spirk_tpu_torch.ops.cuda import stencil as st

    rng = np.random.default_rng(seed)
    gen = device_generator(device, seed)
    shape = (q,) + (ops.m,) * dim

    def field(lo=-1.0, hi=1.0):
        return uniform_field(shape, lo, hi, device, gen)

    def vec(lo, hi, shape=(q,)):
        return torch.as_tensor(rng.uniform(lo, hi, shape), dtype=torch.float32,
                               device=device)

    a, c1, c2 = vec(0.5, 2.0), vec(0.2, 0.9), vec(0.1, 0.5)
    b = 0.1
    u, d, r, x = field(), field(), field(), field()
    invd = field(0.5, 1.5) if dim == 3 else None
    ainv, mat = vec(-2.0, 2.0, (q, q)), vec(-1.0, 1.0, (q, q))
    sfx = "" if dim == 3 else "_2d"
    cases = [
        ("stencil_apply" + sfx, lambda: st.stencil_apply(ops, a, b, u),
         lambda: st.stencil_apply_ref(ops, a, b, u)),
        ("mass_stiffness_apply" + sfx, lambda: st.mass_stiffness_apply(ops, u),
         lambda: st.mass_stiffness_apply_ref(ops, u)),
        ("stage_mix", lambda: st.stage_mix(mat, u), lambda: st.stage_mix_ref(mat, u)),
    ]
    if dim == 3:
        cases += [
            ("ms_mix_apply", lambda: st.ms_mix_apply(ops, ainv, b, u),
             lambda: st.ms_mix_apply_ref(ops, ainv, b, u)),
            ("ms_mix_apply_split", lambda: st.ms_mix_apply_split(ops, b, d, u),
             lambda: st.ms_mix_apply_split_ref(ops, b, d, u)),
            ("cheb_iter", lambda: st.cheb_iter(ops, a, b, c1, c2, d, r, x, invd),
             lambda: st.cheb_iter_ref(ops, a, b, c1, c2, d, r, x, invd)),
            ("cheb_iter_dg", lambda: st.cheb_iter_dg(ops, a, b, c1, c2, d, r, x),
             lambda: st.cheb_iter_dg_ref(ops, a, b, c1, c2, d, r, x)),
        ]
    return cases, library_calls(ops, q, dim, a, b, u, mat, ainv=ainv if dim == 3 else None)


def max_err(got, want) -> list[tuple[float, float]]:
    """(max|got - want|, max|want|) of each output (a device sync: faults
    surface here); each output is held to its own scale."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return [(float((g - w).abs().max()), float(w.abs().max())) for g, w in zip(got, want)]


def _hold(label: str, got, want, tol: float) -> float:
    errs = max_err(got, want)
    ok = all(e <= tol * sc for e, sc in errs)
    say(f"{label}: max|err|=" + " / ".join(f"{e:.3e}" for e, _ in errs) + " max|ref|="
        + " / ".join(f"{sc:.3e}" for _, sc in errs) + f" tol={tol:g}*max|ref| "
        + ("ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError(f"{label} disagrees with the plain version")
    return max(e for e, _ in errs)


def _time(report, name, at, kern, plain, lib, bnd) -> None:
    ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
    lib_ms = cuda_ms(lib) if lib is not None else None
    report[name]["times"].append({"at": at, "ms": ms, "plain_ms": plain_ms,
                                  "library_ms": lib_ms, "bound_ms": bnd[0],
                                  "bound_by": bnd[1]})
    say(f"  time at {at}: kernel {ms:.4f} ms, plain torch {plain_ms:.4f} ms, library "
        + ("none" if lib_ms is None else f"{lib_ms:.4f} ms")
        + f", bound {bnd[0]:.4f} ms ({bnd[1]})")


def check_kernels(device) -> dict:
    """Phase 3: every kernel against its plain version (KERNEL_CASES,
    MIX_CASES)."""
    from dealii_spirk_tpu_torch.fem.grid import make_level
    from dealii_spirk_tpu_torch.ops.cuda import stencil as st
    from dealii_spirk_tpu_torch.ops.mass_laplace import level_ops

    report = {name: {"max_abs_err": 0.0, "times": []} for name in KERNELS}
    smooth_bias(device)
    check_halo_kernels(device, report)
    check_pair_kernel(device, report)
    check_mesh_ignores_pair(device)
    for dim, q, ref, p, names, timed in KERNEL_CASES:
        ops = level_ops(make_level(ref, p), torch.float32, device)
        cases, libs = kernel_cases(ops, q, dim, device, seed=ref * 10 + p + q)
        for name, kern, plain in cases:
            if name not in names:
                continue
            at = f"{dim}D p={p} m={ops.m} q={q}"
            err = _hold(f"kernel {name:24s} {at}", kern(), plain(), REL_TOL)
            report[name]["max_abs_err"] = max(report[name]["max_abs_err"], err)
            if name in timed:
                lib = libs.get(name)
                if lib is not None:
                    _hold(f"  library call for {name}", lib(), plain(), LIB_TOL)
                _time(report, name, at, kern, plain, lib,
                      bound(name, q, q, ops.m**dim, p, dim))
        del cases, libs
        torch.cuda.empty_cache()
    check_amg_levels(device, report)
    check_transfer_kernels(device, report)
    for dim, qi, qo, ref, timed in MIX_CASES:
        m = make_level(ref, 1).m
        rng = np.random.default_rng(ref + qi + 10 * qo)
        W = uniform_field((qi,) + (m,) * dim, -1.0, 1.0, device,
                          device_generator(device, ref + qi + 10 * qo))
        mat = torch.as_tensor(rng.uniform(-1, 1, (qo, qi)), dtype=torch.float32, device=device)
        at = f"{dim}D m={m} ({qo}x{qi})"
        kern, plain = (lambda: st.stage_mix(mat, W)), (lambda: st.stage_mix_ref(mat, W))
        err = _hold(f"kernel {'stage_mix':24s} {at}", kern(), plain(), REL_TOL)
        report["stage_mix"]["max_abs_err"] = max(report["stage_mix"]["max_abs_err"], err)
        if timed:
            _time(report, "stage_mix", at, kern, plain, plain,
                  bound("stage_mix", qi, qo, m**dim, 1, dim))
    return report


def check_amg_levels(device, report: dict) -> None:
    """K3 and K4 on the band tables that ``build_amg_data`` gives an
    aggregation level (AMG_CASES), against their plain versions."""
    from dealii_spirk_tpu_torch.fem.grid import make_space
    from dealii_spirk_tpu_torch.solvers.amg import build_amg_data

    for q, p, ref, m in AMG_CASES:
        amg = build_amg_data(make_space(3, p, ref), torch.float32, device)
        ops = next(o for o in amg.level_ops if o.m == m)
        if not ops.kernel_bands:
            raise AssertionError(f"AMG level m={m} p={p}: its bands do not reach the kernels")
        cases, _libs = kernel_cases(ops, q, 3, device, seed=m + p + q)
        for name, kern, plain in cases:
            if name in VCYCLE:
                err = _hold(f"kernel {name:24s} AMG level 3D p={p} m={m} q={q}", kern(),
                            plain(), REL_TOL)
                report[name]["max_abs_err"] = max(report[name]["max_abs_err"], err)
        del cases, amg


def transfer_bound(q: int, m_f: int, m_c: int) -> tuple[float, str]:
    """(ms, what binds) of K10 on a level pair: two fine passes and one
    coarse (restriction: rl, ax in, rc out; prolongation: x, xc in, x' out)
    over the HBM rate; its FMAs (at most 15 per output per axis, a 1e-2 share
    of the f32 peak's time) never bind."""
    return 4 * q * (2 * m_f**3 + m_c**3) / HBM_BYTES_PER_S * 1e3, "bytes"


def check_transfer_kernels(device, report: dict) -> None:
    """K10 on every level pair of TRANSFER_CASES' hierarchies (each pair
    admitted by ``transfer_runs``): ``restrict_residual`` and
    ``prolong_add`` against their plain versions (the dense 1D transfers
    and the two elementwise passes); at a timed case's finest pair, each
    beside its plain version and its bound."""
    from dealii_spirk_tpu_torch.fem.grid import make_space
    from dealii_spirk_tpu_torch.ops.cuda import transfer as tr
    from dealii_spirk_tpu_torch.solvers.amg import build_amg_data
    from dealii_spirk_tpu_torch.solvers.gmg import build_gmg_data

    for q, p, ref, amg, timed in TRANSFER_CASES:
        build = build_amg_data if amg else build_gmg_data
        gmg = build(make_space(3, p, ref), torch.float32, device)
        gen = device_generator(device, 1000 * ref + 10 * p + q)
        for l, runs in enumerate(gmg.transfers):
            if not runs.fits:
                raise AssertionError(f"p={p} r={ref} pair {l}: K10 does not take its P")
            m_f, m_c = runs.P.shape
            at = f"3D p={p} m={m_f} <- {m_c} q={q}" + (" AMG" if amg else "")
            rl, ax, x = (uniform_field((q, m_f, m_f, m_f), -1.0, 1.0, device, gen)
                         for _ in range(3))
            xc = uniform_field((q, m_c, m_c, m_c), -1.0, 1.0, device, gen)
            calls = {
                "transfer_restrict": (lambda: tr.restrict_residual(runs, rl, ax),
                                      lambda: tr.restrict_residual_ref(runs.P, rl, ax)),
                "transfer_prolong": (lambda: tr.prolong_add(runs, x, xc),
                                     lambda: tr.prolong_add_ref(runs.P, x, xc)),
            }
            for name, (kern, plain) in calls.items():
                err = _hold(f"kernel {name:24s} {at}", kern(), plain(), REL_TOL)
                report[name]["max_abs_err"] = max(report[name]["max_abs_err"], err)
                if timed and l == len(gmg.transfers) - 1:
                    _time(report, name, at, kern, plain, None, transfer_bound(q, m_f, m_c))
            del rl, ax, x, xc, calls
            torch.cuda.empty_cache()


def check_halo_kernels(device, report: dict) -> None:
    """Phase 3 for K9a-K9d (HALO_CASES): a random block split over a
    (q, n_space) slot mesh on the card and run through the sharded layer,
    the gathered result against (a) the same layer over the plain versions
    at REL_TOL and (b) the whole-field kernel, bit for bit."""
    from dealii_spirk_tpu_torch.fem.grid import make_level
    from dealii_spirk_tpu_torch.ops.cuda import sharded as shk
    from dealii_spirk_tpu_torch.ops.cuda import stencil as st
    from dealii_spirk_tpu_torch.ops.mass_laplace import level_ops
    from dealii_spirk_tpu_torch.parallel.mesh import make_mesh
    from dealii_spirk_tpu_torch.parallel.sharding import gather, scatter

    def whole(out):
        out = out if isinstance(out, tuple) else (out,)
        return tuple(gather(o) for o in out)

    for q, ref, p, nsps, timed in HALO_CASES:
        ops = level_ops(make_level(ref, p), torch.float32, device)
        m = ops.m
        rng = np.random.default_rng(100 * ref + 10 * p + q)
        gen = device_generator(device, 100 * ref + 10 * p + q)

        def field(lo=-1.0, hi=1.0):
            return uniform_field((q, m, m, m), lo, hi, device, gen)

        def vec(lo, hi):
            return torch.as_tensor(rng.uniform(lo, hi, (q,)), dtype=torch.float32,
                                   device=device)

        a, c1, c2, b = vec(0.5, 2.0), vec(0.2, 0.9), vec(0.1, 0.5), 0.1
        u, d, r, x, invd = field(), field(), field(), field(), field(0.5, 1.5)
        unsharded = {
            "stencil_apply_halo": st.stencil_apply(ops, a, b, u),
            "mass_stiffness_apply_halo": st.mass_stiffness_apply(ops, u),
            "cheb_iter_halo": st.cheb_iter(ops, a, b, c1, c2, d, r, x, invd),
            "cheb_iter_dg_halo": st.cheb_iter_dg(ops, a, b, c1, c2, d, r, x),
        }
        for nsp in nsps:
            mesh = make_mesh(q, devices=[device] * (q * nsp))
            level = shk.shard_level(ops, mesh)
            ub, db, rb, xb, ib = (scatter(t, mesh, kind=None) for t in (u, d, r, x, invd))

            def layer(kernels):
                return {
                    "stencil_apply_halo": lambda: shk.sharded_stencil_apply(
                        level, a, b, ub, kernels=kernels),
                    "mass_stiffness_apply_halo": lambda: shk.sharded_mass_stiffness_apply(
                        level, ub, kernels=kernels),
                    "cheb_iter_halo": lambda: shk.sharded_cheb_iter(
                        level, a, b, c1, c2, db, rb, xb, ib, kernels=kernels),
                    "cheb_iter_dg_halo": lambda: shk.sharded_cheb_iter(
                        level, a, b, c1, c2, db, rb, xb, None, kernels=kernels),
                }

            kern, plain = layer(True), layer(False)
            for name in HALO:
                at = f"3D p={p} m={m} q={q} over {nsp} z slabs"
                got = whole(kern[name]())
                err = _hold(f"kernel {name:26s} {at}", got, whole(plain[name]()), REL_TOL)
                report[name]["max_abs_err"] = max(report[name]["max_abs_err"], err)
                want = unsharded[name]
                want = want if isinstance(want, tuple) else (want,)
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise AssertionError(f"{name} {at}: not equal to the whole-field kernel")
            if timed and nsp == nsps[0]:
                _time_slab(report, level.ops[0][0], ops, u, d, r, x, invd, a, b, c1, c2)
            del kern, plain, ub, db, rb, xb, ib
        del unsharded
        torch.cuda.empty_cache()
    say("halo kernels: every gathered result torch.equal to its whole-field kernel")


def check_pair_kernel(device, report: dict) -> None:
    """Phase 3 for K8 (PAIR_CASES): against its plain version (two chained
    plain K3dg steps) and against two chained K3dg launches, both to
    PAIR_TOL, saying whether it equals the two launches bit for bit; at
    P10's shape the times of K8, of the plain version and of the two K3dg
    launches and K8's bound."""
    from dealii_spirk_tpu_torch.fem.grid import make_level
    from dealii_spirk_tpu_torch.ops.cuda import stencil as st
    from dealii_spirk_tpu_torch.ops.mass_laplace import level_ops

    for q, ref, p, timed in PAIR_CASES:
        ops = level_ops(make_level(ref, p), torch.float32, device)
        m = ops.m
        rng = np.random.default_rng(1000 + 10 * ref + p)
        gen = device_generator(device, 1000 + 10 * ref + p)

        def field():
            return uniform_field((q, m, m, m), -1.0, 1.0, device, gen)

        def vec(lo, hi):
            return torch.as_tensor(rng.uniform(lo, hi, (q,)), dtype=torch.float32,
                                   device=device)

        d, r, x = field(), field(), field()
        a, b = vec(0.5, 2.0), 0.1
        c1a, c2a, c1b, c2b = vec(0.2, 0.9), vec(0.1, 0.5), vec(0.2, 0.9), vec(0.1, 0.5)

        def kern():
            return st.cheb_pair_dg(ops, a, b, c1a, c2a, c1b, c2b, d, r, x)

        def plain():
            return st.cheb_pair_dg_ref(ops, a, b, c1a, c2a, c1b, c2b, d, r, x)

        def two_k3dg():
            r1, d1, x1 = st.cheb_iter_dg(ops, a, b, c1a, c2a, d, r, x)
            return st.cheb_iter_dg(ops, a, b, c1b, c2b, d1, r1, x1)

        at = f"3D p={p} m={m} q={q}"
        got, twin = kern(), two_k3dg()
        err = _hold(f"kernel {'cheb_pair_dg':24s} {at}", got, plain(), PAIR_TOL)
        _hold("  against two K3dg launches", got, twin, PAIR_TOL)
        say(f"  equal to two K3dg launches bit for bit: "
            f"{all(torch.equal(g, t) for g, t in zip(got, twin))}")
        for la in launch_attrs(kern, "pair_march"):
            say(f"  launch {la['name']}: grid {la['grid']}, block {la['block']}, "
                f"{la['registers per thread']} registers, {la['shared memory']} B shared")
        report["cheb_pair_dg"]["max_abs_err"] = max(report["cheb_pair_dg"]["max_abs_err"], err)
        del got, twin
        if timed:
            ms, plain_ms, two_ms = cuda_ms(kern), cuda_ms(plain), cuda_ms(two_k3dg)
            bnd = bound("cheb_pair_dg", q, q, m**3, p, 3)
            report["cheb_pair_dg"]["times"].append({
                "at": at, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                "bound_ms": bnd[0], "bound_by": bnd[1], "two_k3dg_ms": two_ms,
            })
            say(f"  time at {at}: kernel {ms:.4f} ms, plain torch {plain_ms:.4f} ms, two K3dg "
                f"launches {two_ms:.4f} ms, library none, bound {bnd[0]:.4f} ms ({bnd[1]})")
        del d, r, x
        torch.cuda.empty_cache()


def check_mesh_ignores_pair(device) -> None:
    """A mesh V-cycle at P7's levels (q=2, refinement 8, a (2, 2) mesh: K9d on
    the 255 level) asked for pair steps launches no K8 and gives the
    single-step result bit for bit: the JAX package's pair kernel has no
    sharded form, and the mesh keeps single steps."""
    from dealii_spirk_tpu_torch.fem.grid import make_space
    from dealii_spirk_tpu_torch.ops.cuda import stencil as st
    from dealii_spirk_tpu_torch.parallel.mesh import make_mesh
    from dealii_spirk_tpu_torch.parallel.sharding import gather, scatter
    from dealii_spirk_tpu_torch.solvers import gmg

    space = make_space(3, 1, 8)
    data = gmg.build_gmg_data(space, dtype=torch.float32, device=device)
    a = torch.tensor([1.5, 4.0], dtype=torch.float32, device=device)
    prec = gmg.gmg_reinit(data, a, 0.1, 3)
    mesh = make_mesh(2, devices=[device] * 4)
    mp = gmg.scatter_prec(data, prec, a, 3, mesh)
    rng = np.random.default_rng(3)
    r = scatter(torch.as_tensor(rng.uniform(-1, 1, (2,) + space.shape), dtype=torch.float32,
                                device=device), mesh, kind=None)
    st.reset_launches()
    got = gmg.vcycle(data, mp, a, 0.1, r, 3, kernels=True, mesh=mesh, cheb_pair=True)
    launches = dict(st.LAUNCHES)
    want = gmg.vcycle(data, mp, a, 0.1, r, 3, kernels=True, mesh=mesh)
    same = torch.equal(gather(got), gather(want))
    say(f"mesh V-cycle with cheb_pair=True at q=2, m=255, (2, 2) mesh: K8 "
        f"{launches['cheb_pair_dg']}, K9d {launches['cheb_iter_dg_halo']}, "
        f"equal to the single-step V-cycle: {same}")
    if launches["cheb_pair_dg"] or not launches["cheb_iter_dg_halo"] or not same:
        raise AssertionError("the mesh V-cycle took pair steps")
    del data, prec, mp, r, got, want
    torch.cuda.empty_cache()


def _time_slab(report, sops, ops, u, d, r, x, invd, a, b, c1, c2) -> None:
    """Times of one slot's launch of each halo kernel at the first slab of a
    (q, 2) mesh (one stage, planes 0 .. nz_c / 2 with its p-plane halo)."""
    from dealii_spirk_tpu_torch.ops.cuda import stencil as st
    from dealii_spirk_tpu_torch.parallel.sharding import z_partition

    p, m = ops.p, ops.m
    nzl = z_partition(m, 2)[0][1]
    a1, c11, c21 = a[:1], c1[:1], c2[:1]
    zeros = torch.zeros_like(u[:1, :p])
    u_h = torch.cat([zeros, u[:1, : nzl + p]], dim=1)
    d_h = torch.cat([zeros, d[:1, : nzl + p]], dim=1)
    r1, x1, i1 = (t[:1, :nzl].contiguous() for t in (r, x, invd))
    calls = {
        "stencil_apply_halo": (lambda: st.stencil_apply_halo(sops, a1, b, u_h),
                               lambda: st.stencil_apply_halo_ref(sops, a1, b, u_h)),
        "mass_stiffness_apply_halo": (lambda: st.mass_stiffness_apply_halo(sops, u_h),
                                      lambda: st.mass_stiffness_apply_halo_ref(sops, u_h)),
        "cheb_iter_halo": (
            lambda: st.cheb_iter_halo(sops, a1, b, c11, c21, d_h, r1, x1, i1),
            lambda: st.cheb_iter_halo_ref(sops, a1, b, c11, c21, d_h, r1, x1, i1)),
        "cheb_iter_dg_halo": (
            lambda: st.cheb_iter_dg_halo(sops, a1, b, c11, c21, d_h, r1, x1),
            lambda: st.cheb_iter_dg_halo_ref(sops, a1, b, c11, c21, d_h, r1, x1)),
    }
    libs = library_calls(ops, 1, 3, a1, b, u_h, None, z_halo=True) if p == 1 else {}
    at = f"3D p={p} m={m} q=1 slab of {nzl} planes"
    for name, (kern, plain) in calls.items():
        lib = libs.get(HALO[name])
        if lib is not None:
            _hold(f"  library call for {name}", lib(), plain(), LIB_TOL)
        _time(report, name, at, kern, plain, lib,
              bound(name, 1, 1, nzl * m * m, p, 3, halo_points=2 * p * m * m))


def trace_events(prof) -> list[dict]:
    """The events of a finished ``torch.profiler`` session, from its Chrome
    trace."""
    import os
    import tempfile

    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def launch_attrs(fn, marker: str) -> list[dict]:
    """The launches of ``fn`` whose kernel name holds ``marker``, as the
    profiler's trace records them (CUPTI): grid, block, registers per thread
    and shared memory (static and dynamic) per block."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    keys = ("grid", "block", "registers per thread", "shared memory")
    return [{"name": e["name"], **{k: e.get("args", {}).get(k) for k in keys}}
            for e in trace_events(prof)
            if e.get("cat") == "kernel" and marker in e.get("name", "")]


# one-element adds that open every profiler session of ``device_ms``
# untimed: the trace holds no device record of a session's first launches
# (on the H100, 599 and 597 of 627 sessions none of the first and second
# primer's, 13 none of all eight; scripts/torch_profiler_records.py), so
# those launches must not be the timed ones.  Counting them as timed read
# the library calls' device time 10-15% low (reps calls, 17-18 recorded).
PRIMERS = 8
SPAN = "device_ms timed span"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_WORDS = ("aunch", "Memcpy", "Memset")  # host calls that put work on the device


def profiler_session(fn, reps: int) -> dict:
    """One ``torch.profiler`` session: PRIMERS untimed launches, then
    ``reps`` calls of ``fn`` in a span of their own.  Returns the device
    records (name, µs) of the work issued inside the span, matched to
    their host calls by correlation id, how many such host calls there
    were, how many of them left no record, and the places of the primers
    that left none."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    primer = torch.zeros(1, device=torch.device("cuda", torch.cuda.current_device()))
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(PRIMERS):
            primer.add_(1.0)
        torch.cuda.synchronize()
        with torch.profiler.record_function(SPAN):
            for _ in range(reps):
                fn()
        torch.cuda.synchronize()
    events = trace_events(prof)
    span = next((e for e in events
                 if e.get("name") == SPAN and e.get("cat") == "user_annotation"), None)
    if span is None:
        raise AssertionError(f"the profiler's trace holds no {SPAN!r}")
    t0, t1 = span["ts"], span["ts"] + span["dur"]
    records = {e.get("args", {}).get("correlation"): (e["name"], e["dur"])
               for e in events if e.get("cat") in DEVICE_CATS}
    issued = [(t0 <= e["ts"] <= t1, e.get("args", {}).get("correlation")) for e in events
              if e.get("cat", "").startswith("cuda_")  # the runtime's and the CUDA API's
              and any(w in e.get("name", "") for w in LAUNCH_WORDS)]
    timed = [c for inside, c in issued if inside]
    primed = [c for inside, c in issued if not inside]
    return {"records": [records[c] for c in timed if c in records], "issued": len(timed),
            "missing": sum(c not in records for c in timed),
            "primers_missing": [k for k, c in enumerate(primed) if c not in records]}


def device_ms(fn, marker: tuple[str, ...] | None, reps: int = 20) -> tuple[float | None, float]:
    """(device ms per launch of the kernels whose name holds one of
    ``marker``, or per call of every device op when ``marker`` is None;
    device ops per call) from ``torch.profiler`` over ``reps`` calls after
    a warm-up: the kernel alone, without the host's share of the call.
    Only a whole session counts, one in which every launch of the ``reps``
    calls left its record (``profiler_session``); it is run again, at most
    three times, and None is returned when none was whole or none saw the
    kernel."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        session = profiler_session(fn, reps)
        if session["records"] and not session["missing"]:
            break
    else:
        return None, 0.0
    recs = session["records"]
    sel = [us for name, us in recs if marker is None or any(mk in name for mk in marker)]
    if not sel:
        return None, len(recs) / reps
    return sum(sel) / 1e3 / (len(sel) if marker is not None else reps), len(recs) / reps


def sub_bound(row: dict, bound_ms: float, set_bytes: int) -> str:
    """Why a measurement turn cannot stand, or "" where it can: its kernel
    device time per launch below ``bound_ms``, the least time the DRAM
    allows, L2-cold, or L2-warm where one input set with its outputs
    (``set_bytes``) does not fit the L2 (a smaller set may be read from
    the L2 at a rate above the DRAM's, so its warm reading is not held)."""
    modes = ("cold", "warm") if set_bytes > L2_CACHE_BYTES else ("cold",)
    low = [f"{mode} {row[mode]['device_ms']:.4f} ms" for mode in modes
           if row[mode]["device_ms"] is not None and row[mode]["device_ms"] < bound_ms]
    return f"device time {', '.join(low)} below the bound {bound_ms:.4f} ms" if low else ""


def _rotating(fn, sets: list):
    """A call of ``fn`` on the next of ``sets`` (tuples of inputs) that keeps
    the last len(sets) results alive, so the caching allocator hands out
    other output blocks too: inputs and outputs come from DRAM, not L2."""
    keep, turn = [None] * len(sets), [0]

    def call():
        k = turn[0] % len(sets)
        turn[0] += 1
        keep[k] = fn(*sets[k])

    return call


def _transfer_setup(key: str, q: int, ref: int, p: int, device, field) -> dict:
    """K10's MEASURE_CASES entry at the finest pair of the refinement-``ref``
    Q``p`` hierarchy: its library call is its plain version (no one PyTorch
    call computes a transfer)."""
    from dealii_spirk_tpu_torch.fem.grid import make_space
    from dealii_spirk_tpu_torch.ops.cuda import transfer as tr
    from dealii_spirk_tpu_torch.solvers.gmg import build_gmg_data

    runs = build_gmg_data(make_space(3, p, ref), torch.float32, device).transfers[-1]
    m_f, m_c = runs.P.shape
    if key == "transfer_restrict":
        kern = lambda rl, ax: tr.restrict_residual(runs, rl, ax)  # noqa: E731
        plain = lambda rl, ax: tr.restrict_residual_ref(runs.P, rl, ax)  # noqa: E731
        make = lambda: (field(q, m_f, m_f, m_f), field(q, m_f, m_f, m_f))  # noqa: E731
    else:
        kern = lambda x, xc: tr.prolong_add(runs, x, xc)  # noqa: E731
        plain = lambda x, xc: tr.prolong_add_ref(runs.P, x, xc)  # noqa: E731
        make = lambda: (field(q, m_f, m_f, m_f), field(q, m_c, m_c, m_c))  # noqa: E731
    return {
        "kern": kern, "plain": plain, "lib": plain, "make": make,
        "bytes": 4 * q * (2 * m_f**3 + m_c**3),
        "at": f"3D p={p} m={m_f} <- {m_c} q={q}",
        "library": "the plain version (dense tensordot + movedim per axis)",
        "bound": transfer_bound(q, m_f, m_c),
    }


def _measure_setup(key: str, dim: int, qi: int, qo: int, ref: int, p: int, device) -> dict:
    """One MEASURE_CASES entry: the kernel call, its plain version and its
    library call (None where no PyTorch call computes the function: above
    p = 1 the band rows vary by node class, so no one convolution weight
    holds them) on one input set, a maker of input sets, the bytes of one
    set with its outputs, the bound."""
    from dealii_spirk_tpu_torch.fem.grid import make_level
    from dealii_spirk_tpu_torch.ops.cuda import stencil as st
    from dealii_spirk_tpu_torch.ops.mass_laplace import level_ops, slab_ops
    from dealii_spirk_tpu_torch.parallel.sharding import z_partition

    ops = level_ops(make_level(ref, p), torch.float32, device)
    m = ops.m
    seed = 7 * ref + qi + 10 * qo + 100 * (p - 1)
    rng, gen = np.random.default_rng(seed), device_generator(device, seed)
    q1 = p == 1  # a library call computes K4, K5 and K1 at p = 1 only

    def field(*shape):
        return uniform_field(shape, -1.0, 1.0, device, gen)

    def vec(lo, hi):
        return torch.as_tensor(rng.uniform(lo, hi, qi), dtype=torch.float32, device=device)

    if key == "stage_mix":
        mat = torch.as_tensor(rng.uniform(-1, 1, (qo, qi)), dtype=torch.float32, device=device)
        return {
            "kern": lambda W: st.stage_mix(mat, W),
            "plain": lambda W: st.stage_mix_ref(mat, W),
            "lib": lambda W: (mat @ W.reshape(qi, -1)).view((qo,) + W.shape[1:]),
            "make": lambda: (field(qi, *(m,) * dim),),
            "bytes": 4 * (qi + qo) * m**dim,
            "at": f"{dim}D m={m} ({qo}x{qi})", "library": "GEMM mat @ W",
            "bound": bound(key, qi, qo, m**dim, p, dim),
        }
    a = vec(0.5, 2.0)
    if key == "stencil_apply_2d":
        return {
            "kern": lambda u: st.stencil_apply(ops, a, 0.1, u),
            "plain": lambda u: st.stencil_apply_ref(ops, a, 0.1, u),
            "lib": shifted_conv(ops, qi, dim, a, 0.1) if q1 else None,
            "make": lambda: (field(qi, *(m,) * dim),),
            "bytes": 4 * (qi + qo) * m**dim,
            "at": f"{dim}D p={p} m={m} q={qi}", "library": "grouped conv2d" if q1 else "none",
            "bound": bound(key, qi, qo, m**dim, p, dim),
        }
    if key == "mass_stiffness_apply_2d":
        return {
            "kern": lambda u: st.mass_stiffness_apply(ops, u),
            "plain": lambda u: st.mass_stiffness_apply_ref(ops, u),
            "lib": ms_conv(ops, qi, dim) if q1 else None,
            "make": lambda: (field(qi, *(m,) * dim),),
            "bytes": 4 * 3 * qi * m**dim,
            "at": f"{dim}D p={p} m={m} q={qi}", "library": "grouped conv2d" if q1 else "none",
            "bound": bound(key, qi, qo, m**dim, p, dim),
        }
    if key in ("transfer_restrict", "transfer_prolong"):
        return _transfer_setup(key, qi, ref, p, device, field)
    if key == "cheb_pair_dg":
        # K8 beside the two K3dg launches that compute the same two steps
        # (``twin``: other kernels of the port, not a library call)
        c1a, c2a, c1b, c2b = vec(0.2, 0.9), vec(0.1, 0.5), vec(0.2, 0.9), vec(0.1, 0.5)

        def two_k3dg(d, r, x):
            r1, d1, x1 = st.cheb_iter_dg(ops, a, 0.1, c1a, c2a, d, r, x)
            return st.cheb_iter_dg(ops, a, 0.1, c1b, c2b, d1, r1, x1)

        return {
            "kern": lambda *f: st.cheb_pair_dg(ops, a, 0.1, c1a, c2a, c1b, c2b, *f),
            "plain": lambda *f: st.cheb_pair_dg_ref(ops, a, 0.1, c1a, c2a, c1b, c2b, *f),
            "lib": None, "twin": two_k3dg, "twin_name": "two K3dg launches",
            "make": lambda: tuple(field(qi, m, m, m) for _ in range(3)),
            "bytes": 4 * 6 * qi * m**3,
            "at": f"3D p={p} m={m} q={qi}", "library": "none",
            "bound": bound(key, qi, qi, m**3, p, 3),
        }
    # the 3D stencil kernels, whole field or the first of two z slabs (one
    # stage); the halo forms' operand carries p planes of each neighbour
    halo = p if key in HALO else 0
    nz = z_partition(m, 2)[0][1] if halo else m
    sops = slab_ops(ops, 0, nz) if halo else ops
    at = f"3D p={p} m={m} q={qi}" + (f" slab of {nz} planes" if halo else "")
    own = (qi, nz, m, m)

    def operand():
        # a slab's operand: zeros below the domain (the exchange's planes there)
        u = field(qi, nz + 2 * halo, m, m)
        u[:, :halo] = 0.0
        return u

    if HALO.get(key, key) == "stencil_apply":
        kern, plain = (st.stencil_apply_halo, st.stencil_apply_halo_ref) if halo else (
            st.stencil_apply, st.stencil_apply_ref)
        return {
            "kern": lambda u: kern(sops, a, 0.1, u),
            "plain": lambda u: plain(sops, a, 0.1, u),
            "lib": shifted_conv(ops, qi, 3, a, 0.1, (0, 1, 1) if halo else 1) if q1 else None,
            "make": lambda: (operand(),),
            "bytes": 4 * qi * (2 * nz + 2 * halo) * m * m,
            "at": at, "library": "grouped conv3d" if q1 else "none",
            "bound": bound(key, qi, qi, nz * m * m, p, 3, halo_points=2 * halo * m * m),
        }
    if HALO.get(key, key) == "mass_stiffness_apply":
        kern = st.mass_stiffness_apply_halo if halo else st.mass_stiffness_apply
        plain = st.mass_stiffness_apply_halo_ref if halo else st.mass_stiffness_apply_ref
        return {
            "kern": lambda u: kern(sops, u),
            "plain": lambda u: plain(sops, u),
            "lib": ms_conv(ops, qi, 3, (0, 1, 1) if halo else 1) if q1 else None,
            "make": lambda: (operand(),),
            "bytes": 4 * qi * (3 * nz + 2 * halo) * m * m,
            "at": at, "library": "grouped conv3d" if q1 else "none",
            "bound": bound(key, qi, qi, nz * m * m, p, 3, halo_points=2 * halo * m * m),
        }
    if key == "ms_mix_apply_split":
        return {
            "kern": lambda v, u: st.ms_mix_apply_split(ops, 0.1, v, u),
            "plain": lambda v, u: st.ms_mix_apply_split_ref(ops, 0.1, v, u),
            "lib": None,
            "make": lambda: (operand(), operand()),
            "bytes": 4 * qi * 3 * m**3,
            "at": at, "library": "none",
            "bound": bound(key, qi, qi, m**3, p, 3),
        }
    if key == "ms_mix_apply":
        ainv = torch.as_tensor(rng.uniform(-2, 2, (qi, qi)), dtype=torch.float32, device=device)
        return {
            "one_launch": bool(st.mix_tile(qi, p)),
            "kern": lambda u: st.ms_mix_apply(ops, ainv, 0.1, u),
            "plain": lambda u: st.ms_mix_apply_ref(ops, ainv, 0.1, u),
            "lib": ms_mix_conv(ops, ainv, 0.1) if q1 else None,
            "make": lambda: (operand(),),
            "bytes": 4 * qi * 2 * m**3,
            "at": at, "library": "dense conv3d" if q1 else "none",
            "bound": bound(key, qi, qi, m**3, p, 3),
        }
    # K3, K3dg and their slab forms: d, r, x (and K3's D^-1) in; r', d', x' out
    c1, c2 = vec(0.2, 0.9), vec(0.1, 0.5)
    fns = {
        "cheb_iter": (st.cheb_iter, st.cheb_iter_ref),
        "cheb_iter_halo": (st.cheb_iter_halo, st.cheb_iter_halo_ref),
        "cheb_iter_dg": (st.cheb_iter_dg, st.cheb_iter_dg_ref),
        "cheb_iter_dg_halo": (st.cheb_iter_dg_halo, st.cheb_iter_dg_halo_ref),
    }
    kern, plain = fns[key]
    fields = PASSES[HALO.get(key, key)] - 4  # r, x and K3's D^-1 (in 0.5 .. 1.5)
    return {
        "kern": lambda d, *rest: kern(sops, a, 0.1, c1, c2, d, *rest),
        "plain": lambda d, *rest: plain(sops, a, 0.1, c1, c2, d, *rest),
        "lib": None,
        "make": lambda: (operand(),) + tuple(
            field(*own) if i < 2 else field(*own).abs_().add_(0.5) for i in range(fields)),
        "bytes": 4 * qi * (PASSES[HALO.get(key, key)] * nz + 2 * halo) * m * m,
        "at": at, "library": "none",
        "bound": bound(key, qi, qi, nz * m * m, p, 3, halo_points=2 * halo * m * m),
    }


def measure_kernels(device, cases=None) -> list[dict]:
    """The measurement phase (``cases``, default MEASURE_CASES): per case the
    kernel wrapper and, where there is one, its library call (K2: the GEMM
    ``mat @ W``, which is also its plain version; K4-2D: cuDNN's grouped
    ``conv2d``, f32 without TF32; K3dg and K9d: none) on the same inputs, in
    TURNS turns.  Each turn takes the time per call from CUDA events over
    20 back-to-back calls (``timed_calls``, host work included, and the
    host's own time per call beside it) in the order kernel, library,
    library, kernel (K8: its two K3dg launches in the library's place;
    kernel, kernel without either), L2-warm (one
    input set, as the kernels phase times) and L2-cold (rotating over input
    and output sets of twice the L2's size); then the device time per
    launch from ``torch.profiler`` (``device_ms``), warm and cold: the
    kernel alone (DEVICE_NAMES), and the library call's (two K3dg
    launches') device ops summed.
    The cold times are the ones held against the HBM bound; a case's
    figures are the least over the turns that ``sub_bound`` keeps, printed
    with the median of those turns beside it (a low reading just above the
    bound is kept, and the least leans towards it): a turn
    whose kernel device time lies below the bound, L2-cold, or L2-warm where
    one input set with its outputs outgrows the L2, is impossible, so it
    is printed as dropped and left out; a case whose every turn drops
    fails the phase."""
    results = []
    for key, dim, qi, qo, ref, p in MEASURE_CASES if cases is None else cases:
        c = _measure_setup(key, dim, qi, qo, ref, p, device)
        kern, lib, at, library, bnd = c["kern"], c["lib"], c["at"], c["library"], c["bound"]
        twin = c.get("twin")
        n_sets = max(2, -(-2 * L2_CACHE_BYTES // c["bytes"]))
        sets = [c["make"]() for _ in range(n_sets)]
        warm = {"kernel": lambda: kern(*sets[0])}
        cold = {"kernel": _rotating(kern, sets)}
        if lib is not None:
            warm["library"], cold["library"] = (lambda: lib(*sets[0])), _rotating(lib, sets)
        if twin is not None:
            warm["twin"], cold["twin"] = (lambda: twin(*sets[0])), _rotating(twin, sets)
        other = "library" if lib is not None else "twin" if twin is not None else None
        order = ("kernel", other, other, "kernel") if other else ("kernel",) * 2
        marker = DEVICE_NAMES.get(key, (key,))
        if key == "ms_mix_apply" and not c["one_launch"]:
            marker = None  # K1's route: K2 and the split march, every device op of a call
        fmt = lambda v: "not seen" if v is None else f"{v:.4f}"  # noqa: E731
        turns = []
        for t in range(TURNS):
            row = {}
            for mode, calls in (("warm", warm), ("cold", cold)):
                timed = [(w, timed_calls(calls[w])) for w in order]
                kt = [t for w, t in timed if w == "kernel"]
                kd, kops = device_ms(calls["kernel"], marker)
                row[mode] = {"ms": sum(t[0] for t in kt) / 2, "host_ms": sum(t[1] for t in kt) / 2,
                             "device_ms": kd, "device_ops_per_call": kops}
                if lib is not None:
                    lt = [t for w, t in timed if w == "library"]
                    ld, lops = device_ms(calls["library"], None)
                    row[mode] |= {"library_ms": sum(t[0] for t in lt) / 2,
                                  "library_host_ms": sum(t[1] for t in lt) / 2,
                                  "library_device_ms": ld, "library_device_ops_per_call": lops}
                if twin is not None:
                    tt = [t for w, t in timed if w == "twin"]
                    td, tops = device_ms(calls["twin"], None)
                    row[mode] |= {"twin_ms": sum(t[0] for t in tt) / 2,
                                  "twin_device_ms": td, "twin_device_ops_per_call": tops}
            w_, c_ = row["warm"], row["cold"]
            line = (f"measure {key} {at} turn {t + 1} (kernel / {library}, ms): per call warm "
                    f"{w_['ms']:.4f}, cold {c_['ms']:.4f}; device per launch warm "
                    f"{fmt(w_['device_ms'])}, cold {fmt(c_['device_ms'])}; host per call warm "
                    f"{w_['host_ms']:.4f}; device ops per call {w_['device_ops_per_call']:g}")
            if lib is not None:
                row["held"] = (w_["ms"] <= w_["library_ms"]
                               and None not in (w_["device_ms"], w_["library_device_ms"])
                               and w_["device_ms"] <= w_["library_device_ms"])
                line += (f"; library per call warm {w_['library_ms']:.4f}, cold "
                         f"{c_['library_ms']:.4f}, device warm {fmt(w_['library_device_ms'])}, "
                         f"cold {fmt(c_['library_device_ms'])}, host {w_['library_host_ms']:.4f},"
                         f" device ops {w_['library_device_ops_per_call']:g}; kernel at or below"
                         f" the library warm, per call and on the device: {row['held']}")
            if twin is not None:
                line += (f"; {c['twin_name']} per call warm {w_['twin_ms']:.4f}, cold "
                         f"{c_['twin_ms']:.4f}, device warm {fmt(w_['twin_device_ms'])}, cold "
                         f"{fmt(c_['twin_device_ms'])}, device ops {w_['twin_device_ops_per_call']:g}")
            row["dropped"] = sub_bound(row, bnd[0], c["bytes"])
            if row["dropped"]:
                line += f"; DROPPED: {row['dropped']}"
            turns.append(row)
            say(line)
        kept = [r for r in turns if not r["dropped"]]
        if not kept:
            raise AssertionError(f"measure {key} {at}: every turn read below the bound "
                                 f"{bnd[0]:.4f} ms")

        def least(mode, k, pick=min):
            vals = [r[mode][k] for r in kept if r[mode].get(k) is not None]
            return pick(vals) if vals else None

        def median(mode, k):
            return least(mode, k, lambda vals: float(np.median(vals)))

        res = {
            "key": key, "at": f"{at}, L2-cold over {n_sets} sets", "library": library,
            "bound_ms": bnd[0], "bound_by": bnd[1],
            "ms": least("warm", "ms"), "cold_ms": least("cold", "ms"),
            "device_ms": least("warm", "device_ms"), "cold_device_ms": least("cold", "device_ms"),
            "median_cold_ms": median("cold", "ms"),
            "median_device_ms": median("warm", "device_ms"),
            "median_cold_device_ms": median("cold", "device_ms"),
            "library_ms": least("warm", "library_ms"),
            "library_cold_ms": least("cold", "library_ms"),
            "library_device_ms": least("warm", "library_device_ms"),
            "library_cold_device_ms": least("cold", "library_device_ms"),
            "held_every_turn": all(r["held"] for r in kept) if lib is not None else None,
            "turns": turns, "dropped_turns": len(turns) - len(kept),
        }
        if twin is not None:
            res |= {"twin": c["twin_name"], "twin_ms": least("warm", "twin_ms"),
                    "twin_cold_ms": least("cold", "twin_ms"),
                    "twin_device_ms": least("warm", "twin_device_ms"),
                    "twin_cold_device_ms": least("cold", "twin_device_ms")}
        say(f"measure {key} {at}: bound {bnd[0]:.4f} ms ({bnd[1]}); L2-cold per call "
            f"{res['cold_ms']:.4f} ms (bound / time {bnd[0] / res['cold_ms']:.3f}; median "
            f"{res['median_cold_ms']:.4f}), on the device {fmt(res['cold_device_ms'])} ms"
            + ("" if res["cold_device_ms"] is None
               else f" (bound / time {bnd[0] / res['cold_device_ms']:.3f}; median "
                    f"{fmt(res['median_cold_device_ms'])})")
            + f" over {len(kept)} kept turns"
            + ("" if lib is None else
               f"; at or below the library in every turn: {res['held_every_turn']}")
            + ("" if twin is None else
               f"; {c['twin_name']} L2-cold on the device {fmt(res['twin_cold_device_ms'])} ms"))
        results.append(res)
        del sets, warm, cold, c
        torch.cuda.empty_cache()
    return results


# the diagnostic arms (``measure_arms``): (LAUNCHES key, q, refinement,
# degree) — K3dg at P4's 255 level at p = 1 (six lanes), P16's 191 and P17's
# 255 levels (q=4); K3 at P20's 127 level (six lanes, Q4) and P17's (q=4); K4
# at P20's 127 level and P17's 255 level; K5 at P20's vmult (six lanes, Q4);
# K1 at P16's finest level (q=4, Q3)
ARM_CASES = [("cheb_iter_dg", 6, 8, 1), ("cheb_iter_dg", 4, 6, 3), ("cheb_iter_dg", 4, 6, 4),
             ("cheb_iter", 6, 5, 4), ("cheb_iter", 4, 5, 4),
             ("stencil_apply", 6, 5, 4), ("stencil_apply", 4, 6, 4),
             ("mass_stiffness_apply", 6, 5, 4), ("ms_mix_apply", 4, 6, 3)]
ARMS = {"kernel": 0, "passes only": 1, "copies only": 2}
# per key: the kernel's name, its arms' entry point (csrc/cheb_iter.cu,
# csrc/stencil_apply.cu, csrc/mass_stiffness_apply.cu, csrc/ms_mix_apply.cu)
# and its outputs
ARM_ENTRIES = {"cheb_iter": ("K3", "spirk_cheb_iter_arm", 3),
               "cheb_iter_dg": ("K3dg", "spirk_cheb_iter_dg_arm", 3),
               "stencil_apply": ("K4", "spirk_stencil_apply_arm", 1),
               "mass_stiffness_apply": ("K5", "spirk_mass_stiffness_apply_arm", 2),
               "ms_mix_apply": ("K1", "spirk_ms_mix_apply_arm", 1)}


def march_arm(key: str, call, arm: int):
    """``call()``, a call of the wrapper ``key`` (K3, K3dg, K4, K5 or K1 on
    its Mix form), in one of the kernel's diagnostic arms (ARM_ENTRIES; 0:
    the kernel itself): 1 the passes and the update on resident planes, no
    copy and no store; 2 the copies and stores alone (r' = r, d' = d, x' =
    x; K4, K5, K1: every output the operand).  The wrapper's launch goes to
    the arms' entry point with the same arguments (so on the wrapper's plan
    and tables) and the arm; its LAUNCHES count is left as it was."""
    from dealii_spirk_tpu_torch.ops.cuda import stencil as st

    if arm == 0:
        return call()
    entry, kernel = ARM_ENTRIES[key][1], "spirk_" + key
    real, count = st._launch_raw, st.LAUNCHES[key]

    def launch(name, device, *args):
        if name != kernel:
            raise RuntimeError(f"{key}'s arms take one launch of {kernel}, not {name}")
        real(entry, device, *args, arm)

    st._launch_raw = launch
    try:
        return call()
    finally:
        st._launch_raw = real
        st.LAUNCHES[key] = count


def measure_arms(device, keys=tuple(ARM_ENTRIES)) -> list[dict]:
    """The ARM_CASES of ``keys`` in each of ARMS, in TURNS turns of every arm
    in order: device time per launch from ``torch.profiler`` and time per
    call from CUDA events, L2-cold (rotating input sets), the least over the
    turns.  The passes-only arm is what the shared-memory passes take with
    no DRAM traffic, the copies-only arm what the memory pipeline takes
    with no pass; numbers, not gates."""
    from dealii_spirk_tpu_torch.fem.grid import make_level
    from dealii_spirk_tpu_torch.ops.cuda import stencil as st
    from dealii_spirk_tpu_torch.ops.mass_laplace import level_ops

    out = []
    for key, q, ref, p in ARM_CASES:
        if key not in keys or (key == "ms_mix_apply" and not st.mix_tile(q, p)):
            continue  # (K1's route has no arms)
        ops = level_ops(make_level(ref, p), torch.float32, device)
        m = ops.m
        gen = device_generator(device, 7 * ref + p)
        a, c1, c2 = (torch.linspace(lo, lo + 1, q, device=device) for lo in (0.5, 0.2, 0.1))
        ainv = torch.linspace(-1.0, 1.0, q * q, device=device).reshape(q, q)
        wrapper = getattr(st, key)

        def run(*f):  # the wrapper of ``key`` on the fields f
            if key == "mass_stiffness_apply":
                return wrapper(ops, *f)
            if key == "ms_mix_apply":
                return wrapper(ops, ainv, 0.1, *f)
            return wrapper(ops, a, 0.1, *((c1, c2) if key != "stencil_apply" else ()), *f)

        # d (K4, K5, K1: u), r, x and K3's D^-1 (0.5 .. 1.5)
        n_fields = PASSES[key] - ARM_ENTRIES[key][2]
        n_sets = max(2, -(-2 * L2_CACHE_BYTES // (4 * PASSES[key] * q * m**3)))
        sets = [tuple(uniform_field((q, m, m, m), -1.0, 1.0, device, gen).abs_().add_(0.5)
                      if i == 3 else uniform_field((q, m, m, m), -1.0, 1.0, device, gen)
                      for i in range(n_fields)) for _ in range(n_sets)]
        bnd = bound(key, q, q, m**3, p, 3)
        row = {"name": ARM_ENTRIES[key][0], "at": f"3D p={p} m={m} q={q}", "bound_ms": bnd[0]}
        for _turn in range(TURNS):
            for name, arm in ARMS.items():
                call = _rotating(lambda *f, arm=arm: march_arm(key, lambda: run(*f), arm), sets)
                ms = timed_calls(call)[0]
                dev = device_ms(call, DEVICE_NAMES[key])[0]
                best = row.setdefault(name, {"cold_ms": ms, "cold_device_ms": dev})
                best["cold_ms"] = min(best["cold_ms"], ms)
                if dev is not None and (best["cold_device_ms"] is None
                                        or dev < best["cold_device_ms"]):
                    best["cold_device_ms"] = dev
        fmt = lambda v: "not seen" if v is None else f"{v:.4f}"  # noqa: E731
        say(f"arms {row['name']} {row['at']}, L2-cold, least of {TURNS} turns (device per "
            f"launch / per call, ms): " + "; ".join(
                f"{name} {fmt(row[name]['cold_device_ms'])} / {row[name]['cold_ms']:.4f}"
                for name in ARMS) + f"; DRAM bound {bnd[0]:.4f}")
        out.append(row)
        del sets
        torch.cuda.empty_cache()
    return out


def smooth_cases_2d(device):
    """P3's 2D kernels at its finest level on u_i = (1 + i / 10) sin(pi x)
    sin(2 pi y) + 0.3: (name, where, kernel, f32 plain, f64 plain)."""
    from dealii_spirk_tpu_torch.fem.grid import make_level
    from dealii_spirk_tpu_torch.ops.cuda import stencil as st
    from dealii_spirk_tpu_torch.ops.mass_laplace import level_ops
    from dealii_spirk_tpu_torch.tables import irk_tables

    dim, cfg, _L = PATHS["P3"]
    q, level = cfg["IRKStages"], make_level(cfg["NRefinements"], 1)
    o32, o64 = (level_ops(level, dt, device) for dt in (torch.float32, torch.float64))
    m = o32.m
    x = torch.arange(1, m + 1, dtype=torch.float64, device=device) / (m + 1)
    mode = torch.sin(np.pi * x)[:, None] * torch.sin(2 * np.pi * x)[None, :]
    u32 = torch.stack([(1 + i / 10) * mode + 0.3 for i in range(q)]).float()
    u64 = u32.double()
    a = torch.linspace(1.5, 4.5, q, dtype=torch.float64, device=device)
    ainv = torch.as_tensor(irk_tables(q).A_inv, dtype=torch.float64, device=device)
    at = f"2D m={m} q={q}, smooth"
    yield ("mass_stiffness_apply_2d", at, lambda: st.mass_stiffness_apply(o32, u32)[1],
           lambda: st.mass_stiffness_apply_ref(o32, u32)[1],
           lambda: st.mass_stiffness_apply_ref(o64, u64)[1])
    yield ("stencil_apply_2d", at, lambda: st.stencil_apply(o32, a.float(), 0.1, u32),
           lambda: st.stencil_apply_ref(o32, a.float(), 0.1, u32),
           lambda: st.stencil_apply_ref(o64, a, 0.1, u64))
    yield ("stage_mix", at, lambda: st.stage_mix(ainv.float(), u32),
           lambda: st.stage_mix_ref(ainv.float(), u32), lambda: st.stage_mix_ref(ainv, u64))


def _smooth_block(device, ref: int, q: int | None = None, p: int = 1):
    """P4's six V-cycle lanes (or ``q`` lanes) on its level of refinement
    ``ref`` at degree ``p``:
    (o32, o64, at, (a, c1, c2) in f64, d, r, x) with d_i = (1 + i / 10)
    sin(pi x) sin(2 pi y) sin(pi z) + 0.3, x_i = (1 + i / 10) sin(2 pi x)
    sin(pi y) sin(3 pi z), and r_i = s x_i with s = max|(a_i M + b K) d_i|,
    so that r' = r - (a_i M + b K) d_i is of the apply's size (a smoother's
    residual) and its rounding stays in sight; d, r, x in f32."""
    from dealii_spirk_tpu_torch.fem.grid import make_level
    from dealii_spirk_tpu_torch.ops.cuda import stencil as st
    from dealii_spirk_tpu_torch.ops.mass_laplace import level_ops

    q = 2 * ((PATHS["P4"][1]["IRKStages"] + 1) // 2) if q is None else q
    level = make_level(ref, p)
    o32, o64 = (level_ops(level, dt, device) for dt in (torch.float32, torch.float64))
    m = o32.m
    z = torch.arange(1, m + 1, dtype=torch.float64, device=device) / (m + 1)
    sin = lambda k: torch.sin(k * np.pi * z)  # noqa: E731
    mode_d = sin(1)[:, None, None] * sin(2)[None, :, None] * sin(1)[None, None, :]
    mode_x = sin(3)[:, None, None] * sin(1)[None, :, None] * sin(2)[None, None, :]
    lanes = [1 + i / 10 for i in range(q)]
    coefs = tuple(torch.linspace(lo, hi, q, dtype=torch.float64, device=device)
                  for lo, hi in ((1.5, 4.5), (0.3, 0.8), (0.1, 0.4)))
    d = torch.stack([w * mode_d + 0.3 for w in lanes]).float()
    del mode_d
    scale = float(st.stencil_apply_ref(o64, coefs[0], SMOOTH_B, d.double()).abs().max())
    x = torch.stack([w * mode_x for w in lanes]).float()
    r = (scale * x.double()).float()
    return o32, o64, f"3D p={p} m={m} q={q}, smooth", coefs, d, r, x


def _smooth_arms(name: str, at: str, arms: dict, outputs=(None,)):
    """The rows of one kernel on a smooth field, one per output (``outputs``
    names them; None: one output): (name, where, kernel, f32 plain, f64
    plain), ``arms`` the three calls; one arm's outputs are held at a time
    (f64 at m = 255: 0.8 GB a field)."""
    outs = {}

    def output(arm: str, k):
        if arm not in outs:
            outs.clear()
            outs[arm] = arms[arm]()
        return outs[arm] if k is None else outs[arm][k]

    for k, out in enumerate(outputs):
        k = None if out is None else k
        yield (name if out is None else f"{name} {out}", at,
               *(lambda arm=arm, k=k: output(arm, k) for arm in ("kernel", "plain", "exact")))


def smooth_cases_3d(device):
    """The 3D kernels on P4's six lanes of smooth fields (``_smooth_block``):
    K3dg's r', d', x', K8's r2, d2, x2 (both steps with K3dg's a, c1, c2),
    K4's (a_i M + b K) d and K5's M d and K d at the 255 level, K9b's on
    the first of its two z slabs (``_smooth_cases_march``); K3's r', d', x'
    at the 127 level (``_smooth_cases_k3``); K1 at P1's finest level with
    P1's A^-1 and tau (``_smooth_cases_k1``)."""
    fine = PATHS["P4"][1]["NRefinements"]
    yield from _smooth_cases_march(device, fine, rows=(
        "cheb_iter_dg", "cheb_pair_dg", "stencil_apply", "mass_stiffness_apply",
        "mass_stiffness_apply_halo"))
    yield from _smooth_cases_k3(device, fine - 1)
    yield from _smooth_cases_k1(device)


def smooth_cases_degree(device):
    """The degree sweep's kernels on smooth fields: K3dg, K4 and K5 at P16's
    191 and P17's 255 levels (q=4, Q3 and Q4), K3 one level down, K1 at
    P16's and P17's finest levels, K1's route K2 + ms_mix_apply_split at
    P19's, and K9b on the first slab of P18's finest level (4-plane
    halos)."""
    for path in ("P16", "P17"):
        cfg = PATHS[path][1]
        q, p, ref = cfg["IRKStages"], cfg["FEDegree"], cfg["NRefinements"]
        yield from _smooth_cases_march(device, ref, q, p, (
            "cheb_iter_dg", "stencil_apply", "mass_stiffness_apply"))
        yield from _smooth_cases_k3(device, ref - 1, q, p)
    yield from _smooth_cases_k1(device, "P16")
    yield from _smooth_cases_k1(device, "P17")
    yield from _smooth_cases_k1(device, "P19")
    cfg = PATHS["P18"][1]
    yield from _smooth_cases_march(device, cfg["NRefinements"], cfg["IRKStages"],
                                   cfg["FEDegree"], ("mass_stiffness_apply_halo",))


def _smooth_cases_march(device, ref: int, q: int | None = None, p: int = 1, rows=()):
    """The ``rows`` (each a kernel: its outputs one row each) on the smooth
    block of ``_smooth_block(device, ref, q, p)``: K3dg's r', d', x' and
    K8's r2, d2, x2 (both steps with K3dg's a, c1, c2), K4's (a_i M + b K) d,
    K5's M d and K d, and K9b's on the first of two z slabs."""
    from dealii_spirk_tpu_torch.ops.cuda import stencil as st
    from dealii_spirk_tpu_torch.ops.mass_laplace import slab_ops
    from dealii_spirk_tpu_torch.parallel.sharding import z_partition

    b = SMOOTH_B
    o32, o64, at, (a, c1, c2), d, r, x = _smooth_block(device, ref, q, p)
    a32, c132, c232 = a.float(), c1.float(), c2.float()
    cases = {
        "cheb_iter_dg": (at, {
            "kernel": lambda: st.cheb_iter_dg(o32, a32, b, c132, c232, d, r, x),
            "plain": lambda: st.cheb_iter_dg_ref(o32, a32, b, c132, c232, d, r, x),
            "exact": lambda: st.cheb_iter_dg_ref(o64, a, b, c1, c2, d.double(), r.double(),
                                                 x.double()),
        }, ("r'", "d'", "x'")),
        "cheb_pair_dg": (at, {
            "kernel": lambda: st.cheb_pair_dg(o32, a32, b, c132, c232, c132, c232, d, r, x),
            "plain": lambda: st.cheb_pair_dg_ref(o32, a32, b, c132, c232, c132, c232, d, r, x),
            "exact": lambda: st.cheb_pair_dg_ref(o64, a, b, c1, c2, c1, c2, d.double(),
                                                 r.double(), x.double()),
        }, ("r2", "d2", "x2")),
        "stencil_apply": (at, {
            "kernel": lambda: st.stencil_apply(o32, a32, b, d),
            "plain": lambda: st.stencil_apply_ref(o32, a32, b, d),
            "exact": lambda: st.stencil_apply_ref(o64, a, b, d.double()),
        }, (None,)),
        "mass_stiffness_apply": (at, {
            "kernel": lambda: st.mass_stiffness_apply(o32, d),
            "plain": lambda: st.mass_stiffness_apply_ref(o32, d),
            "exact": lambda: st.mass_stiffness_apply_ref(o64, d.double()),
        }, ("M u", "K u")),
    }
    if "mass_stiffness_apply_halo" in rows:
        m = o32.m
        nzl = z_partition(m, 2)[0][1]
        s32, s64 = slab_ops(o32, 0, nzl), slab_ops(o64, 0, nzl)
        d_h = torch.cat([torch.zeros_like(d[:, :p]), d[:, : nzl + p]], dim=1)
        cases["mass_stiffness_apply_halo"] = (f"{at}, slab of {nzl} planes", {
            "kernel": lambda: st.mass_stiffness_apply_halo(s32, d_h),
            "plain": lambda: st.mass_stiffness_apply_halo_ref(s32, d_h),
            "exact": lambda: st.mass_stiffness_apply_halo_ref(s64, d_h.double()),
        }, ("M u", "K u"))
    for name in rows:
        where, arms, outputs = cases[name]
        yield from _smooth_arms(name, where, arms, outputs)


def _smooth_cases_k1(device, path: str = "P1"):
    """K1 on a path's stages of smooth fields (``_smooth_block`` with its q
    and degree) at its finest level, with its A^-1 (Radau IIA) and tau (its
    time step): P1's, or where no K1 block holds the q rings (P19) the
    route K2 + ms_mix_apply_split that the wrapper takes."""
    from dealii_spirk_tpu_torch.ops.cuda import stencil as st
    from dealii_spirk_tpu_torch.tables import irk_tables

    cfg = PATHS[path][1]
    q, tau, p = cfg["IRKStages"], cfg["TimeStepSize"], cfg["FEDegree"]
    o32, o64, at, _coefs, u, _r, _x = _smooth_block(device, cfg["NRefinements"], q, p)
    del _r, _x
    ainv = torch.as_tensor(irk_tables(q).A_inv, dtype=torch.float64, device=device)
    a32 = ainv.float()
    name = "ms_mix_apply" if st.mix_tile(q, p) else "ms_mix_apply (K2 + ms_mix_apply_split)"
    yield from _smooth_arms(name, at, {
        "kernel": lambda: st.ms_mix_apply(o32, a32, tau, u),
        "plain": lambda: st.ms_mix_apply_ref(o32, a32, tau, u),
        "exact": lambda: st.ms_mix_apply_ref(o64, ainv, tau, u.double()),
    })


def _smooth_cases_k3(device, ref: int, q: int | None = None, p: int = 1):
    """K3 on the smooth fields of ``_smooth_block`` at refinement ``ref``
    with that level's D^-1 field: the inverse of the exact diagonal of a_i M
    + b K, rounded to f32 (the same input for every arm)."""
    from dealii_spirk_tpu_torch.ops.cuda import stencil as st
    from dealii_spirk_tpu_torch.ops.mass_laplace import operator_diagonal

    b = SMOOTH_B
    o32, o64, at, (a, c1, c2), d, r, x = _smooth_block(device, ref, q, p)
    a32, c132, c232 = a.float(), c1.float(), c2.float()
    invd = (1.0 / operator_diagonal(o64, a, b, 3)).float()
    yield from _smooth_arms("cheb_iter", at, {
        "kernel": lambda: st.cheb_iter(o32, a32, b, c132, c232, d, r, x, invd),
        "plain": lambda: st.cheb_iter_ref(o32, a32, b, c132, c232, d, r, x, invd),
        "exact": lambda: st.cheb_iter_ref(o64, a, b, c1, c2, d.double(), r.double(),
                                          x.double(), invd.double()),
    }, ("r'", "d'", "x'"))


def smooth_bias(device) -> list[dict]:
    """Kernels on a smooth field: P3's 2D kernels of its vmult and V-cycle
    at its finest level (``smooth_cases_2d``) and the V-cycle's 3D kernels
    at P4's levels, K3dg and K4 at 255, K3 at 127 (``smooth_cases_3d``):
    the mean and the largest error of each f32 kernel and
    of its f32 plain version against the plain version in f64 on the same
    inputs, relative to max|f64|.  Random fields (the kernels phase) cannot
    show it: for a smooth field K u is a 1e-5 share of its terms at m =
    1023, and a rounding error that follows the field passes the outer
    GMRES into the solution."""
    out = []
    for cases in (smooth_cases_2d(device), smooth_cases_3d(device),
                  smooth_cases_degree(device)):
        for row in smooth_rows(cases):
            if abs(row["kernel_mean"]) > row["limit"]:
                raise AssertionError(f"{row['name']}: a rounding error that follows the field")
            out.append(row)
        torch.cuda.empty_cache()
    return out


def smooth_rows(cases):
    """Per case of ``smooth_cases_2d`` / ``smooth_cases_3d``: the kernel's and the f32
    plain version's mean and largest error against f64, of max|f64|, and the
    limit on the kernel's |mean| (SMOOTH_BIAS, SMOOTH_FLOOR); printed."""
    for name, at, kern, plain, exact in cases:
        want = exact().double()
        scale = float(want.abs().max())
        row = {"name": name, "at": at}
        for arm, fn in (("kernel", kern), ("plain", plain)):
            err = fn().double() - want
            row[arm + "_mean"] = float(err.mean()) / scale
            row[arm + "_max"] = float(err.abs().max()) / scale
            del err
        del want
        row["limit"] = SMOOTH_BIAS * abs(row["plain_mean"]) + SMOOTH_FLOOR
        say(f"smooth field {name:24s} {at}: mean / max error against f64, of max|f64|:"
            f" kernel {row['kernel_mean']:+.3e} / {row['kernel_max']:.3e}, plain f32 "
            f"{row['plain_mean']:+.3e} / {row['plain_max']:.3e}; |mean| limit {row['limit']:.3e}")
        yield row


def run_path(device, name: str, kernels: bool, **over):
    """``run_config`` of a path (``over``: configuration keys to replace),
    a stage-parallel one on its SLOTS slots of the one card, a
    PAIR_STEPPED one with ``cheb_pair=True``."""
    from dealii_spirk_tpu_torch.config import Parameters
    from dealii_spirk_tpu_torch.runner import run_config

    dim, cfg, _L = PATHS[name]
    params = Parameters.from_dict({**cfg, **over}, dim=dim)
    return run_config(params, device=device, verbose=False, kernels=kernels,
                      slots=SLOTS.get(name), cheb_pair=name in PAIR_STEPPED)


def check_paraview(directory: str, out: dict) -> None:
    """The ParaView series a run wrote into ``directory``: ``result.pvd``
    lists step 0 and every step, and the last ``.vtr``'s payload is the
    run's final field with its zero boundary added, in f64, bit for bit."""
    n = out["n_timesteps"]
    with open(os.path.join(directory, "result.pvd")) as f:
        files = re.findall(r'file="([^"]+)"', f.read())
    if files != [f"result_{i:04d}.vtr" for i in range(n + 1)]:
        raise AssertionError(f"result.pvd lists {files}, not the {n + 1} files of the run")
    with open(os.path.join(directory, files[-1])) as f:
        raw = base64.b64decode(f.read().split('format="binary">')[1].split("<")[0])
    (nbytes,) = struct.unpack("<I", raw[:4])
    got = np.frombuffer(raw[4 : 4 + nbytes], dtype="<f8")
    want = np.pad(out["u"].detach().to("cpu", torch.float64).numpy(), 1).ravel(order="F")
    if not np.array_equal(got, want):
        raise AssertionError(f"{files[-1]} does not hold the run's final field")
    say(f"ParaView series: {len(files)} files listed in result.pvd, {files[-1]} "
        f"({os.path.getsize(os.path.join(directory, files[-1]))} bytes) equal to the "
        f"final field bit for bit")


def run_p12(device, smi: str) -> dict:
    """P12: ``json/ost.json`` run as shipped through the port's CLI
    (``__main__.main``: MatrixBased + AMG, so the plain dense route and no
    kernel), its AMG setup timed inside that run (the scheme's construction,
    which builds the hierarchy, and its first preconditioner state, the
    Lanczos ``gmg_reinit`` of step 1), then its MatrixFree + GMG twin at the
    same widths in f64; both in a temporary directory, where the CLI run's
    ParaView series is checked (``check_paraview``); returns P12's launch
    counts (all zero)."""
    with tempfile.TemporaryDirectory() as tmp:
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            return _run_p12(device, smi, os.path.join(ROOT, P12_JSON), tmp)
        finally:
            os.chdir(cwd)


def _run_p12(device, smi: str, config: str, workdir: str) -> dict:
    import dealii_spirk_tpu_torch.__main__ as cli
    from dealii_spirk_tpu_torch import runner
    from dealii_spirk_tpu_torch.config import Parameters
    from dealii_spirk_tpu_torch.ops.cuda import stencil as st

    setup, runs = {}, []

    def timed(key, fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            setup.setdefault(key, (time.perf_counter() - t0) * 1e3)
            return out
        return call

    def make_scheme(*args, **kwargs):
        scheme = timed("construction (build_amg_data)", runner_make_scheme)(*args, **kwargs)
        scheme._reinit = timed("first gmg_reinit", scheme._reinit)
        return scheme

    def run_config(*args, **kwargs):
        runs.append(cli_run_config(*args, **kwargs))
        return runs[-1]

    cli_run_config, runner_make_scheme = cli.run_config, runner.make_scheme
    outs = {}
    for arm in ("P12", "twin"):
        t0 = time.perf_counter()
        st.reset_launches()
        if arm == "P12":
            cli.run_config, runner.make_scheme = run_config, make_scheme
            try:
                rc = cli.main(["--device", str(device), "--no-phase-timers", config])
            finally:
                cli.run_config, runner.make_scheme = cli_run_config, runner_make_scheme
            if rc != 0 or len(runs) != 1:
                raise AssertionError(f"the CLI on {P12_JSON} returned {rc} after {len(runs)} runs")
            out = runs.pop()
            say(f"P12 AMG setup inside the run on {smi}: "
                + ", ".join(f"{k} {v:.3f} ms" for k, v in setup.items()))
            check_paraview(workdir, out)
        else:
            with open(config) as f:
                params = Parameters.from_dict({**json.load(f), **P12_TWIN}, dim=3)
            out = runner.run_config(params, device=device, verbose=False)
        launches = dict(st.LAUNCHES)
        scheme = out["scheme"]
        say(f"{arm} ({P12_JSON}{' + ' + str(P12_TWIN) if arm == 'twin' else ', the CLI'}): "
            f"mode {scheme.mode}, {scheme.dtype}, kernels {scheme.kernels}, "
            f"{out['n_timesteps']} steps, levels m = {[o.m for o in scheme.gmg.level_ops]}; "
            f"CG counts per step {[s['n_outer'] for s in scheme.step_log]}; step times "
            f"(steps >= 2) on {smi}: {[f'{t * 1e3:.3f} ms' for t in out['step_seconds']]}; "
            f"L2 {out['error_L2']:.9e}, Linf {out['error_Linf']:.9e}; "
            f"{time.perf_counter() - t0:.1f} s")
        if any(launches.values()):
            raise AssertionError(f"{arm} ran plain torch, yet launched {launches}")
        if not (out["error_L2"] < 1e-2 and np.isfinite(out["error_Linf"])):
            raise AssertionError(f"{arm} solution error off: L2={out['error_L2']}")
        outs[arm] = (out["error_L2"], launches)
        del out, scheme
        gc.collect()
        torch.cuda.empty_cache()
    if len(setup) != 2:
        raise AssertionError(f"P12's AMG setup went untimed: {setup}")
    (l2, launches), (l2_twin, _) = outs["P12"], outs["twin"]
    rel = abs(l2 - l2_twin) / l2_twin
    say(f"P12 L2 {l2:.9e} vs the MatrixFree + GMG twin {l2_twin:.9e}: relative {rel:.3e} "
        f"(tol {P12_REL:g})")
    if rel > P12_REL:
        raise AssertionError("P12 and its MatrixFree + GMG twin disagree on the error")
    return launches


def run_p14(device, smi: str) -> dict:
    """P14: ``gmg_bench`` through its CLI (``gmg_bench.main``, 3D, f32,
    ``--op-mode kernels``) over P14_SWEEPS, each mode's launches read around
    its ``_bench_mode`` call and held to ``bench_launches``, with the gates
    of phase 8; then the plain arm (P14_PLAIN, one solve each).  Returns
    P14's launch counts."""
    import dealii_spirk_tpu_torch.gmg_bench as gb
    from dealii_spirk_tpu_torch.fem.grid import make_space
    from dealii_spirk_tpu_torch.ops.cuda import stencil as st
    from dealii_spirk_tpu_torch.solvers.gmg import build_gmg_data

    bench, runs = gb._bench_mode, {}
    solves = 1 + gb.N_REPETITIONS
    tol = 2 * gb.reltol_of(torch.float32)

    def recording(space, gmg, dim, label, dtype, **kwargs):
        before = dict(st.LAUNCHES)
        res = bench(space, gmg, dim, label, dtype, **kwargs)
        got = {k: n - before[k] for k, n in st.LAUNCHES.items()}
        runs[(space.degree, space.refinement, label)] = (
            res, got, bench_launches(gmg, dim, label, res.iterations, solves))
        return res

    t0 = time.perf_counter()
    st.reset_launches()
    gb._bench_mode = recording
    try:
        for p, r0, r1, modes in P14_SWEEPS:
            say(f"P14: gmg_bench Q{p} refinements {r0}-{r1}, {', '.join(modes)}, on {smi}")
            rc = gb.main(["--device", str(device), "--dim", "3", "--precision", "f32",
                          "--op-mode", "kernels", "--degree", str(p), "--min-ref", str(r0),
                          "--max-ref", str(r1), "--modes", ",".join(modes)])
            if rc != 0:
                raise AssertionError(f"P14: gmg_bench returned {rc}")
    finally:
        gb._bench_mode = bench
    launches = dict(st.LAUNCHES)
    say(f"P14 (kernels): {time.perf_counter() - t0:.1f} s, launches {launches}")
    want = [(p, r, label) for p, r0, r1, modes in P14_SWEEPS
            for r in range(r0, r1 + 1) for label in modes]
    missing = [key for key in want if key not in runs]
    if missing:
        raise AssertionError(f"P14: no result (oom) for {missing}")
    for (p, r, label), (res, got, structure) in runs.items():
        say(f"P14 Q{p} r{r} {label:10s}: {res.iterations} iterations, "
            f"{res.seconds / max(res.iterations, 1) * 1e3:.4f} ms per iteration "
            f"({res.seconds * 1e3:.3f} ms per solve) on {smi}; true residual "
            f"{res.true_residual:.3e} (tol {tol:g}); launches "
            f"{ {k: n for k, n in got.items() if n} }")
        if got != structure:
            raise AssertionError(f"P14 Q{p} r{r} {label}: launches {got} != structure {structure}")
        if not res.true_residual <= tol:
            raise AssertionError(f"P14 Q{p} r{r} {label}: true residual {res.true_residual}")
    for p, r, label in want:
        if label in ("fesystem8", "subgroups8"):
            n, n_b = runs[(p, r, label)][0].iterations, runs[(p, r, "batched8")][0].iterations
            if (label == "fesystem8" and n != n_b) or abs(n - n_b) > 1:
                raise AssertionError(f"P14 Q{p} r{r}: {label} {n} iterations, batched8 {n_b}")
    t0 = time.perf_counter()
    for p, r, modes in P14_PLAIN:
        space = make_space(3, p, r)
        gmg = build_gmg_data(space, dtype=torch.float32, device=device)
        for label in modes:
            before = dict(st.LAUNCHES)
            res = bench(space, gmg, 3, label, torch.float32, kernels=False, device=device,
                        repetitions=0)
            n_k = runs[(p, r, label)][0].iterations
            say(f"P14 plain Q{p} r{r} {label:10s}: {res.iterations} iterations (kernels "
                f"{n_k}), {res.seconds * 1e3:.3f} ms per solve on {smi}; true residual "
                f"{res.true_residual:.3e}")
            if st.LAUNCHES != before:
                raise AssertionError("P14's plain arm launched a kernel")
            if abs(res.iterations - n_k) > 1 or not res.true_residual <= tol:
                raise AssertionError(f"P14 Q{p} r{r} {label}: the plain arm disagrees")
        del gmg
        gc.collect()
        torch.cuda.empty_cache()
    say(f"P14 (plain): {time.perf_counter() - t0:.1f} s")
    return launches


def bench_launches(gmg, dim: int, label: str, iterations: int, solves: int) -> dict:
    """Launch counts of one ``gmg_bench`` mode on the kernels: per solve
    ``pcg``'s CG operator once per iteration and the V-cycle once per
    iteration and once at the start, over ``solves`` solves, and one more
    operator apply for the true residual.  The operator is K4 (2D: K4-2D)
    and a V-cycle ``_smoother_launches``' on all lanes at once; in
    ``subgroups8`` (an (8, 1) slot mesh) every slot launches its own: the
    operator K9a (2D: K4-2D), and a one-lane V-cycle whose levels that
    ``sharded_levels`` splits take the halo forms (K9c or K9d, and K9a)
    and move to the level below by the sharded z transfers, no K10."""
    from types import SimpleNamespace

    from dealii_spirk_tpu_torch.gmg_bench import MODES
    from dealii_spirk_tpu_torch.ops.cuda import stencil as st
    from dealii_spirk_tpu_torch.solvers.gmg import sharded_levels

    n_comp, _shared, on_mesh = MODES[label]
    want = dict.fromkeys(st.LAUNCHES, 0)
    n_apply, n_vcycle = solves * iterations + 1, solves * (iterations + 1)
    apply = "stencil_apply" if dim == 3 else "stencil_apply_2d"
    if not on_mesh:
        want[apply] = n_apply
        _smoother_launches(SimpleNamespace(dim=dim, cheb_pair=False, gmg=gmg), n_vcycle, want)
        return want
    want["stencil_apply_halo" if dim == 3 else apply] = n_comp * n_apply
    split = sharded_levels(gmg, dim, 1)
    for l, ops in enumerate(gmg.level_ops[1:], 1):
        level = dict.fromkeys(st.LAUNCHES, 0)
        one = SimpleNamespace(dim=dim, cheb_pair=False, gmg=SimpleNamespace(level_ops=(None, ops)))
        _smoother_launches(one, n_comp * n_vcycle, level)
        for key, n in level.items():
            if n and not (split[l] and key.startswith("transfer_")):
                want[key + "_halo" if split[l] else key] += n
    return want


def _smoother_launches(scheme, n_vcycle: int, want: dict) -> None:
    """Per V-cycle, on each smoothed level: 3D two smooths of 4 fused
    Chebyshev steps (K3, or K3dg on ``cheb_diag_level`` levels, or with
    ``cheb_pair`` 2 K8 pair steps on ``cheb_pair_level`` levels) plus the
    post-smooth entry and restriction residuals (K4), and the transfers to
    the level below, one K10 restriction and one prolongation; 2D the 8
    Chebyshev steps, each one K4-2D apply, plus those two residuals."""
    from dealii_spirk_tpu_torch.solvers.gmg import cheb_diag_level, cheb_pair_level

    for ops in scheme.gmg.level_ops[1:]:
        if scheme.dim == 3:
            if scheme.cheb_pair and cheb_pair_level(ops.m, 3, ops.p):
                want["cheb_pair_dg"] += 4 * n_vcycle
            else:
                key = "cheb_iter_dg" if cheb_diag_level(ops.m, 3) else "cheb_iter"
                want[key] += 8 * n_vcycle
            want["stencil_apply"] += 2 * n_vcycle
            want["transfer_restrict"] += n_vcycle
            want["transfer_prolong"] += n_vcycle
        else:
            want["stencil_apply_2d"] += 10 * n_vcycle


def _pair_counts(scheme) -> tuple[int, int]:
    """(vmults, preconditioner applications) of a complex scheme's run: per
    step one application at the start, then one vmult and one application
    per iteration of the slowest live pair ("sweeps") and per restart."""
    n_vmult = n_app = 0
    for s in scheme.step_log:
        vmults = s["n_sweeps"] + s["n_restarts"]
        if s["n_restarts"] == 0 and (
            s["n_sweeps"] != max(s["n_outer_pair"])
            or s["n_inner_pair"] != [[1 + n, 1 + n] for n in s["n_outer_pair"]]
        ):
            raise AssertionError(f"pair counts off the GMRES structure: {s}")
        n_vmult += vmults
        n_app += vmults + 1
    return n_vmult, n_app


def _mesh_counts(scheme) -> tuple[int, int]:
    """(vmults, preconditioner applications) of a ``spirk`` run; every
    stage counts one V-cycle per application."""
    n_vmult = n_app = 0
    for s in scheme.step_log:
        apps = s["n_outer"] + 1 + s["n_restarts"]
        if s["n_inner_stage"] != [apps] * scheme.q:
            raise AssertionError(f"V-cycle count off the GMRES structure: {s}")
        n_vmult += s["n_outer"] + s["n_restarts"]
        n_app += apps
    return n_vmult, n_app


def _solve_structure(scheme) -> dict:
    """What a run's solver counts imply: vmults, mesh or whole V-cycles, the
    lanes of the vmult and of a V-cycle, and the fine-level K4 / K9a
    launches outside the V-cycles (PRESB's ``M x0``, over n2 lanes)."""
    if hasattr(scheme, "n_pairs"):
        n2 = scheme.n_pairs
        n_vmult, n_app = _pair_counts(scheme)
        presb = not scheme.batched
        return {"vmult": n_vmult, "vcycle": 2 * n_app if presb else n_app,
                "vmult_lanes": 2 * n2, "vcycle_lanes": n2 if presb else 2 * n2,
                "mx0": n_app if presb else 0, "mx0_lanes": n2, "app": n_app}
    n_vmult, n_app = _mesh_counts(scheme)
    return {"vmult": n_vmult, "vcycle": n_app, "vmult_lanes": scheme.q,
            "vcycle_lanes": scheme.q, "mx0": 0, "mx0_lanes": 0, "app": n_app}


def expected_launches(out) -> dict:
    """Launch counts the solve structure implies.  Per GMRES solve: one
    preconditioner application at the start, one vmult and one
    application per iteration, one of each per restart; batched over the
    complex pairs, per iteration of the slowest live lane ("sweeps").

    * ``irk(_batched)``: the vmult is K1 (3D irk_batched; where no tile
      holds its q rings, ``mix_tile``, K2 + ``ms_mix_apply_split``) or K5 +
      a K2 mix; an application is a K2 mix, the V-cycles (one
      stage-batched, or one per stage for ``irk``) and a K2 mix;
    * ``complex_irk(_batched)``: the vmult is K5 + a K2 mix of the pair
      blocks; the T^-1 and T maps are one K2 each per step; an
      application is one 2 n2-lane V-cycle (batched) or PRESB's two n2-lane
      V-cycles and one K4 (``M x0``);
    * on a mesh (``spirk``, ``complex_spirk(_batched)``): ``_mesh_launches``,
      and for the pair schemes the two unsharded K2 maps per step;
    * ``ost``: per step a K4 for the rhs and one for CG's start residual,
      per CG iteration a K4 vmult, and one-lane V-cycles, one per iteration
      and one at the start."""
    from dealii_spirk_tpu_torch.ops.cuda import stencil as st

    scheme = out["scheme"]
    want = dict.fromkeys(st.LAUNCHES, 0)
    n_vmult = n_app = n_vcycle = 0
    if scheme.params.time_integration_scheme == "ost":
        apply = "stencil_apply" + ("" if scheme.dim == 3 else "_2d")
        for s in scheme.step_log:
            want[apply] += 2 + s["n_outer"]
            n_vcycle += 1 + s["n_outer"]
        _smoother_launches(scheme, n_vcycle, want)
        return want
    if scheme.mesh is not None:
        if hasattr(scheme, "n_pairs"):
            want["stage_mix"] = 2 * len(scheme.step_log)
        return _mesh_launches(scheme, want)
    if hasattr(scheme, "n_pairs"):
        sv = _solve_structure(scheme)
        want["mass_stiffness_apply"] = sv["vmult"]
        want["stage_mix"] = sv["vmult"] + 2 * len(scheme.step_log)
        want["stencil_apply"] = sv["mx0"]
        _smoother_launches(scheme, sv["vcycle"], want)
        return want
    per_app = scheme.q if scheme.sequential else 1
    for s in scheme.step_log:
        apps = s["n_outer"] + 1 + s["n_restarts"]
        if s["n_inner"] != per_app * apps:
            raise AssertionError(f"V-cycle count off the GMRES structure: {s}")
        n_vmult += s["n_outer"] + s["n_restarts"]
        n_app += apps
        n_vcycle += s["n_inner"]
    if scheme.dim == 3 and not scheme.sequential:
        # K1, or where no tile holds its q rings its route: K2 and the split march
        route = not st.mix_tile(scheme.q, scheme.fine.p)
        want["ms_mix_apply_split" if route else "ms_mix_apply"] = n_vmult
        want["stage_mix"] = 2 * n_app + (n_vmult if route else 0)
    else:
        want["mass_stiffness_apply" + ("" if scheme.dim == 3 else "_2d")] = n_vmult
        want["stage_mix"] = n_vmult + 2 * n_app
    _smoother_launches(scheme, n_vcycle, want)
    return want


def _mesh_launches(scheme, want: dict) -> dict:
    """A scheme on a 3D mesh whose smoothed levels are all sharded: every
    operation is one halo-kernel launch per slot — per vmult one K9b, per
    ``M x0`` one K9a, per V-cycle and level 8 Chebyshev steps (K9c, or K9d
    on ``cheb_diag_level`` levels; never K8) and 2 K9a; the mixes are torch
    (K1 stays at 0, K2 runs only the pair schemes' unsharded maps) and the
    coarse level is a dense solve."""
    from dealii_spirk_tpu_torch.solvers.gmg import cheb_diag_level

    n_slots = scheme.mesh.slot_ids.size
    sv = _solve_structure(scheme)
    prec = scheme.prec_state(scheme.params.time_step_size)
    if [lv is not None for lv in prec.levels] != [False] + [True] * (len(prec.levels) - 1):
        raise AssertionError("every smoothed level of this path should be sharded")
    want["mass_stiffness_apply_halo"] = sv["vmult"] * n_slots
    want["stencil_apply_halo"] = sv["mx0"] * n_slots
    for level in prec.levels[1:]:
        key = "cheb_iter_dg_halo" if cheb_diag_level(level.m, 3) else "cheb_iter_halo"
        want[key] += 8 * sv["vcycle"] * n_slots
        want["stencil_apply_halo"] += 2 * sv["vcycle"] * n_slots
    return want


def expected_exchange(scheme) -> tuple[dict, int]:
    """(bytes passed between slots by kind, the most planes in one halo
    message) that a mesh run's structure implies.  With S stage rows
    and C space slots, a z exchange of h planes on a level of m points per
    axis moves 2 (C - 1) messages of h m^2 points per lane: one per sharded
    kernel launch (h = p), one per z transfer (its plan's h, on the level
    it reads).  ``spirk``: a ring mix moves every stage block q - 1 times,
    an all-gather mix S - 1 times: once per step for the right-hand side,
    once per vmult, twice per application.  The pair schemes mix nothing
    on the mesh: the 2x2 pair block is row-local and the T^-1 / T maps run
    unsharded.  The coarse level's planes outside each row's first slot
    travel there and back per V-cycle; the right-hand side and the
    solution (q stages, or the 2 n2 mapped lanes) once per step."""
    from dealii_spirk_tpu_torch.parallel.sharding import z_partition

    mesh = scheme.mesh
    C, S = mesh.n_space, mesh.n_stage
    sv = _solve_structure(scheme)
    n_steps = len(scheme.step_log)
    prec = scheme.prec_state(scheme.params.time_step_size)
    ms = [lv.m if lv is not None else None for lv in prec.levels]
    m0, mf = scheme.gmg.level_ops[0].m, scheme.fine.m
    p = scheme.fine.p
    esize = torch.finfo(scheme.dtype).bits // 8
    per_lane = esize * 2 * (C - 1)  # bytes per point of a plane, both directions, one lane
    fine = sv["vmult"] * sv["vmult_lanes"] + sv["mx0"] * sv["mx0_lanes"]
    halo, planes = fine * p * mf**2, p
    for l in range(1, len(ms)):
        m_c = ms[l - 1] or m0
        hr, hp = prec.restricts[l - 1].h, prec.prolongs[l - 1].h
        halo += sv["vcycle"] * sv["vcycle_lanes"] * (
            10 * p * ms[l] ** 2 + hr * ms[l] ** 2 + hp * m_c**2)
        planes = max(planes, hr, hp)
    lanes = sv["vmult_lanes"]  # of the right-hand side and the solution
    block = esize * lanes * mf**3
    if hasattr(scheme, "n_pairs"):
        mix = 0
    else:
        hops = scheme.q - 1 if scheme.ring else S - 1
        mix = hops * block * (n_steps + sv["vmult"] + 2 * sv["app"])
    first = z_partition(m0, C)[0][1]
    return {
        "halo": per_lane * halo,
        "mix": mix,
        "coarse_gather": sv["vcycle"] * 2 * esize * sv["vcycle_lanes"] * (m0 - first) * m0**2,
        "state": n_steps * 2 * block,
    }, planes


def _record(out) -> dict:
    """What the comparisons need of a run, without the scheme's state
    (the GMG levels and preconditioner: GBs at refinement 8)."""
    return {k: out[k] for k in ("u", "error_L2", "error_Linf", "step_seconds")} | {
        "step_log": out["scheme"].step_log,
        "pairs": hasattr(out["scheme"], "n_pairs"),
    }


def kernel_arm(device, name: str):
    """Phase 4: the kernel arm of one path, with the launch counts of its
    run."""
    from dealii_spirk_tpu_torch.ops.cuda import stencil as st
    from dealii_spirk_tpu_torch.parallel import sharding as sh

    st.reset_launches()
    sh.reset_exchange()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = run_path(device, name, kernels=True)
    for w in caught:  # printed as they would have been, and kept for check_restarts
        warnings.showwarning(w.message, w.category, w.filename, w.lineno)
    launches = dict(st.LAUNCHES)
    exchange, planes = dict(sh.EXCHANGE), sh.HALO_MAX_PLANES["planes"]
    scheme = out["scheme"]
    L = len(scheme.gmg.level_ops) - 1
    if scheme.params.block_preconditioner_type == "AMG":
        # the kernels take the aggregation levels' bands as they take GMG's
        bad = [o.m for o in scheme.gmg.level_ops if not o.kernel_bands]
        if bad:
            raise AssertionError(f"{name}: AMG levels m = {bad} do not reach the kernels")
    say(f"{name} (kernels): {out['n_timesteps']} steps, smoothed levels L={L} "
        f"(m = {[o.m for o in scheme.gmg.level_ops[1:]]}, coarse m={scheme.gmg.level_ops[0].m})")
    for i, s in enumerate(scheme.step_log, 1):
        say(f"  step {i}: {s}")
    say(f"  step times (steps >= 2): {[f'{t * 1e3:.3f} ms' for t in out['step_seconds']]}")
    say(f"  L2 error {out['error_L2']:.6e}, Linf error {out['error_Linf']:.6e}")
    say(f"  launches: {launches}")
    say(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not (out["error_L2"] < 1e-2 and np.isfinite(out["error_Linf"])):
        raise AssertionError(f"{name} solution error off: L2={out['error_L2']}")
    if L != PATHS[name][2]:
        raise AssertionError(f"{name} keeps {PATHS[name][2]} smoothed levels, got {L}")
    if name in RESTARTS:
        check_restarts(name, scheme, caught)
    want = expected_launches(out)
    say(f"  launches the structure implies: {want}")
    if launches != want:
        raise AssertionError(f"{name}: launch counts {launches} != structure {want}")
    path_kernels = [k for k, n in want.items() if n > 0]
    missing = [k for k in path_kernels + list(REQUIRED.get(name, ())) if launches[k] == 0]
    if missing or not path_kernels:
        raise AssertionError(f"{name}: kernels never launched on the path: {missing}")
    if name in SLOTS:
        mesh = scheme.mesh
        say(f"  slot mesh {mesh.shape}: slots {mesh.slot_ids.tolist()}, all on {device}")
        want_ex, want_planes = expected_exchange(scheme)
        say(f"  bytes between slots: {exchange}, most planes in a halo message {planes}")
        say(f"  bytes the structure implies: {want_ex}, planes {want_planes}")
        if exchange != want_ex or planes != want_planes:
            raise AssertionError(f"{name}: exchanged bytes off the structure")
    elif any(exchange.values()):
        raise AssertionError(f"{name}: a path without a mesh exchanged {exchange}")
    return _record(out), launches


def check_restarts(name: str, scheme, caught) -> None:
    """A RESTARTS path: its GMRES ran on the compact basis, restarted in
    every step after the first, and ``check_outer`` warned in exactly the
    steps that passed the basis's columns."""
    steps = scheme.step_log
    past = sum(s["n_outer"] > scheme.restart for s in steps)
    warned = sum(issubclass(w.category, RuntimeWarning) and "compact basis" in str(w.message)
                 for w in caught)
    say(f"  compact basis of {scheme.restart} columns: restarts per step "
        f"{[s['n_restarts'] for s in steps]}, RuntimeWarnings {warned}")
    if not scheme.compact or warned != past or not all(s["n_restarts"] for s in steps[1:]):
        raise AssertionError(f"{name}: no compact-basis restart in every step after the first")


def _counts(s: dict, pairs: bool) -> list[int]:
    if pairs:
        return list(s["n_outer_pair"]) + [n for lane in s["n_inner_pair"] for n in lane]
    return [s["n_outer"]] + list(s.get("n_inner_stage", ()))  # ost: CG's count only


def _hold_arms(a: dict, b: dict) -> None:
    """Per-step outer and per-stage (per-pair) inner counts of two runs of
    one configuration within 1, their solutions close."""
    for i, (sa, sb) in enumerate(zip(a["step_log"], b["step_log"]), 1):
        ca, cb = _counts(sa, a["pairs"]), _counts(sb, b["pairs"])
        say(f"  step {i}: counts {ca} vs {cb}")
        if len(ca) != len(cb) or max(abs(x - y) for x, y in zip(ca, cb)) > 1:
            raise AssertionError("the two runs' counts differ by more than 1")
    du = float((a["u"] - b["u"]).abs().max() / b["u"].abs().max())
    say(f"  L2 error {a['error_L2']:.6e} vs {b['error_L2']:.6e}; "
        f"max|u_a - u_b| / max|u_b| = {du:.3e} (tol 1e-3)")
    if du > 1e-3:
        raise AssertionError("the two runs' solutions differ")


def plain_arm(device, name: str, kern: dict) -> dict:
    """Phase 5: the plain torch arm against the kernel arm."""
    out = _record(run_path(device, name, kernels=False))
    say(f"{name}: kernel arm vs plain torch arm")
    _hold_arms(kern, out)
    return out


def _vcycles(rec: dict) -> int:
    """V-cycles of a ``complex_irk_batched`` run: one per application."""
    return sum(s["n_sweeps"] + s["n_restarts"] + 1 for s in rec["step_log"])


def check_pair_stepped(launches: dict, records: dict) -> None:
    """K8 runs on the PAIR_STEPPED paths only, there in place of every
    K3dg launch at half their number per V-cycle."""
    for name in PATHS:
        if name not in PAIR_STEPPED and launches[name]["cheb_pair_dg"]:
            raise AssertionError(f"{name} launched K8")
    for name, ref in PAIR_STEPPED.items():
        k8, dg = launches[name]["cheb_pair_dg"], launches[ref]["cheb_iter_dg"]
        nv, nv_ref = _vcycles(records[name][0]), _vcycles(records[ref][0])
        say(f"{name}: K8 {k8} launches in {nv} V-cycles, K3dg {launches[name]['cheb_iter_dg']};"
            f" {ref}: K3dg {dg} in {nv_ref} V-cycles")
        if launches[name]["cheb_iter_dg"] or not k8 or 2 * k8 * nv_ref != dg * nv:
            raise AssertionError(f"{name}: K8 is not half of {ref}'s K3dg per V-cycle")


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
    measured = measure_kernels(device)
    arms = measure_arms(device)
    launches = run_paths(device, smi)
    say(json.dumps({"march_arms": arms}))
    say(json.dumps(kernel_summary(report, launches, measured)))
    say(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


def run_paths(device, smi: str) -> dict:
    """Phases 4-6 over PATHS; returns each path's launch counts."""
    launches, l2, outer, times = {}, {}, {}, {}
    # the runs later phases hold others against: (kernel arm, plain arm)
    keep = set(PAIR_STEPPED.values()) | set(PAIR_STEPPED) | {"P5", "P8", "P9", "P18"}
    records = {}
    for name in PATHS:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        kern, launches[name] = kernel_arm(device, name)
        gc.collect()
        torch.cuda.empty_cache()
        if name in PAIR_STEPPED:
            ref_k, ref_p = records[PAIR_STEPPED[name]]
            for arm, rec in (("kernel", ref_k), ("plain torch", ref_p)):
                say(f"{name} (kernels, cheb_pair) vs {PAIR_STEPPED[name]}'s {arm} arm")
                _hold_arms(kern, rec)
            plain = None
        else:
            plain = plain_arm(device, name, kern)
            share = ARM_L2.get(name, ARM_L2_SHARE)
            rel = abs(kern["error_L2"] - plain["error_L2"]) / plain["error_L2"]
            say(f"{name} L2 kernel arm vs plain arm: relative {rel:.3e} (tol {share:g})")
            if rel > share:
                raise AssertionError(f"{name}: the kernel arm's L2 left its plain arm's")
        l2[name] = kern["error_L2"]
        outer[name] = [s.get("n_outer") for s in kern["step_log"]]
        times[name] = [round(t * 1e3, 3) for t in kern["step_seconds"]]
        say(f"{name} per-step ms (steps >= 2) on {smi}: kernels {times[name]}, plain "
            + (f"{[round(t * 1e3, 3) for t in plain['step_seconds']]}" if plain is not None
               else f"(that of {PAIR_STEPPED[name]})")
            + f"; {time.perf_counter() - t0:.1f} s")
        if name in keep:
            records[name] = (kern, plain)
        del kern, plain
        gc.collect()
        torch.cuda.empty_cache()
    check_pair_stepped(launches, records)
    launches["P12"] = run_p12(device, smi)
    launches["P14"] = run_p14(device, smi)
    for name, ref in PAIR_STEPPED.items():
        say(f"{ref} vs {name} (K3dg vs K8 on the 255 level) per-step ms, one run, on {smi}: "
            f"{times[ref]} vs {times[name]}")
    for a, b, share in ORACLES:
        rel = abs(l2[a] - l2[b]) / l2[b]
        say(f"mutual oracle: {a} L2 {l2[a]:.6e} vs {b} L2 {l2[b]:.6e}: relative {rel:.3e} "
            f"(tol {share:g})")
        if rel > share:
            raise AssertionError(f"{a} and {b} disagree on the error")
    # the partition leaves the iteration alone: P6 and P8 against the same
    # solve unsharded, P9 against P5 (the JAX package asserts equal counts;
    # on the card the per-slot partial sums reorder the reductions, hence
    # within 1)
    whole = run_path(device, "P6", kernels=True, TimeIntegrationScheme="irk_batched")
    n_whole = [s["n_outer"] for s in whole["scheme"].step_log]
    say(f"P6 outer counts per step {outer['P6']} vs unsharded irk_batched {n_whole}")
    if max(abs(x - y) for x, y in zip(outer["P6"], n_whole)) > 1:
        raise AssertionError("P6's outer counts moved by more than 1 under the partition")
    del whole
    whole = run_path(device, "P8", kernels=True, TimeIntegrationScheme="complex_irk_batched")
    n_whole = [s["n_outer_pair"] for s in whole["scheme"].step_log]
    n_mesh = [s["n_outer_pair"] for s in records["P8"][0]["step_log"]]
    rel = abs(l2["P8"] - whole["error_L2"]) / whole["error_L2"]
    say(f"P8 per-pair outer counts per step {n_mesh} vs unsharded complex_irk_batched {n_whole};"
        f" L2 {l2['P8']:.6e} vs {whole['error_L2']:.6e}: relative {rel:.3e} (tol 0.01)")
    if len(n_mesh) != len(n_whole) or max(
        abs(x - y) for a, b in zip(n_mesh, n_whole) for x, y in zip(a, b)
    ) > 1:
        raise AssertionError("P8's per-pair counts moved by more than 1 under the partition")
    if rel > 0.01:
        raise AssertionError("P8 and the unsharded complex_irk_batched disagree on the error")
    del whole
    say("P9 (complex_spirk on the mesh) vs P5 (complex_irk, unsharded):")
    _hold_arms(records["P9"][0], records["P5"][0])
    # P18 against the same solve unsharded and one stage at a time (irk):
    # the stage-parallel scheme with 4-plane halos changes nothing but the
    # order of the reductions
    whole = _record(run_path(device, "P18", kernels=True, TimeIntegrationScheme="irk"))
    rel = abs(l2["P18"] - whole["error_L2"]) / whole["error_L2"]
    say(f"P18 (spirk on the mesh) vs irk unsharded at its widths: L2 {l2['P18']:.6e} vs "
        f"{whole['error_L2']:.6e}: relative {rel:.3e} (tol {P18_TWIN_L2:g})")
    _hold_arms(records["P18"][0], whole)
    if rel > P18_TWIN_L2:
        raise AssertionError("P18 and the unsharded irk disagree on the error")
    return launches


def kernel_summary(report: dict, launches: dict, measured: list[dict]) -> dict:
    """The kernels line: per entry point its route, source, the TPU kernel
    it replaces, launches on the paths, its largest error and its first
    timed shape's numbers (every timed shape under ``times``); a kernel of
    the measurement phase adds its device time per launch and its L2-cold
    time per call at its first measured shape (every measured shape under
    ``measured``)."""
    summary = {"kernels": []}
    for name, (src, replaces) in KERNELS.items():
        first = report[name]["times"][0]
        mine = [r for r in measured if r["key"] == name]
        extra = {}
        if mine:
            extra = {k: mine[0][k] for k in ("device_ms", "cold_ms", "cold_device_ms")}
            extra |= {"measured_at": mine[0]["at"], "measured": mine}
        summary["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": src,
            "replaces": replaces,
            "launches": sum(by_path[name] for by_path in launches.values()),
            "launches_by_path": {p: by_path[name] for p, by_path in launches.items()},
            "max_abs_err": report[name]["max_abs_err"],
            **{k: first[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "times": report[name]["times"],
            **extra,
        })
    return summary


if __name__ == "__main__":
    sys.exit(main())
