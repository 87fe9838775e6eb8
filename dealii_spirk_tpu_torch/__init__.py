"""dealii_spirk_tpu_torch — the PyTorch/CUDA port of ``dealii_spirk_tpu``.

Same mathematics and module layout as the JAX package beside it (stage-
parallel Radau IIA solvers for the heat equation with Chebyshev-smoothed
geometric multigrid, reference arXiv:2209.06700), written as plain torch
functions on tensors.  On a CUDA device in f32, the operator kernels of
the main path (``ops/cuda/stencil.py``) are hand-written CUDA C++ for
Hopper (``csrc/``), built with ``nvcc`` on first use.

This package never imports JAX or ``dealii_spirk_tpu``; the tests compare
the two by feeding both the same numpy arrays.
"""

import torch

# A PDE solver chasing 1e-4..1e-12 residual reductions needs every f32
# contraction (stage mixing, grid transfer, coarse solve) in full f32:
# TF32 keeps ~3 decimal digits and stalls the Krylov solvers.  The JAX
# package pins "highest" matmul precision for the same reason.  These are
# process-wide settings, stated here on import.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"
