"""Krylov solvers, Chebyshev smoothing and geometric multigrid (port of
``dealii_spirk_tpu/solvers``)."""
