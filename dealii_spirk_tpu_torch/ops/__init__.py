"""Operator layer: separable tensor-product applications of a*M + b*K.

``banded``/``transfer``/``mass_laplace`` are the plain torch path (port of
``dealii_spirk_tpu/ops``); ``cuda`` holds the hand-written Hopper kernels
that replace the JAX package's Pallas kernels on the main path.
"""
