"""Hand-written CUDA kernels of the main path: ``build`` compiles and
loads ``csrc/``, ``stencil`` holds the wrappers (port of
``dealii_spirk_tpu/ops/pallas``)."""
