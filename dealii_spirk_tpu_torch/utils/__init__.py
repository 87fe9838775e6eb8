"""Phase timers and the convergence table (port of
``dealii_spirk_tpu/utils``)."""
