"""The yardstick's table of peaks and the least time a kernel of the port
could take on one H100.

A frozen copy of ``chip_smoke.py::bound`` as it stood when the benchmark
was defined, kept to the kernels a metric reads: the larger of the bytes
a launch must move over the HBM rate and its f32 operations over the f32
peak.  Each input field is read once and each output written once.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# field passes per launch (K3dg: d, r, x -> r', d', x') and f32
# operations per output point of one lane (nb = 2p + 1 taps per axis)
PASSES = {"cheb_iter_dg": 6}
FLOPS = {"cheb_iter_dg": lambda nb: 14 * nb + 18}


def bound_s(name: str, lanes: int, points: int, p: int) -> tuple[float, str]:
    """(seconds, what binds) of the least time one launch of kernel
    ``name`` on ``lanes`` f32 fields of ``points`` points could take."""
    t_bytes = 4 * lanes * PASSES[name] * points / HBM_BYTES_PER_S
    t_ops = FLOPS[name](2 * p + 1) * lanes * points / F32_FLOPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
