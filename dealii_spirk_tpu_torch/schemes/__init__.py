"""Time-integration schemes (the reference's L5 layer, main.cc:450-2937).

Port of ``dealii_spirk_tpu/schemes``.  ``irk``, ``irk_batched``, ``spirk``,
``complex_irk`` and ``complex_irk_batched`` are ported so far; the other
three schemes raise ``NotImplementedError`` naming the ROADMAP queue item
that ports them.
"""

from __future__ import annotations

from ..config import Parameters
from ..problem import HeatProblem

_NOT_YET = {
    "ost": "ROADMAP Queue 1 item 10",
    "complex_spirk": "ROADMAP Queue 1 item 13",
    "complex_spirk_batched": "ROADMAP Queue 1 item 13",
}


def make_scheme(problem: HeatProblem, params: Parameters, *, mesh=None, **options):
    """The scheme object of ``params`` on the problem's device.  ``mesh``:
    the (stage, space) slot mesh of a stage-parallel scheme
    (``parallel.make_mesh``; default one slot per stage).  ``options`` go
    to the constructor (``kernels``, ``tables``, ``start``: see
    ``base.RadauScheme``)."""
    name = params.time_integration_scheme
    if name in ("irk", "irk_batched", "spirk"):
        from .irk import IRK

        return IRK(problem, params, mesh=mesh if name == "spirk" else None, **options)
    if name in ("complex_irk", "complex_irk_batched"):
        from .complex_irk import ComplexIRK

        return ComplexIRK(problem, params, **options)
    if name in _NOT_YET:
        raise NotImplementedError(
            f"scheme {name!r} is not ported yet: {_NOT_YET[name]}"
        )
    raise ValueError(f"unknown scheme {name!r}")
