"""Time-integration schemes (the reference's L5 layer, main.cc:450-2937).

Port of ``dealii_spirk_tpu/schemes``: every scheme of the JAX package.
"""

from __future__ import annotations

from ..config import Parameters
from ..problem import HeatProblem


def make_scheme(problem: HeatProblem, params: Parameters, *, mesh=None, **options):
    """The scheme object of ``params`` on the problem's device.  ``mesh``:
    the (stage, space) slot mesh of a stage-parallel scheme
    (``parallel.make_mesh``; default one slot per stage row: q for
    ``spirk``, ceil(q/2) pairs for ``complex_spirk(_batched)``).
    ``options`` go to the constructor (``kernels``, ``start``,
    ``cheb_pair``: see ``base.SchemeBase``; ``tables`` for the Radau
    schemes: ``base.RadauScheme``)."""
    name = params.time_integration_scheme
    if name == "ost":
        from .ost import OneStepTheta

        return OneStepTheta(problem, params, **options)
    if name in ("irk", "irk_batched", "spirk"):
        from .irk import IRK

        return IRK(problem, params, mesh=mesh if name == "spirk" else None, **options)
    if name.startswith("complex_"):
        from .complex_irk import ComplexIRK

        return ComplexIRK(problem, params, mesh=mesh if params.is_stage_parallel else None,
                          **options)
    raise ValueError(f"unknown scheme {name!r}")
