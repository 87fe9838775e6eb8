"""Time-integration schemes (the reference's L5 layer, main.cc:450-2937).

Port of ``dealii_spirk_tpu/schemes``.  Only ``irk_batched`` is ported so
far; the other seven schemes raise ``NotImplementedError`` naming the
ROADMAP queue item that ports them.
"""

from __future__ import annotations

from ..config import Parameters
from ..problem import HeatProblem

_NOT_YET = {
    "irk": "ROADMAP Queue 1 item 6",
    "spirk": "ROADMAP Queue 1 items 6 and 13",
    "ost": "ROADMAP Queue 1 item 10",
    "complex_irk": "ROADMAP Queue 1 item 9",
    "complex_irk_batched": "ROADMAP Queue 1 item 9",
    "complex_spirk": "ROADMAP Queue 1 items 9 and 13",
    "complex_spirk_batched": "ROADMAP Queue 1 items 9 and 13",
}


def make_scheme(problem: HeatProblem, params: Parameters, **options):
    """The scheme object of ``params``; ``options`` go to its constructor
    (for ``irk_batched``: ``kernels``, ``tables``, ``start``)."""
    name = params.time_integration_scheme
    if name == "irk_batched":
        from .irk import IRK

        return IRK(problem, params, **options)
    if name in _NOT_YET:
        raise NotImplementedError(
            f"scheme {name!r} is not ported yet: {_NOT_YET[name]}"
        )
    raise ValueError(f"unknown scheme {name!r}")
