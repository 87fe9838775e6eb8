"""Preconditioner applications (V-cycles) per window step (the port's
``scheme.n_inner``)."""


def read(run: dict):
    return run["counters"]["n_inner"] / run["steps"] if run["steps"] else None
