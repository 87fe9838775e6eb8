"""Outer GMRES iterations per window step (the port's ``scheme.n_outer``;
summed over the pair lanes of a complex scheme)."""


def read(run: dict):
    return run["counters"]["n_outer"] / run["steps"] if run["steps"] else None
