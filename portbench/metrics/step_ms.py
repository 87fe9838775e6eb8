"""Milliseconds per timestep: the window's wall time over all its steps."""


def read(run: dict):
    return run["window_s"] / run["steps"] * 1e3 if run["steps"] else None
