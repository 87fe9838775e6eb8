"""The 95th percentile of the window's step times, in milliseconds: the
host clock around each step, which ends in the host's read of its error.
The window runs alike with ``--trace 0`` and ``--trace 1`` (no phase timer
inside the steps, no profiler)."""

import statistics


def read(run: dict):
    steps = run["step_s"]
    if len(steps) < 2:
        return None
    return statistics.quantiles(steps, n=100, method="inclusive")[94] * 1e3
