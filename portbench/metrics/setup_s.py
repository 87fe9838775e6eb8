"""Seconds from the harness's start to the window's: imports, the port's
problem and scheme, the kernels' build where it is not cached, the seeded
field and the warm-up episode."""


def read(run: dict):
    return run["setup_s"]
