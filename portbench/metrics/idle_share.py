"""The device's idle share over the profiled episode: 1 - busy / wall,
busy the union of the device's operations in the trace, wall the host's
clock around the episode, which ends in a synchronise."""


def read(run: dict):
    trace = run["trace"]
    if not trace or trace["wall_s"] <= 0:
        return None
    return 1.0 - trace["busy_s"] / trace["wall_s"]
