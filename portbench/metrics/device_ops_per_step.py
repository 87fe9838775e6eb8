"""Device operations (kernels, copies, fills) per step of the profiled
episode: what the host launches."""


def read(run: dict):
    trace = run["trace"]
    if not trace or not trace["steps"]:
        return None
    return trace["device_ops"] / trace["steps"]
