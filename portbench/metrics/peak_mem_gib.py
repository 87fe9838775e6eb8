"""The port's peak of allocated device memory from process start through
the window (``torch.cuda.max_memory_allocated``), in GiB."""


def read(run: dict):
    return None if run["peak_bytes"] is None else run["peak_bytes"] / 2**30
