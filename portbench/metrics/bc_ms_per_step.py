"""Milliseconds per step in the preconditioner's stage mixing (the T or pair maps): the port's
``preconditioner_bc`` spans (CUDA events, ``utils/timer.py``) over the episode
that runs with the phase timers on inside its steps, after the window."""

PHASE = "preconditioner_bc"


def read(run: dict):
    spans = run["spans"]
    if not spans or spans.get(PHASE) is None or not spans["steps"]:
        return None
    return spans[PHASE] / spans["steps"] * 1e3
