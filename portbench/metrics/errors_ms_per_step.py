"""Milliseconds per step in the step's L2/Linf error, which the step loop
reads on the host after each step: the port's ``errors`` spans (CUDA
events, ``utils/timer.py``) over the episode that runs with the phase
timers on inside its steps, after the window."""

PHASE = "errors"


def read(run: dict):
    spans = run["spans"]
    if not spans or spans.get(PHASE) is None or not spans["steps"]:
        return None
    return spans[PHASE] / spans["steps"] * 1e3
