"""Milliseconds per step in the scheme's right-hand side (the stage loads,
``K u`` and the ``A^-1`` mix): the port's ``rhs`` spans (CUDA events,
``utils/timer.py``) over the episode that runs with the phase timers on
inside its steps, after the window."""

PHASE = "rhs"


def read(run: dict):
    spans = run["spans"]
    if not spans or spans.get(PHASE) is None or not spans["steps"]:
        return None
    return spans[PHASE] / spans["steps"] * 1e3
