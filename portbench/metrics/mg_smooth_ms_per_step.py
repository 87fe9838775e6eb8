"""Milliseconds per step in the V-cycles' Chebyshev smoothing (every
level's pre- and post-smoothing, with its diagonal): the port's
``mg_smooth`` spans (CUDA events, ``utils/timer.py``) over the episode that
runs with the phase timers on inside its steps, after the window."""

PHASE = "mg_smooth"


def read(run: dict):
    spans = run["spans"]
    if not spans or spans.get(PHASE) is None or not spans["steps"]:
        return None
    return spans[PHASE] / spans["steps"] * 1e3
