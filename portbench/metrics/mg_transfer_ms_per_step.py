"""Milliseconds per step in the V-cycles' residuals and grid transfers
(every level's ``r - A x``, restriction, prolongation and correction): the
port's ``mg_transfer`` spans (CUDA events, ``utils/timer.py``) over the
episode that runs with the phase timers on inside its steps, after the
window."""

PHASE = "mg_transfer"


def read(run: dict):
    spans = run["spans"]
    if not spans or spans.get(PHASE) is None or not spans["steps"]:
        return None
    return spans[PHASE] / spans["steps"] * 1e3
