"""Milliseconds per step in GMRES's host arithmetic (Givens rotations,
back-substitution, lane bookkeeping in numpy), from the return of each host
read to the next launch, while the device has nothing queued: the port's
``krylov_host`` spans (host clock, ``utils/timer.py``) over the episode that
runs with the phase timers on inside its steps, after the window."""

PHASE = "krylov_host"


def read(run: dict):
    spans = run["spans"]
    if not spans or spans.get(PHASE) is None or not spans["steps"]:
        return None
    return spans[PHASE] / spans["steps"] * 1e3
