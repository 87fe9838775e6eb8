"""Milliseconds per step in GMRES's own device vector work (Gram–Schmidt
dots and updates, the new basis vector's norm and scaling, the Hessenberg
column and its host read, the cycle's update, the restart residual): the
port's ``krylov_vectors`` spans (CUDA events, ``utils/timer.py``) over the
episode that runs with the phase timers on inside its steps, after the
window."""

PHASE = "krylov_vectors"


def read(run: dict):
    spans = run["spans"]
    if not spans or spans.get(PHASE) is None or not spans["steps"]:
        return None
    return spans[PHASE] / spans["steps"] * 1e3
