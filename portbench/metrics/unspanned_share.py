"""Share of the step, error included, that no leaf phase of the port's
timers covers: 1 - (``rhs`` + ``solution_update`` + ``system_vmult`` +
``preconditioner_bc`` + ``preconditioner_solver`` + ``krylov_vectors`` +
``krylov_host`` + ``errors``) / (``total`` + ``errors``), over the episode
that runs with the phase timers on inside its steps, after the window
(``utils/timer.py``: CUDA events, ``krylov_host`` on the host clock).  A
phase that never ran counts 0; a program whose timers lack one of these
phases reads nothing."""

PARTS = ("rhs", "solution_update", "system_vmult", "preconditioner_bc",
         "preconditioner_solver", "krylov_vectors", "krylov_host", "errors")


def read(run: dict):
    spans = run["spans"]
    if not spans or any(p not in spans for p in PARTS) or not spans.get("total"):
        return None
    whole = spans["total"] + (spans["errors"] or 0.0)
    return 1.0 - sum(spans[p] or 0.0 for p in PARTS) / whole
