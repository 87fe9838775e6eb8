"""Run loop: time stepping, error reporting, convergence table.

Port of ``dealii_spirk_tpu/runner.py::run_config`` (reference
``HeatEquation::Problem::run`` + ``main()``, ``main.cc:3014-3791``) for one
device: build the problem, select the scheme, interpolate the initial
condition, loop timesteps with end-time truncation, report per-step
L2/Linf errors and fill one convergence-table row.  The device mesh and
the paraview output are not ported yet.
"""

from __future__ import annotations

from .config import Parameters
from .problem import HeatProblem
from .schemes import make_scheme
from .utils.table import ConvergenceTable


def run_config(
    params: Parameters,
    table: ConvergenceTable | None = None,
    *,
    device="cpu",
    verbose: bool = True,
    **scheme_options,
) -> dict:
    """Run one configuration on ``device``; returns a summary dict and
    fills ``table``.  ``scheme_options`` go to the scheme's constructor
    (``kernels``, ``tables``, ``start`` for ``irk_batched``)."""
    if table is None:
        table = ConvergenceTable()
    say = print if verbose else (lambda *a, **k: None)

    problem = HeatProblem(params, device)
    sp = problem.space
    scheme = make_scheme(problem, params, **scheme_options)
    if params.do_output_paraview:
        say("NOTE: paraview output is not ported yet; DoOutputParaview ignored")

    say(
        "\n===========================================\n"
        f"Number of active cells: {sp.n_cells_total}\n"
        f"Number of degrees of freedom: {sp.n_dofs}\n"
    )
    # table parity: reference main.cc:3387-3398 (one device: 1 x 1 grid)
    table.add_value("n_levels", sp.refinement + 1)
    table.add_value("n_cells", sp.n_cells_total)
    table.add_value("fe_degree", params.fe_degree)
    table.add_value("n_dofs", sp.n_dofs)
    table.add_value("n_stages", params.irk_stages)
    for col in ("n_procs", "n_procs_global", "n_procs_row", "n_procs_column"):
        table.add_value(col, 1)

    u = problem.initial_condition()
    time = 0.0
    timestep_number = 0
    error = problem.errors(u, time)
    say(f"   Error in the L2/Linf norm : {error[0]:.6e}/{error[1]:.6e}")

    dt = params.auto_time_step(sp.dx_min)
    say(f"\nStarting time loop with dt={dt}")
    if dt >= params.end_time:
        raise ValueError("time step must be smaller than the end time")

    errors_history = [error]
    # reference main.cc:3326-3358: truncate the last step to land on T
    while (params.end_time - time) > (1e-4 * dt):
        if time + dt > params.end_time:
            tau = params.end_time - time
            time = params.end_time
        else:
            tau = dt
            time += dt
        say(f"\nTime step {timestep_number} at t={time:g}")
        timestep_number += 1

        u = scheme.solve_step(u, timestep_number, time, tau)

        error = problem.errors(u, time)
        errors_history.append(error)
        say(f"   Error in the L2/Linf norm : {error[0]:.6e}/{error[1]:.6e}")

    table.add_value("n_t", timestep_number)
    table.add_value("final_t", time)
    table.set_scientific("final_t", True)
    table.add_value("dt", dt)
    table.set_scientific("dt", True)
    table.add_value("error_L2", error[0])
    table.set_scientific("error_L2", True)
    table.add_value("error_Linf", error[1])
    table.set_scientific("error_Linf", True)
    # timers and counters were cleared after step 1 (setup excluded)
    step_seconds = scheme.timers.durations("total")
    scheme.get_statistics(table, max(timestep_number - 1, 1))
    table.commit_row()

    return {
        "n_timesteps": timestep_number,
        "dt": dt,
        "error_L2": error[0],
        "error_Linf": error[1],
        "errors": errors_history,
        "n_outer": scheme.n_outer,
        "n_inner": scheme.n_inner,
        "step_seconds": step_seconds,
        "scheme": scheme,
        "table": table,
        "u": u,
    }
