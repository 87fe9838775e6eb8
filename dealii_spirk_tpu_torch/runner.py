"""Run loop: time stepping, error reporting, convergence table.

Port of ``dealii_spirk_tpu/runner.py::run_config`` (reference
``HeatEquation::Problem::run`` + ``main()``, ``main.cc:3014-3791``): build
the problem, for a stage-parallel scheme the (stage, space) slot mesh,
select the scheme, interpolate the initial condition, loop timesteps with
end-time truncation, report per-step L2/Linf errors, write the ParaView
series where ``DoOutputParaview`` asks for it (``utils/vtk.py``) and fill
one convergence-table row.
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
    device="cuda",
    mesh=None,
    slots: int | None = None,
    verbose: bool = True,
    output_dir: str = ".",
    phase_timers: bool = False,
    **scheme_options,
) -> dict:
    """Run one configuration on ``device`` (the GPU unless asked for
    ``"cpu"``; raises when there is no CUDA device); returns a summary
    dict and fills ``table``.  A stage-parallel scheme runs on ``mesh``, or
    on the mesh that ``make_mesh`` builds from ``slots`` slots on
    ``device`` (default: the stage axis size, a (stage, 1) mesh) and the
    configuration's MaxRanks, DoRowMajor and Padding.  With
    ``DoOutputParaview`` the initial field and every step's go to
    ``output_dir`` as ``result_NNNN.vtr`` with a ``result.pvd`` collection,
    written outside ``solve_step`` so that no step time or phase timer sees
    them.  ``phase_timers``:
    fill t_vmult, t_prec_bc and t_prec_solver by timing those phases in
    place (``PhaseTimers.inner``; off, as the JAX package's
    ``profile_phases``, they read "-"), and with them the phases that no
    column shows (GMRES's ``krylov_vectors`` and ``krylov_host``, the
    V-cycle's ``mg_smooth`` and ``mg_transfer``, each step's ``errors``),
    read from ``out["scheme"].timers.seconds``.  Under a ``torch.profiler``
    session every phase is also a ``spirk.<phase>`` range on the trace,
    whatever ``phase_timers`` says.  ``scheme_options``
    go to the scheme's constructor (``kernels``, ``tables``, ``start``,
    ``cheb_pair``: K8 on the unsharded V-cycles, default from
    ``SPIRK_CHEB_PAIR``)."""
    if table is None:
        table = ConvergenceTable()
    say = print if verbose else (lambda *a, **k: None)

    if params.block_preconditioner_type == "AMG":
        # reference preconditioner.h:176-215 wraps Trilinos ML; the port,
        # as the JAX package, builds a plain-aggregation hierarchy
        # (solvers/amg.py): its counts are the JAX package's, not ML's
        say("NOTE: BlockPreconditionerType 'AMG' runs the plain-aggregation hierarchy "
            "(solvers/amg.py), not Trilinos ML: iteration counts are the JAX package's, "
            "not ML's; see PARITY.md.")

    problem = HeatProblem(params, device)
    sp = problem.space
    if params.is_stage_parallel and mesh is None:
        from .parallel.mesh import make_mesh

        n_slots = params.stage_axis_size if slots is None else slots
        mesh = make_mesh(
            params.stage_axis_size,
            devices=[problem.device] * n_slots,
            max_ranks=params.max_ranks,
            do_row_major=params.do_row_major,
            padding=params.padding,
        )
    scheme = make_scheme(problem, params, mesh=mesh, phase_timers=phase_timers,
                         **scheme_options)
    mesh = getattr(scheme, "mesh", None)  # the scheme may narrow the mesh

    say(
        "\n===========================================\n"
        f"Number of active cells: {sp.n_cells_total}\n"
        f"Number of degrees of freedom: {sp.n_dofs}\n"
    )
    if mesh is not None:
        # virtual-topology dump (reference main.cc:3700-3740): which slot
        # sits at each (stage, space) coordinate, and on which device
        say("Slot grid (stage x space):")
        for ids, devs in zip(mesh.slot_ids, mesh.devices):
            say("  " + " ".join(f"{k:3d}" for k in ids) + "   on " + " ".join(map(str, devs)))

    # table parity: reference main.cc:3387-3398
    n_slots = mesh.slot_ids.size if mesh is not None else 1
    table.add_value("n_levels", sp.refinement + 1)
    table.add_value("n_cells", sp.n_cells_total)
    table.add_value("fe_degree", params.fe_degree)
    table.add_value("n_dofs", sp.n_dofs)
    table.add_value("n_stages", params.irk_stages)
    table.add_value("n_procs", n_slots if slots is None else slots)
    table.add_value("n_procs_global", n_slots)
    table.add_value("n_procs_row", mesh.n_stage if mesh is not None else 1)
    table.add_value("n_procs_column", mesh.n_space if mesh is not None else 1)

    paraview = None
    if params.do_output_paraview:
        from .utils.vtk import ParaviewSeries

        paraview = ParaviewSeries(output_dir)

    u = problem.initial_condition()
    time = 0.0
    timestep_number = 0
    error = problem.errors(u, time)
    if paraview is not None:
        paraview.write(u, sp.fine.x, time, timestep_number)
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

        # the whole field on the scheme's device: a mesh scheme gathers its
        # solution inside solve_step
        u = scheme.solve_step(u, timestep_number, time, tau)

        error = problem.errors(u, time)
        errors_history.append(error)
        if paraview is not None:
            paraview.write(u, sp.fine.x, time, timestep_number)
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
