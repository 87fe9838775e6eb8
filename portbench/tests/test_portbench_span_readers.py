"""The readers of the port's span metrics: each phase's milliseconds per
step, and the share of the step that no leaf phase covers, read from a
synthetic run record and from one the port's timers filled on the CPU."""

import math

import pytest

from portbench import run

READERS = {
    "rhs_ms_per_step": "rhs",
    "krylov_vectors_ms_per_step": "krylov_vectors",
    "krylov_host_ms_per_step": "krylov_host",
    "mg_smooth_ms_per_step": "mg_smooth",
    "mg_transfer_ms_per_step": "mg_transfer",
    "errors_ms_per_step": "errors",
}
# seconds over 4 steps; the leaves sum to 0.9 + 0.05 of total + errors
SPANS = {
    "steps": 4, "total": 0.9, "rhs": 0.04, "outer_solver": 0.8, "solution_update": 0.01,
    "system_vmult": 0.1, "preconditioner_bc": 0.05, "preconditioner_solver": 0.5,
    "krylov_vectors": 0.08, "krylov_host": 0.02, "mg_smooth": 0.3, "mg_transfer": 0.15,
    "errors": 0.1,
}


@pytest.mark.parametrize("metric, phase", sorted(READERS.items()))
def test_phase_reader(metric, phase):
    assert math.isclose(run.read_metric(metric, {"spans": SPANS}), SPANS[phase] / 4 * 1e3)
    assert run.read_metric(metric, {"spans": {**SPANS, phase: None}}) is None
    parent = {k: v for k, v in SPANS.items() if k != phase}
    assert run.read_metric(metric, {"spans": parent}) is None
    assert run.read_metric(metric, {"spans": None}) is None


def test_unspanned_share():
    # leaves 0.04 + 0.01 + 0.1 + 0.05 + 0.5 + 0.08 + 0.02 + 0.1 = 0.9 of 1.0
    assert math.isclose(run.read_metric("unspanned_share", {"spans": SPANS}), 0.1)
    # a phase that never ran counts 0
    none_bc = {**SPANS, "preconditioner_bc": None}
    assert math.isclose(run.read_metric("unspanned_share", {"spans": none_bc}), 0.15)
    # timers without the new phases, or with no step timed, read nothing
    old = {k: v for k, v in SPANS.items() if k not in ("krylov_host", "errors")}
    assert run.read_metric("unspanned_share", {"spans": old}) is None
    assert run.read_metric("unspanned_share", {"spans": {**SPANS, "total": None}}) is None
    assert run.read_metric("unspanned_share", {"spans": None}) is None


def test_readers_read_the_ports_spans():
    """An episode inside ``System.spans`` on the CPU: every new metric
    reads a positive number, the V-cycle's phases fit in the block solves
    and the leaves in the step."""
    c = run.Cell("cirkb_q5_p1.closed_loop", "cpu", overrides={"NRefinements": 3, "EndTime": 0.2})
    with c.system.spans() as spans:
        c.episode(c.start(5))
    record = {"spans": {"steps": c.steps, **spans}}
    values = {m: run.read_metric(m, record) for m in (*READERS, "unspanned_share")}
    assert all(v is not None and v > 0 for v in values.values()), values
    assert spans["mg_smooth"] + spans["mg_transfer"] <= spans["preconditioner_solver"]
    assert values["unspanned_share"] < 1
