"""The port's in-place phase timers and its CLI switches, on the CPU.

* For every ported scheme (``irk``, ``irk_batched``, ``spirk``,
  ``complex_irk``, ``complex_irk_batched``, ``complex_spirk``,
  ``complex_spirk_batched``; the stage-parallel ones on a mesh of CPU
  slots) at 3D refinement 2, q=3, two steps, f64: with ``phase_timers`` the
  table's ``t_vmult``, ``t_prec_bc`` and ``t_prec_solver`` are numbers, each
  at most ``t_solver``, and ``t_prec_solver_0..9`` split ``t_prec_solver``;
  without, they are None (printed "-"); the phases below them
  (``krylov_vectors``, ``krylov_host``, ``mg_smooth``, ``mg_transfer``,
  ``errors``) read positive numbers, each at most the phase that encloses
  it; both runs give the same per-step counts, the same L2 error and the
  same field, bit for bit;
* under a CPU ``torch.profiler`` session with the inner phases off, every
  phase lies on the trace as a ``user_annotation`` range ``spirk.<phase>``;
  with no profiler and the inner phases off, entering one records nothing;
* the CLI parses ``--no-phase-timers`` and ``--profile DIR`` (phase timers
  on by default), and ``--profile`` writes a ``torch.profiler`` trace that
  holds the ``spirk.*`` ranges.
"""

import json

import pytest
import torch

# one intra-op thread: the tests run beside other test processes
torch.set_num_threads(1)

from dealii_spirk_tpu_torch.__main__ import build_parser
from dealii_spirk_tpu_torch.__main__ import main as tmain
from dealii_spirk_tpu_torch.config import Parameters
from dealii_spirk_tpu_torch.runner import run_config
from dealii_spirk_tpu_torch.utils.timer import OFF, RANGE_PREFIX, PhaseTimers

SCHEMES = ("irk", "irk_batched", "spirk", "complex_irk", "complex_irk_batched",
           "complex_spirk", "complex_spirk_batched")
BASE = {
    "FEDegree": 1,
    "NRefinements": 2,
    "IRKStages": 3,
    "TimeStepSize": 0.1,
    "EndTime": 0.2,
    "OperatorType": "MatrixFree",
    "BlockPreconditionerType": "GMG",
    "InnerTolerance": 0.0,
    "OuterTolerance": 1e-8,
    "Precision": "f64",
    "DoOutputParaview": False,
}
INNER = ("t_vmult", "t_prec_bc", "t_prec_solver")
# the phases below the table's columns, each with the phase that encloses it
CHILDREN = {"krylov_vectors": "outer_solver", "krylov_host": "outer_solver",
            "mg_smooth": "preconditioner_solver", "mg_transfer": "preconditioner_solver"}


def _run(scheme: str, phase_timers: bool, **over) -> dict:
    params = Parameters.from_dict({**BASE, "TimeIntegrationScheme": scheme, **over}, dim=3)
    out = run_config(params, device="cpu", verbose=False, phase_timers=phase_timers)
    row = out["table"].rows[-1]
    return {"row": row, "log": out["scheme"].step_log, "l2": out["error_L2"], "u": out["u"],
            "seconds": out["scheme"].timers.seconds}


@pytest.mark.parametrize("scheme", SCHEMES)
def test_phase_timers_fill_the_table(scheme):
    on, off = _run(scheme, True), _run(scheme, False)
    assert on["log"] == off["log"]
    assert on["l2"] == off["l2"]
    assert torch.equal(on["u"], off["u"])
    row = on["row"]
    for col in INNER:
        assert isinstance(row[col], float) and 0.0 < row[col] <= row["t_solver"], (col, row)
        assert off["row"][col] is None
    split = sum(row[f"t_prec_solver_{i}"] for i in range(10))
    assert split == pytest.approx(row["t_prec_solver"], rel=1e-12)
    s = on["seconds"]
    for child, parent in CHILDREN.items():
        assert 0.0 < s[child] <= s[parent], (child, s)
        assert off["seconds"][child] is None
    assert s["krylov_vectors"] + s["krylov_host"] <= s["outer_solver"]
    assert s["mg_smooth"] + s["mg_transfer"] <= s["preconditioner_solver"]
    assert s["errors"] > 0.0 and off["seconds"]["errors"] is None


def _ranges(trace: dict) -> set:
    return {e["name"][len(RANGE_PREFIX):] for e in trace["traceEvents"]
            if e.get("cat") == "user_annotation" and e.get("name", "").startswith(RANGE_PREFIX)}


@pytest.mark.parametrize("scheme", ["irk", "irk_batched", "complex_irk_batched"])
def test_profiler_ranges_name_every_phase(scheme, tmp_path):
    """With the inner phases off, a profiler session still sees every
    phase as a ``spirk.<phase>`` range, and the timers record none of
    the inner phases."""
    path = tmp_path / "trace.json"
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = _run(scheme, False)
    prof.export_chrome_trace(str(path))
    assert _ranges(json.loads(path.read_text())) == set(PhaseTimers.PHASES)
    assert all(out["seconds"][p] is None for p in PhaseTimers.INNER)


def test_phase_off_records_nothing():
    """No profiler and the inner phases off: an inner phase is the shared
    empty context and leaves no span; the step's own phases still time."""
    timers = PhaseTimers("cpu", inner=False)
    for name in PhaseTimers.PHASES:
        cm = timers.phase(name)
        assert (cm is OFF) == (name in PhaseTimers.INNER)
        with cm:
            pass
    assert {p for p, v in timers.seconds.items() if v is not None} == {
        "total", "rhs", "outer_solver", "solution_update"}


def test_cli_flags():
    parser = build_parser()
    args = parser.parse_args(["cfg.json"])
    assert args.phase_timers and args.profile is None
    args = parser.parse_args(["--no-phase-timers", "--profile", "out", "cfg.json"])
    assert not args.phase_timers and args.profile == "out"


def test_cli_profile_writes_a_trace(tmp_path, capsys):
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({**BASE, "TimeIntegrationScheme": "irk_batched"}))
    trace_dir = tmp_path / "trace"
    assert tmain(["--device", "cpu", "--profile", str(trace_dir), str(cfg)]) == 0
    trace = json.loads((trace_dir / "trace.json").read_text())
    assert trace["traceEvents"]
    assert _ranges(trace) == set(PhaseTimers.PHASES)
    text = capsys.readouterr().out
    assert "t_vmult" in text
