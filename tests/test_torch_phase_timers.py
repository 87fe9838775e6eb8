"""The port's in-place phase timers and its CLI switches, on the CPU.

* For every ported scheme (``irk``, ``irk_batched``, ``spirk``,
  ``complex_irk``, ``complex_irk_batched``, ``complex_spirk``,
  ``complex_spirk_batched``; the stage-parallel ones on a mesh of CPU
  slots) at 3D refinement 2, q=3, two steps, f64: with ``phase_timers`` the
  table's ``t_vmult``, ``t_prec_bc`` and ``t_prec_solver`` are numbers, each
  at most ``t_solver``, and ``t_prec_solver_0..9`` split ``t_prec_solver``;
  without, they are None (printed "-"); both runs give the same per-step
  counts and the same L2 error, bit for bit;
* the CLI parses ``--no-phase-timers`` and ``--profile DIR`` (phase timers
  on by default), and ``--profile`` writes a ``torch.profiler`` trace.
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


def _run(scheme: str, phase_timers: bool) -> dict:
    params = Parameters.from_dict({**BASE, "TimeIntegrationScheme": scheme}, dim=3)
    out = run_config(params, device="cpu", verbose=False, phase_timers=phase_timers)
    row = out["table"].rows[-1]
    return {"row": row, "log": out["scheme"].step_log, "l2": out["error_L2"]}


@pytest.mark.parametrize("scheme", SCHEMES)
def test_phase_timers_fill_the_table(scheme):
    on, off = _run(scheme, True), _run(scheme, False)
    assert on["log"] == off["log"]
    assert on["l2"] == off["l2"]
    row = on["row"]
    for col in INNER:
        assert isinstance(row[col], float) and 0.0 < row[col] <= row["t_solver"], (col, row)
        assert off["row"][col] is None
    split = sum(row[f"t_prec_solver_{i}"] for i in range(10))
    assert split == pytest.approx(row["t_prec_solver"], rel=1e-12)


def test_cli_flags():
    parser = build_parser()
    args = parser.parse_args(["cfg.json"])
    assert args.phase_timers and args.profile is None
    args = parser.parse_args(["--no-phase-timers", "--profile", "out", "cfg.json"])
    assert not args.phase_timers and args.profile == "out"


def test_cli_profile_writes_a_trace(tmp_path, capsys):
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({**BASE, "NRefinements": 1, "TimeIntegrationScheme": "irk_batched"}))
    trace_dir = tmp_path / "trace"
    assert tmain(["--device", "cpu", "--profile", str(trace_dir), str(cfg)]) == 0
    trace = json.loads((trace_dir / "trace.json").read_text())
    assert trace["traceEvents"]
    text = capsys.readouterr().out
    assert "t_vmult" in text
