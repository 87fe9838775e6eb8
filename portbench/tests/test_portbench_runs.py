"""The harness driven on the CPU at small grids (the kernels' plain
versions): the seeded field, the reference against the port, the verdict
on sound runs, on planted faults and on the control, and cells, traffic
and metrics found by name."""

import json
import subprocess
import sys

import pytest
import torch

from portbench import check, run, workload
from portbench.reference import modal_radau

# refinements at which the CPU runs are small; at the complex cell's
# refinement 3 the pair GMRES's tolerance leaves a gap in rel_l2 above its
# limit, set from the cell's own size (refinement 8)
SMALL = {"irk_q4_p4.closed_loop": 2, "cirkb_q5_p1.closed_loop": 5}
CELLS = sorted(SMALL)
SEED = 2**31 + 977


def small(cell):
    return {"NRefinements": SMALL[cell]}


@pytest.mark.parametrize("cell", CELLS)
def test_field_repeats_for_each_seed(cell):
    c = run.Cell(cell, "cpu", overrides={"NRefinements": 2})
    a, b = c.start(SEED), c.start(SEED)
    assert torch.equal(a, b)
    assert a.shape == (4 * int(c.params["FEDegree"]) - 1,) * 3
    others = [c.start(SEED + i) for i in range(1, 8)]
    assert all(not torch.equal(a, o) for o in others)


@pytest.mark.parametrize("cell", CELLS)
def test_seeded_field_leaves_the_solvers_work_as_it_is(cell):
    """The seeded perturbation is too small to move a count: each step's
    GMRES iterations and V-cycles equal those from the manufactured field
    alone, for every seed."""
    c = run.Cell(cell, "cpu", overrides=small(cell))
    log = c.system.scheme.step_log

    def counts(u0):
        n = len(log)
        c.episode(u0)
        return [(e["n_outer"], e["n_inner"]) for e in log[n:]]

    unperturbed = counts(c.start(SEED, {**c.traffic["field"], "amplitude": 0.0}))
    for seed in (SEED, 5, 10**12 + 39):
        assert counts(c.start(seed)) == unperturbed
    # ten times the amplitude moves no count either
    loud = {**c.traffic["field"], "amplitude": 10 * c.traffic["field"]["amplitude"]}
    assert counts(c.start(SEED, loud)) == unperturbed


@pytest.mark.parametrize("cell", CELLS)
def test_reference_is_the_ports_step_in_f64(cell):
    """The port in f64 with a tight tolerance and the reference agree to
    rounding: the tables, the 1D matrices, the load and the stage solve."""
    c = run.Cell(cell, "cpu", overrides={**small(cell), "Precision": "f64",
                                         "OuterTolerance": 1e-12})
    u = c.start(SEED)
    ref = modal_radau.run(c.params, u, c.steps, "cpu")
    for k, u_ref in enumerate(ref, start=1):
        u, _ = c.system.step(u, k * c.tau, c.tau)
        assert float((u - u_ref).norm() / u_ref.norm()) < 1e-10


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = run.run_cell(cell, SEED, 3.0, False, device="cpu", overrides=small(cell))
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"step_ms", "setup_s"}  # no device memory on the CPU
    assert list(res)[-1] == "checks"


def unchanged(system):
    system.scheme.solve_step = lambda u, n, t, tau: u


def half_lanes(system):
    """Half of the stage lanes left out of the update, the rest scaled to
    their mean."""
    update = system.scheme.update_fn

    def broken(u, W, tau):
        h = W.shape[0] // 2
        W = W.clone()
        W[h:] = 0
        W[:h] *= W.shape[0] / h
        return update(u, W, tau)

    system.scheme.update_fn = broken


def altered(system):
    """One value of each step's answer raised by 1% of the field's largest."""
    solve = system.scheme.solve_step

    def broken(u, n, t, tau):
        out = solve(u, n, t, tau).clone()
        flat = out.view(-1)
        flat[flat.numel() // 3] += 0.01 * flat.abs().max()
        return out

    system.scheme.solve_step = broken


@pytest.mark.parametrize("fault", [unchanged, half_lanes, altered])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault):
    res = run.run_cell(cell, SEED, 0.3, False, device="cpu", overrides=small(cell), fault=fault)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    """The reference in TF32 (its operands rounded on the CPU) put in the
    program's place fails the cell's limits."""
    c = run.Cell(cell, "cpu", overrides=small(cell))
    ok, shown = check.judge(run.reference_numbers(c, SEED, None, precision="tf32"), c.limits)
    assert not ok, shown


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(cell, cuda_device):
    """On the card at the cell's own size: the program's episodes within
    every limit, the TF32 control past one."""
    from portbench import calibrate

    rows = calibrate.readings(cell, [SEED + i for i in range(3)], 3, device=cuda_device)
    limits = check.load_limits(cell)
    assert rows[0]["side"] == "unperturbed"
    for r in rows[1:]:
        ok, shown = check.judge(r, limits)
        assert ok == (r["side"] == "program"), (r["side"], shown)


def test_new_config_cell_traffic_and_metric_are_found_by_name():
    """A configuration, a cell, its traffic mix, its limits and a
    per-layer metric added as new files run with no edit to the harness."""
    names = {"config": "tmp_test_config", "traffic": "tmp_test_traffic",
             "metric": "tmp_test_steps", "cell": "tmp_test.cell"}
    files = [
        run.HERE / "configs" / f"{names['config']}.json",
        run.HERE / "traffic" / f"{names['traffic']}.json",
        run.HERE / "metrics" / f"{names['metric']}.py",
        run.HERE / "limits" / f"{names['cell']}.json",
    ]
    if any(f.exists() for f in files):
        pytest.skip("a file of this test's names is already there")
    config = workload.load("configs", "irk_q4_p4")
    config["name"] = names["config"]
    config["parameters"].update(NRefinements=2, TimeStepSize=0.05, EndTime=0.15)
    traffic = workload.load("traffic", "closed_loop")
    traffic["field"]["modes"] = [[1, 1, 2]]
    bench = run.load_bench()
    bench["configs"].append({"name": names["config"], "source": "test",
                             "file": f"portbench/configs/{names['config']}.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": names["cell"], "config": names["config"],
                               "traffic": names["traffic"], "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": names["metric"], "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "test", "moves": "step_ms",
                               "workloads": [names["cell"]]})
    try:
        files[0].write_text(json.dumps(config))
        files[1].write_text(json.dumps(traffic))
        files[2].write_text("def read(run):\n    return run['steps']\n")
        files[3].write_text((run.HERE / "limits" / "irk_q4_p4.closed_loop.json").read_text())
        c = run.Cell(names["cell"], "cpu", bench=bench)
        assert c.steps == 3 and c.traffic["field"]["modes"] == [[1, 1, 2]]
        assert run.read_metric(names["metric"], {"steps": 7}) == 7
        assert [m["name"] for m in run.cell_metrics(bench, names["cell"], True)] == [names["metric"]]
        res = run.run_cell(names["cell"], SEED, 0.3, False, device="cpu", bench=bench)
        assert res["correct"], res["checks"]
        assert res["attempted"] > 0
    finally:
        for f in files:
            f.unlink(missing_ok=True)


def test_spans_and_launch_shapes_are_read_from_the_port():
    """Inside ``spans`` the phase timers time the vmult and the
    preconditioner in place, and only there; ``launch_shapes`` records each
    kernel wrapper's call with its level and lanes, and restores the
    wrappers."""
    from dealii_spirk_tpu_torch.ops.cuda import stencil

    c = run.Cell("irk_q4_p4.closed_loop", "cpu", overrides={"NRefinements": 2, "EndTime": 0.2})
    with c.system.spans() as spans:
        c.episode(c.start(SEED))
    assert spans["system_vmult"] > 0 and spans["preconditioner_solver"] > 0
    assert not c.system.scheme.timers.inner
    before = {k: getattr(stencil, k) for k in stencil.LAUNCHES if hasattr(stencil, k)}
    with c.system.launch_shapes() as shapes:
        c.episode(c.start(SEED))
    assert {k: getattr(stencil, k) for k in before} == before
    levels = {int(ops.m) for ops in c.system.scheme.gmg.level_ops}
    smooth = [s for s in shapes if s["kernel"] == "cheb_iter"]
    assert smooth and all(s["m"] in levels and s["p"] == 4 for s in smooth)
    # irk smooths one stage at a time
    assert {s["lanes"] for s in smooth} == {1}


CHILD = """
import json, sys
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(1)
{body}
print(json.dumps(sorted({{m.split('.', 1)[0] for m in sys.modules}})))
"""


def loaded_after(body: str) -> list:
    out = subprocess.run([sys.executable, "-c", CHILD.format(root=str(run.ROOT), body=body)],
                         capture_output=True, text=True, timeout=600, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax():
    names = loaded_after("from portbench import run\n"
                         "run.run_cell('irk_q4_p4.closed_loop', 5, 0.2, False, "
                         "device='cpu', overrides={'NRefinements': 2})")
    assert "dealii_spirk_tpu_torch" in names
    assert not set(names) & {"jax", "jaxlib", "flax", "dealii_spirk_tpu"}


def test_the_reference_loads_nothing_of_the_port():
    names = loaded_after("from portbench.reference import modal_radau\n"
                         "list(modal_radau.run({'FEDegree': 2, 'NRefinements': 2, "
                         "'IRKStages': 3, 'TimeStepSize': 0.1}, "
                         "torch.ones(7, 7, 7, dtype=torch.float64), 2, 'cpu'))")
    assert not set(names) & {"dealii_spirk_tpu_torch", "dealii_spirk_tpu", "jax", "jaxlib"}
