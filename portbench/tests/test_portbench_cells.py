"""Every cell run by the harness on the CPU at a tiny size: the port against
the plain reference comes out correct, the control (the reference in TF32
put in the program's place) does not, and neither does a run whose timed
path is broken underneath by one of the faults a cell can have."""

import json

import pytest

from portbench import faults, harness
from portbench.tests.tiny import workloads

CELLS = workloads()
FIT_CELLS = [w for w in CELLS if w.startswith("fit-")]
KMEANS_CELLS = [w for w in CELLS if w.startswith("kmeans-")]


def _run(root, workload, trace=False):
    return harness.run_cell(root, workload, 2**31 + 7, 0.0, trace, device="cpu")


@pytest.mark.parametrize("workload", CELLS)
def test_the_port_against_the_reference(tiny_root, workload):
    out = _run(tiny_root, workload)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {m["name"] for m in harness.cell_plan(tiny_root, workload).e2e}
    assert list(out)[-1] == "checks"
    json.dumps(out)


def test_a_traced_run_reads_its_per_layer_metrics(tiny_root):
    out = _run(tiny_root, "fit-epsilon-16sites-topk", trace=True)
    assert out["correct"]
    # the CPU runs no device operation: the readers of the trace find nothing,
    # the ledger's counter is there
    assert set(out["metrics"]) == {"uplink_bytes_per_round.fit"}
    assert out["metrics"]["uplink_bytes_per_round.fit"]["value"] == 16 * 3 * 8
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(tiny_root, workload):
    plan = harness.cell_plan(tiny_root, workload)
    entry = harness.load_module(tiny_root / "portbench" / "entries" / f"{plan.cfg['entry']}.py",
                                "portbench_entry_test")
    st = entry.setup(plan.cfg, plan.traffic, 11, "cpu")
    ref = entry.reference(st, "float64", None)
    control = entry.readings(st, entry.reference(st, "tf32", None), ref)
    # the control has no window: it is judged on the numbers it has
    ok, checks, _ = harness.judge(control, {k: v for k, v in plan.limits.items()
                                            if k in control})
    assert not ok, checks
    ok, checks, _ = harness.judge(entry.readings(st, entry.program_output(st), ref),
                                  plan.limits)
    assert ok, checks


BROKEN = ([pytest.param(w, f, id=f"{w}-{f}") for w in CELLS for f in faults.FAULTS]
          + [pytest.param(w, f, id=f"{w}-{f}") for w in FIT_CELLS for f in faults.FIT_FAULTS])


@pytest.mark.parametrize(("workload", "fault"), BROKEN)
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, workload, fault):
    faults.plant(monkeypatch.setattr, "fit" if workload in FIT_CELLS else "kmeans", fault)
    out = _run(tiny_root, workload)
    assert not out["correct"], out["checks"]
    assert out["failed"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_tiny_cells_on_the_card(tiny_root, card, workload):
    out = harness.run_cell(tiny_root, workload, 5, 0.0, False, device=card)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["memory_peak_bytes"] > 0
