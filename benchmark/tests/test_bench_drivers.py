"""Each cell runs end to end on the CPU at a test's size through the
harness (``benchmark.run.main`` with a device named, which skips the look
for a card): a result line with the cell's metrics and ``correct``
true. The measured path itself exits 2 without a card."""

import pytest
from conftest import CELLS

from benchmark import run


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_end_to_end_on_the_cpu(run_cell, cell, trace):
    rc, result, err = run_cell(cell, trace=trace)
    assert rc == 0, err[-3000:]
    assert result["correct"], result["compared"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[-1] == "compared"
    want = {m["name"] for m in run.metrics_of(cell, bool(trace))}
    if trace:
        want -= {"k5_roofline", "k6_roofline"}   # device traces only
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    if result["attempted"] < 25:
        want.discard("ba_solve_ms_p95")      # needs 20 untraced solves
    assert set(result["metrics"]) == want
    assert err.strip().splitlines()[-1].startswith("check ")


def test_the_measured_path_needs_a_card(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                   "1", "--trace", "0"])
    assert rc == 2 and capsys.readouterr().out == ""
