"""The control comes out not correct: the plain reference put in the
program's place one precision down (bfloat16 for the filter; float32
with TF32 for BA, which only a card has) fails the cell's limits, while
the program's own run passes them. On the card the same holds at each
cell's own size (``python -m benchmark.control``)."""

import pytest
from conftest import CELLS


@pytest.mark.parametrize("cell", [c for c in CELLS if "ba10k" not in c])
def test_control_fails_the_filter_cells(run_cell, cell):
    rc, result, err = run_cell(cell, control=True)
    assert rc == 0, err[-3000:]
    assert result["correct"], result["compared"]
    assert not result["control_correct"], result["control"]


@pytest.mark.cuda
def test_control_fails_ba_on_the_card(run_cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists only on a CUDA card")
    from benchmark import run
    import io, json, contextlib
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", "config5-1m.ba10k", "--seed", "5",
                       "--seconds", "2", "--trace", "0"], control=True)
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rc == 0 and result["correct"]
    assert not result["control_correct"], result["control"]
