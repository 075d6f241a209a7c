"""r1_roofline: R1's bytes by hand at the cells' particle counts, the
share's arithmetic, and its cells in BENCHMARK.json."""

import json

import pytest
from conftest import ROOT

from benchmark import run

H100 = "NVIDIA H100 80GB HBM3"


def metric():
    return run.load_module(ROOT / "benchmark" / "metrics" / "r1_roofline.py")


@pytest.mark.parametrize("P,nbytes", [(2 ** 20, 12_582_912),
                                      (2 ** 17, 1_572_864),
                                      (2 ** 15, 393_216)])
def test_r1_bytes_by_hand(P, nbytes):
    # The prefix sum read, the dither read at k, the bounds written.
    assert metric().r1_bytes(P) == P * 4 + P * 4 + P * 4 == nbytes


def test_r1_bytes_at_the_dense_cell_take_3_76_us():
    assert round(metric().r1_bytes(2 ** 20) / 3.35e12 * 1e6, 2) == 3.76


def test_r1_roofline_arithmetic():
    r1 = metric()
    P = 2 ** 20
    seconds = r1.r1_bytes(P) / 3.35e12 * 4                  # a quarter
    name = "(anonymous namespace)::offspring_bounds_kernel(float const*)"
    ctx = {"trace": {"ops": {name: (seconds * 20, 20)}},
           "device_kind": H100, "shapes": {"P": P, "L": 192, "K": 96}}
    assert r1.read(ctx) == pytest.approx(25.0)
    assert r1.read(dict(ctx, trace=None)) is None
    assert r1.read(dict(ctx, trace={"ops": {}})) is None
    cummax = "void at::native::tensor_kernel_scan_innermost_dim_with_indices"
    assert r1.read(dict(ctx, trace={"ops": {cummax: (1e-3, 20)}})) is None
    assert r1.read(dict(ctx, device_kind="cpu")) is None


def test_r1_roofline_lists_the_two_cells():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry, = [m for m in spec["per_layer"] if m["name"] == "r1_roofline"]
    assert entry["workloads"] == ["config5-1m.dense",
                                  "dense200-fs2-131072.loop"]
    assert (entry["unit"], entry["better"], entry["source"], entry["layer"],
            entry["moves"]) == ("%", "higher", "device_trace", "kernels",
                                "ticks_per_s")
