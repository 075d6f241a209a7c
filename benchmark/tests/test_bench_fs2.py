"""The FastSLAM 2 cell, ``dense200-fs2-131072.loop``, on the CPU: the
harness's whole run (``benchmark.run.main`` with a device named) at a
test's size, correct, with its metrics; the control (the reference in
bfloat16 in the program's place) failing; faults planted in the program
failing the check. The world read from the map file equals the
program's loader's; the plain reference loads nothing of the program;
K3's bytes and operations by hand, and the readers' arithmetic."""

import subprocess
import sys

import numpy as np
import pytest
from conftest import ROOT

from benchmark import run

CELL = "dense200-fs2-131072.loop"
H100 = "NVIDIA H100 80GB HBM3"


def tiny_fs2(config: dict, workload: dict) -> None:
    """The cell cut to a CPU test's size: 256 particles (the world, its
    200 slots and the 15 observation slots kept), runs of 12 supersteps
    (the vehicle sees its first landmark at superstep 3), 2-3 copied in
    each of two runs, a 4-superstep sub-window."""
    config["n_particles"] = 256
    t = workload["traffic"]
    t["supersteps_per_run"] = 12
    t["capture"] = {"runs": 2, "within": 2, "per_run": [2, 3]}
    t["trace"] = [0, 4, 4]
    workload["shapes"]["P"] = 256


@pytest.mark.parametrize("trace", [0, 1])
def test_fs2_cell_runs_end_to_end_on_the_cpu(run_cell, trace):
    rc, result, err = run_cell(CELL, trace=trace, adjust=tiny_fs2)
    assert rc == 0, err[-3000:]
    assert result["correct"], result["compared"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    want = {m["name"] for m in run.metrics_of(CELL, bool(trace))}
    if trace:
        want.discard("k3_roofline")        # device traces only
        for name in ("host_share.fs2_predict", "host_share.fs2_update",
                     "host_share.fs2_propose"):
            assert 0 < result["metrics"][name]["value"] < 100, name
    assert set(result["metrics"]) == want
    assert "info matched" in err and "ate_m" in err
    assert result["compared"]["proposal_z"]["value"] is not None


def test_control_fails(run_cell):
    rc, result, err = run_cell(CELL, control=True, adjust=tiny_fs2)
    assert rc == 0, err[-3000:]
    assert result["correct"], result["compared"]
    assert not result["control_correct"], result["control"]
    for name in ("predict_xv_gap", "predict_pv_gap", "proposal_z",
                 "weight_gap", "weight_tv", "lm_gap", "lmcov_gap"):
        c = result["control"][name]
        assert c["value"] > c["limit"], (name, c)


def _heading_skipped(mp):
    from slam_tpu_torch.models import rbpf
    mp.setattr(rbpf, "observe_heading_particles", lambda st, *a: st)


def _sample_at_the_mean(mp):
    """The proposal's draw left out: every particle at the refined
    mean."""
    from slam_tpu_torch.models import fastslam2
    mp.setattr(fastslam2, "proposal_noise",
               lambda n, gen: __import__("torch").zeros(
                   (3, n), device=gen.device))


def _weight_term_dropped(mp):
    from slam_tpu_torch.models import fastslam2
    inner = fastslam2.fs2_propose

    def dropped(state, *a):
        out = inner(state, *a)
        return out._replace(logw=state.logw.clone())
    mp.setattr(fastslam2, "fs2_propose", dropped)


def _pv_kept(mp):
    """The pose covariance not zeroed after the sample."""
    from slam_tpu_torch.models import fastslam2
    inner = fastslam2.fs2_propose

    def kept(state, *a):
        return inner(state, *a)._replace(Pv=state.Pv.clone())
    mp.setattr(fastslam2, "fs2_propose", kept)


@pytest.mark.parametrize("fault", [_heading_skipped, _sample_at_the_mean,
                                   _weight_term_dropped, _pv_kept])
def test_a_fault_in_the_program_is_not_correct(run_cell, monkeypatch,
                                               fault):
    fault(monkeypatch)
    rc, result, err = run_cell(CELL, adjust=tiny_fs2)
    assert rc == 0, err[-3000:]
    assert not result["correct"], result["compared"]


def test_map_file_reads_as_the_program_does():
    from benchmark.map_file import file_world, read_map
    from slam_tpu_torch.maps import read_map_file
    path = ROOT / "data" / "dense200.mat"
    m, want = read_map(path), read_map_file(str(path))
    assert np.array_equal(m["lm"], want.landmarks)
    assert np.array_equal(m["wp"], want.waypoints)
    lms, wps = file_world({"file": "data/dense200.mat",
                           "origin": "waypoint0"})
    assert np.array_equal(wps[0], [0.0, 0.0])
    assert np.array_equal(lms, want.landmarks - want.waypoints[0])
    assert np.array_equal(file_world({"file": "data/dense200.mat"})[0],
                          want.landmarks)


def test_reference_loads_nothing_of_the_program():
    code = ("import sys, benchmark.reference.fastslam2, benchmark.map_file;"
            " print(' '.join(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert not set(out.stdout.split()) & {"jax", "jaxlib", "flax",
                                          "slam_tpu", "slam_tpu_torch"}


def test_matched_counts_by_hand():
    from benchmark.drivers.fs2_loop import matched_counts
    ids = np.array([[4, 7, 0], [7, 9, 4], [9, 2, 0], [2, 4, 7]])
    mask = np.array([[1, 1, 0], [1, 1, 1], [1, 1, 0], [1, 1, 1]], bool)
    assert matched_counts(ids, mask, 10) == [0, 2, 1, 3]
    # Three slots: 2 finds none free, so it never matches.
    assert matched_counts(ids, mask, 3) == [0, 2, 1, 2]


def metric(name):
    return run.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py")


def test_k3_counts_by_hand():
    k3 = metric("k3_roofline")
    P, K = 2 ** 17, 15
    # A call with 3 matched: the pose and covariance read and written
    # (2 x 9 floats), 3 x 5 gathered floats read, a particle; z and the
    # flags once.
    one = 131072 * 4 * (18 + 15) + 15 * 8 + 15
    assert one == 17_301_639
    assert k3.k3_bytes(P, K, 1, 3) == one
    # 20 calls, 60 matched in all: the same.
    assert k3.k3_bytes(P, K, 20, 60) == 20 * one
    assert k3.FLOPS_PER_MATCH == 169
    assert k3.k3_flops(P, 60) == 169 * 131072 * 60
    # The bytes bound: 5.16 us a call, over the operations' 0.99 us.
    bound = k3.k3_bound_s(P, K, 20, 60, H100)
    assert bound == pytest.approx(20 * one / 3.35e12)
    assert round(bound / 20 * 1e6, 2) == 5.16
    assert round(169 * 131072 * 3 / 67e12 * 1e6, 2) == 0.99
    assert k3.k3_bound_s(P, K, 20, 60, "cpu") is None


def test_k3_roofline_arithmetic():
    k3 = metric("k3_roofline")
    bound = k3.k3_bound_s(2 ** 17, 15, 20, 60, H100)
    name = f"void (anonymous namespace)::{k3.NAME}(float const*)"
    ctx = {"trace": {"ops": {name: (2 * bound, 20)}},
           "units": [{"ticks": 800},
                     {"window_supersteps": 20, "window_matched": 60}],
           "device_kind": H100, "shapes": {"P": 2 ** 17, "K": 15}}
    assert k3.read(ctx) == pytest.approx(50.0)
    # Other calls of the kernel in the sub-window: no reading.
    assert k3.read(dict(ctx, trace={"ops": {name: (1.0, 21)}})) is None
    assert k3.read(dict(ctx, units=[{"ticks": 800}])) is None
    assert k3.read(dict(ctx, trace=None)) is None
    assert k3.read(dict(ctx, device_kind="cpu")) is None


MS = 1_000_000
# One superstep of 10 ms: 8 predicts of 0.5 ms, each with a heading
# update of 0.25 ms; an update of 5 ms with its associate (0.5 ms),
# propose (1 ms), map (1 ms) and resample (0.5 ms), and a gate read
# (0.5 ms, left out); the simulator's 1 ms.
STORE = [("sim.control", 1, 0, 0, MS)]
for t in range(8):
    t0 = MS + t * MS // 2
    STORE += [("fs2.heading", 30 + t, 2 + t, t0, t0 + MS // 4),
              ("filter.predict", 2 + t, 0, t0, t0 + MS // 2)]
STORE += [("fs2.associate", 20, 19, 5 * MS, 5 * MS + MS // 2),
          ("fs2.propose", 21, 19, 5 * MS + MS // 2, 6 * MS + MS // 2),
          ("fs2.map", 22, 19, 6 * MS + MS // 2, 7 * MS + MS // 2),
          ("filter.host_read", 23, 19, 7 * MS + MS // 2, 8 * MS),
          ("filter.resample", 24, 19, 8 * MS, 8 * MS + MS // 2),
          ("filter.update", 19, 0, 5 * MS, 10 * MS),
          ("superstep", 0, None, 0, 10 * MS)]


def test_host_share_readers_on_a_hand_built_store(monkeypatch):
    from slam_tpu_torch import spans
    readers = {n: metric(n).read for n in (
        "host_share.fs2_predict", "host_share.fs2_update",
        "host_share.fs2_propose")}
    monkeypatch.setattr(spans, "_records", [])
    assert all(read({}) is None for read in readers.values())
    monkeypatch.setattr(spans, "_records", list(STORE))
    assert readers["host_share.fs2_predict"]({}) == pytest.approx(40.0)
    assert readers["host_share.fs2_update"]({}) == pytest.approx(45.0)
    assert readers["host_share.fs2_propose"]({}) == pytest.approx(10.0)
    # A program without the fs2.* spans: their time in their parents,
    # the same two shares, and no proposal share.
    bare = [r for r in STORE if not r[0].startswith("fs2.")]
    monkeypatch.setattr(spans, "_records", bare)
    assert readers["host_share.fs2_predict"]({}) == pytest.approx(40.0)
    assert readers["host_share.fs2_update"]({}) == pytest.approx(45.0)
    assert readers["host_share.fs2_propose"]({}) is None
