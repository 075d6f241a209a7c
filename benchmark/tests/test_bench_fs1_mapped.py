"""The FastSLAM 1 cell at full per-particle capacity,
``config5-full10k.mapped``, on the CPU: the harness's whole run
(``benchmark.run.main`` with a device named) at a test's size, correct,
with its metrics; the control (the reference in bfloat16 in the
program's place) failing; four faults planted in the program failing
the check. K5's live-row bytes by hand, and the readers' arithmetic."""

import json

import pytest
from conftest import ROOT

from benchmark import run

CELL = "config5-full10k.mapped"
H100 = "NVIDIA H100 80GB HBM3"


def tiny_full(config: dict, workload: dict) -> None:
    """The cell cut to a CPU test's size: 1,024 particles, a 304-landmark
    world on config #5's loop at a 60 m radius with a slot for each (the
    96 observation slots kept), a start mapped by 40 supersteps, runs of
    8 supersteps, two of them copied, a 2-superstep sub-window."""
    config["n_particles"] = 1024
    config["world"].update(n_landmarks=304, radius=60.0)
    config["slam"]["max_landmarks"] = 304
    t = workload["traffic"]
    t["start_supersteps"] = 40
    t["supersteps_per_run"] = 8
    t["capture"] = {"runs": 2, "within": 2, "per_run": 2}
    t["trace"] = [0, 2, 2]
    workload["shapes"].update(P=1024, L=304)


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_end_to_end_on_the_cpu(run_cell, trace):
    rc, result, err = run_cell(CELL, trace=trace, adjust=tiny_full)
    assert rc == 0, err[-3000:]
    assert result["correct"], result["compared"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    want = {m["name"] for m in run.metrics_of(CELL, bool(trace))}
    if trace:
        want.discard("k5_live_roofline")        # device traces only
        value = result["metrics"]["host_share.fs1_update"]["value"]
        assert 0 < value < 100
    assert set(result["metrics"]) == want
    assert "ate_m" in err and "info fired" in err
    line = next(ln for ln in err.splitlines()
                if ln.startswith("benchmark: ") and "{" in ln)
    info = json.loads(line[line.index("{"):])
    assert 0 < info["start_n"] <= min(info["n_live"])


def test_control_fails(run_cell):
    rc, result, err = run_cell(CELL, control=True, adjust=tiny_full)
    assert rc == 0, err[-3000:]
    assert result["correct"], result["compared"]
    assert not result["control_correct"], result["control"]
    for name in ("weight_gap", "lm_gap", "lmcov_gap", "pose_gap_m"):
        c = result["control"][name]
        assert c["value"] > c["limit"], (name, c)


def _gather_dropped(mp):
    """The pending resample's fused gather dropped: K4 in place of K5 on
    a pending S."""
    from slam_tpu_torch.models import fastslam1
    inner = fastslam1.fs1_observe

    def dropped(state, *args, S=None):
        return inner(state, *args)
    mp.setattr(fastslam1, "fs1_observe", dropped)


def _new_features_dropped(mp):
    from slam_tpu_torch.models import rbpf
    inner = rbpf.new_slots

    def none(state, is_new):
        slot_new, ok = inner(state, is_new)
        return slot_new, ok & False
    mp.setattr(rbpf, "new_slots", none)


def _likelihood_dropped(mp):
    """The update's weight term left out of the weights."""
    from slam_tpu_torch.models import fastslam1
    inner = fastslam1.landmark_update

    def dropped(xv, logw, *args, **kw):
        return inner(xv, logw.clone(), *args, **kw)
    mp.setattr(fastslam1, "landmark_update", dropped)


def _poses_not_resampled(mp):
    """A fired resample's pose rows left in place."""
    from slam_tpu_torch.models import fastslam1
    mp.setattr(fastslam1, "bounds_gather_multi",
               lambda rows, S: [r.clone() for r in rows])


@pytest.mark.parametrize("fault", [_gather_dropped, _new_features_dropped,
                                   _likelihood_dropped,
                                   _poses_not_resampled])
def test_a_fault_in_the_program_is_not_correct(run_cell, monkeypatch,
                                               fault):
    fault(monkeypatch)
    rc, result, err = run_cell(CELL, adjust=tiny_full)
    assert rc == 0, err[-3000:]
    assert not result["correct"], result["compared"]
    c = result["compared"]
    if fault is _gather_dropped:
        assert (c["exact_miss"]["value"] > 0
                or c["weight_gap"]["value"] > c["weight_gap"]["limit"]), c
    if fault is _likelihood_dropped:
        assert c["weight_gap"]["value"] > c["weight_gap"]["limit"], c


def metric(name):
    return run.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py")


def test_k5_live_bytes_by_hand():
    live = metric("k5_live_roofline")
    P, n, K = 32_768, 1_450, 96
    rows = 5 * 1_450 * 32_768 * 4              # the live rows written
    assert rows == 950_272_000
    weights = 32_768 * 4                       # logw, written in place
    reads = (3 + 1 + 1) * 32_768 * 4 + 96 * 8 + 96 * 10
    assert live.K5.k5_bytes(P, n, K) == rows + weights + reads
    # At 3.35 TB/s: 0.284 ms, against K5's 6.595 ms a call at L = 10,000
    # in the kernel table (4.3 %).
    assert round(live.K5.k5_bytes(P, n, K) / 3.35e12 * 1e3, 3) == 0.284


def test_k5_live_roofline_arithmetic():
    live = metric("k5_live_roofline")
    P, n, K = 32_768, 1_450, 96
    seconds = live.K5.k5_bytes(P, n, K) / 3.35e12 * 4     # a quarter
    name = f"void {live.NAME}<4>(float const*)"
    ctx = {"trace": {"ops": {name: (seconds * 20, 20)}},
           "units": [{"ticks": 640}, {"ticks": 640, "live_rows": n}],
           "device_kind": H100, "shapes": {"P": P, "L": 10_000, "K": K}}
    assert live.read(ctx) == pytest.approx(25.0)
    assert live.read(dict(ctx, units=[{"ticks": 640}])) is None
    assert live.read(dict(ctx, trace={"ops": {}})) is None
    assert live.read(dict(ctx, trace=None)) is None
    assert live.read(dict(ctx, device_kind="cpu")) is None


MS = 1_000_000
# One superstep of 10 ms: the predict 1 ms; an update of 6 ms with a
# gate read (1 ms, left out) and a resample (0.5 ms); the simulator's
# 1 ms.
STORE = [("sim.control", 1, 0, 0, MS),
         ("filter.predict", 2, 0, MS, 2 * MS),
         ("filter.host_read", 6, 3, 5 * MS + MS // 2, 6 * MS + MS // 2),
         ("filter.resample", 7, 3, 6 * MS + MS // 2, 7 * MS),
         ("filter.update", 3, 0, 3 * MS, 9 * MS),
         ("superstep", 0, None, 0, 10 * MS)]


def test_host_share_reader_on_a_hand_built_store(monkeypatch):
    from slam_tpu_torch import spans
    read = metric("host_share.fs1_update").read
    monkeypatch.setattr(spans, "_records", [])
    assert read({}) is None
    monkeypatch.setattr(spans, "_records", list(STORE))
    assert read({}) == pytest.approx(50.0)
