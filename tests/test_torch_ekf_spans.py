"""The landmark-block EKF's spans and its count of passes over Pmm
(``slam_tpu_torch.parallel.ekf``), on the CPU.

Under a profiler each update records ``ekf.associate``, ``ekf.gain``,
``ekf.pmm`` and ``ekf.augment`` once, in that order, beneath the
runner's ``filter.update``; with the profiler off nothing is recorded.
``pmm_passes.count`` counts one pass an update, and one more for each
heading term that finds no free column in ``hk`` (fewer columns than
ticks a superstep: the fold-now arm). A run records the same states bit
for bit with the profiler on and off.
"""

import collections

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from slam_tpu_torch import spans
from slam_tpu_torch.config import SlamConfig
from slam_tpu_torch.maps import SlamMap, synthetic_map
from slam_tpu_torch.parallel import ekf as pk
from slam_tpu_torch.runtime.loop import Runner

N_STEPS = 6
EKF_SPANS = ("ekf.associate", "ekf.gain", "ekf.pmm", "ekf.augment")


@pytest.fixture(autouse=True)
def empty_store():
    spans.clear()
    yield
    spans.clear()


def runner(n_defer=16):
    """``ShardedEkfSlam`` (no mesh) on a 60-landmark world with
    landmarks in view from the first tick, heading known, association
    unknown; its state made with ``n_defer`` columns for heading
    terms."""
    m = synthetic_map(60, n_waypoints=12, radius=25.0, seed=7)
    shift = m.waypoints[0].copy()
    slam_map = SlamMap(landmarks=m.landmarks - shift,
                       waypoints=m.waypoints - shift)
    cfg = SlamConfig(MAX_RANGE=30.0, SWITCH_HEADING_KNOWN=1,
                     SWITCH_ASSOCIATION_KNOWN=0, max_landmarks=32,
                     max_observations=10)
    est = pk.ShardedEkfSlam(cfg, slam_map.n_landmarks, device="cpu")
    est.init = lambda n_particles=None: pk.sharded_ekf_init(
        est.capacity, slam_map.n_landmarks, n_defer=n_defer, device="cpu")
    return Runner(cfg, slam_map, "EKF1", estimator=est)


def run(r):
    return r.run(seed=4, n_ticks=N_STEPS * r.config.steps_per_observe)


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_update_spans_sit_beneath_filter_update():
    r = runner()
    run(r)
    with cpu_profile():
        run(r)
    recs = spans.records()
    by_id = {rec[1]: rec for rec in recs}
    counts = collections.Counter(rec[0] for rec in recs)
    assert counts["filter.update"] == N_STEPS
    for name in EKF_SPANS:
        assert counts[name] == N_STEPS, name
    for rec in recs:
        if rec[0] in EKF_SPANS:
            assert by_id[rec[2]][0] == "filter.update", rec
    # In order, one after another, inside each update.
    for upd in (rec for rec in recs if rec[0] == "filter.update"):
        kids = sorted((rec for rec in recs if rec[2] == upd[1]),
                      key=lambda rec: rec[3])
        assert tuple(k[0] for k in kids) == EKF_SPANS
        assert all(a[4] <= b[3] for a, b in zip(kids, kids[1:]))
        assert upd[3] <= kids[0][3] and kids[-1][4] <= upd[4]


@pytest.mark.parametrize("n_defer,spills", [(16, 0), (3, 5)])
def test_pmm_passes_count_updates_and_spills(n_defer, spills):
    """Eight ticks a superstep: with 16 columns every heading term
    waits in ``hk``; with 3, five a superstep spill into Pmm at once."""
    r = runner(n_defer)
    before = pk.pmm_passes.count
    run(r)
    assert pk.pmm_passes.count - before == N_STEPS * (1 + spills)


def test_profiler_off_records_nothing_and_states_are_equal():
    r = runner(3)
    off = run(r)
    assert spans.records() == []
    with cpu_profile():
        on = run(r)
    assert collections.Counter(rec[0] for rec in spans.records())[
        "ekf.pmm"] == N_STEPS
    for f in pk.SHARDED_FIELDS:
        a, b = getattr(off.final_state, f), getattr(on.final_state, f)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f
        else:
            assert a == b, f
    assert (off.est_pose == on.est_pose).all()
