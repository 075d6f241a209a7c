"""A run whose timed path is broken underneath comes out not correct:
the harness's whole run on the CPU (its look for a card skipped) with a
fault planted in the program, once for each fault a cell can have: a
step that returns its state unchanged, half of the batch left out with
the mean taken over the rest, an answer altered where it is produced.
(No cell runs on several chips, so none has an exchange to leave out.)"""

import dataclasses

import pytest
import torch

FILTERS = ("webmap-fs1-p100.loop", "config5-1m.dense", "config5-1m.blind")


def _filters():
    from slam_tpu_torch.models import FastSlam1, FastSlam1Deferred
    return FastSlam1, FastSlam1Deferred


def update_unchanged(mp):
    for cls in _filters():
        mp.setattr(cls, "update", lambda self, state, *a: state)


def predict_unchanged(mp):
    FastSlam1, Deferred = _filters()
    mp.setattr(FastSlam1, "predict", lambda self, state, *a: state)
    mp.setattr(Deferred, "predict", lambda self, state, *a: state)
    mp.setattr(Deferred, "_predict_multi", lambda self, state, *a: state)
    mp.setattr(Deferred, "__init__", _deferred_init(Deferred))


def _deferred_init(Deferred):
    init = Deferred.__init__

    def patched(self, *a, **kw):
        init(self, *a, **kw)
        self.predict_multi = self._predict_multi
    return patched


def pose_over_half(mp):
    from slam_tpu_torch.models import particles

    def half_pose(self, state):
        ps = getattr(state, "ps", state)
        h = ps.n_particles // 2
        return particles.estimate_position(
            ps._replace(logw=ps.logw[:h], xv=ps.xv[:, :h]),
            self.config.POSE_ESTIMATE)
    for cls in _filters():
        mp.setattr(cls, "pose", half_pose)


def pose_altered(mp):
    for cls in _filters():
        base = cls.pose
        mp.setattr(cls, "pose", lambda self, state, base=base:
                   base(self, state) + 0.05)


FILTER_FAULTS = {"update_unchanged": update_unchanged,
                 "predict_unchanged": predict_unchanged,
                 "pose_over_half": pose_over_half,
                 "pose_altered": pose_altered}


@pytest.mark.parametrize("fault", sorted(FILTER_FAULTS))
@pytest.mark.parametrize("cell", FILTERS)
def test_filter_fault_is_not_correct(run_cell, monkeypatch, cell, fault):
    if fault == "update_unchanged" and cell.endswith("blind"):
        pytest.skip("the blind cell observes nothing: its update is the "
                    "gate alone, and the predict fault covers its step")
    FILTER_FAULTS[fault](monkeypatch)
    rc, result, err = run_cell(cell)
    assert rc == 0, err[-3000:]
    assert not result["correct"], result["compared"]


def _solve_wrapped(mp, wrap):
    from slam_tpu_torch import posegraph
    from slam_tpu_torch.runtime import config5
    base = posegraph.solve_ba_sharded

    def solve(prob, mesh=None, **kw):
        return wrap(base, prob, mesh, **kw)
    mp.setattr(posegraph, "solve_ba_sharded", solve)
    mp.setattr(config5, "solve_ba_sharded", solve)


def ba_unchanged(mp):
    def wrap(base, prob, mesh, **kw):
        poses, lms, *info = base(prob, mesh, **dict(kw, iters=0))
        return (poses, lms, *info)
    _solve_wrapped(mp, wrap)


def ba_half_batch(mp):
    def wrap(base, prob, mesh, **kw):
        mask = prob.mask.clone()
        mask[:, : mask.shape[1] // 2] = False
        return base(dataclasses.replace(prob, mask=mask), mesh, **kw)
    _solve_wrapped(mp, wrap)


def ba_altered(mp):
    def wrap(base, prob, mesh, **kw):
        poses, lms, *info = base(prob, mesh, **kw)
        return (poses + torch.tensor([0.05, 0.0, 0.0]), lms, *info)
    _solve_wrapped(mp, wrap)


BA_FAULTS = {"ba_unchanged": ba_unchanged, "ba_half_batch": ba_half_batch,
             "ba_altered": ba_altered}


@pytest.mark.parametrize("fault", sorted(BA_FAULTS))
@pytest.mark.parametrize("cell", ["config5-1m.ba10k", "config5-1m.dense"])
def test_ba_fault_is_not_correct(run_cell, monkeypatch, cell, fault):
    BA_FAULTS[fault](monkeypatch)
    rc, result, err = run_cell(cell)
    assert rc == 0, err[-3000:]
    assert not result["correct"], result["compared"]
