"""BASELINE config #5 composed on one device (``run_config5``): the filter
on config #5's 10k-landmark world, ``problem_from_run``, and the
landmark-sharded Schur BA, on the CPU at small particle counts.

What tests/test_config5.py checks of the JAX package's pipeline (its
tests are marked slow there) is checked here of the port's, on both
filter arms: ``FastSlam1Deferred`` at P = 512 and ``FastSlam1`` at
P = 64. The result record has the JAX package's fields; the device
rules and the refusals of what is not ported are covered too.
"""

import math

import pytest
import torch

from slam_tpu.runtime import config5 as jconfig5
from slam_tpu_torch.models import fastslam1 as tfs1
from slam_tpu_torch.runtime import config5 as tconfig5

NO_CARD = "torch.cuda.is_available\\(\\) is False"


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_result_has_the_jax_fields():
    assert tconfig5.Config5Result._fields == jconfig5.Config5Result._fields


@pytest.mark.parametrize("P,estimator", [
    (512, tfs1.FastSlam1Deferred), (64, tfs1.FastSlam1)],
    ids=["deferred", "eager"])
def test_pipeline_composes_on_cpu(monkeypatch, P, estimator):
    """8 supersteps and 4 BA iterations: tests/test_config5.py's checks
    (keyframes, map size, finite errors, the refinement within
    max(2 ATE_filter, 0.15), at least one BA iteration), with the filter
    the JAX package picks on one chip for that particle count."""
    built = []
    for name in ("FastSlam1", "FastSlam1Deferred"):
        cls = getattr(tconfig5, name)

        class Spy(cls):
            def __init__(self, *args, _cls=cls, **kw):
                built.append(_cls)
                super().__init__(*args, **kw)
        monkeypatch.setattr(tconfig5, name, Spy)
    r = tconfig5.run_config5(n_particles=P, n_supersteps=8, ba_iters=4,
                             device="cpu")
    assert built == [estimator]
    assert r.n_keyframes == 8
    assert r.n_landmarks_map == 10_000
    assert r.n_landmarks_observed > 0
    for v in (r.ate_filter, r.ate_refined, r.steps_per_second,
              r.ba_seconds):
        assert math.isfinite(v)
    assert r.ate_refined < max(2.0 * r.ate_filter, 0.15), r
    assert r.ba_iters >= 1
    assert r.particle_steps_per_second == r.steps_per_second * P


@pytest.mark.parametrize("kw,match", [
    (dict(mesh_shape=(2, 1)), "Queue 1, item 5"),
    (dict(mesh_shape=(1, 4)), "Queue 1, item 5"),
    (dict(rng_impl="rbg"), "North star"),
])
def test_refuses_what_is_not_ported(kw, match):
    with pytest.raises(NotImplementedError, match=match):
        tconfig5.run_config5(n_particles=64, n_supersteps=1, device="cpu",
                             **kw)


def test_refuses_the_default_device_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=NO_CARD):
        tconfig5.run_config5(n_particles=64, n_supersteps=1)
