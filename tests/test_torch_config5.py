"""BASELINE config #5 composed (``run_config5``): the filter on config
#5's 10k-landmark world, ``problem_from_run``, and the landmark-sharded
Schur BA, on the CPU at small particle counts.

What tests/test_config5.py checks of the JAX package's pipeline (its
tests are marked slow there) is checked here of the port's: on one
device, on both filter arms (``FastSlam1Deferred`` at P = 512 and
``FastSlam1`` at P = 64); and on 4 gloo ranks
(``torch_parallel_workers.config5_world``): the (2, 2) mesh, every rank
with the same result; JAX's filter choice at (1, 1) inside a group
(``FastSlam1Deferred`` at P = 512, ``LandmarkShardedFastSlam1`` at
P = 64); the composed problem (L = 9,981, no multiple of 4) solved by
``solve_ba_sharded`` on 4 ranks against ``solve_ba`` (tests/
test_config5.py:test_config5_sharded_ba_matches_single_chip's
tolerances). The result record has the JAX package's fields; the device
rules and the refusals are covered too.
"""

import math

import numpy as np
import pytest
import torch

from slam_tpu.runtime import config5 as jconfig5
from slam_tpu_torch.models import fastslam1 as tfs1
from slam_tpu_torch.runtime import config5 as tconfig5

import torch_parallel_workers as tw

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
    (dict(rng_impl="rbg"), "North star"),
])
def test_refuses_what_is_not_ported(kw, match):
    with pytest.raises(NotImplementedError, match=match):
        tconfig5.run_config5(n_particles=64, n_supersteps=1, device="cpu",
                             **kw)


@pytest.mark.parametrize("shape", [(2, 1), (1, 4)])
def test_a_mesh_needs_a_process_group(shape):
    with pytest.raises(ValueError, match="init_distributed"):
        tconfig5.run_config5(n_particles=64, mesh_shape=shape,
                             n_supersteps=1, device="cpu")


# tests/test_config5.py's pipeline test, cut to 8 supersteps and 4 BA
# iterations as the one-device test above.
MESH_RUN = dict(n_particles=64, capacity=256, n_supersteps=8, ba_iters=4)
CHOICES = {64: "LandmarkShardedFastSlam1", 512: "FastSlam1Deferred"}
MESH_BA = dict(P=64, capacity=256, supersteps=8, iters=6, damping=1e-4)


@pytest.fixture(scope="module")
def config5_world():
    return tw.run_world(tw.config5_world, 4, run=MESH_RUN,
                        choices=list(CHOICES), ba=MESH_BA)


def test_pipeline_composes_on_a_2x2_mesh(config5_world):
    """tests/test_config5.py's checks on (2, 2); every rank returns the
    same result."""
    r = tconfig5.Config5Result(**config5_world[0]["run"])
    assert r.n_keyframes == 8
    assert r.n_landmarks_map == 10_000
    assert r.n_landmarks_observed > 0
    for v in (r.ate_filter, r.ate_refined, r.steps_per_second,
              r.ba_seconds):
        assert math.isfinite(v)
    assert r.ate_refined < max(2.0 * r.ate_filter, 0.15), r
    assert r.ba_iters >= 1
    assert r.particle_steps_per_second == r.steps_per_second * 64
    for world in config5_world[1:]:
        assert world["run"] == config5_world[0]["run"]


@pytest.mark.parametrize("P", list(CHOICES))
def test_filter_choice_in_a_group_follows_jax(config5_world, P):
    """At (1, 1) inside a group: FastSlam1Deferred iff P % 512 == 0, else
    LandmarkShardedFastSlam1 on the (1, 1) mesh (JAX's mesh path); the
    ranks outside the mesh build nothing and return None."""
    i = list(CHOICES).index(P)
    got = config5_world[0]["choices"][i]
    assert got["built"] == [CHOICES[P]]
    assert got["result"]["n_keyframes"] == 2
    for world in config5_world[1:]:
        assert world["choices"][i] == dict(built=[], result=None)


def test_composed_problem_solves_sharded_as_on_one_device(config5_world):
    """solve_ba_sharded on 4 ranks against solve_ba, poses atol 5e-3,
    landmarks 5e-2 (tests/test_config5.py), on a problem whose L is no
    multiple of 4; every rank the same."""
    ba = config5_world[0]["ba"]
    assert ba["L"] % 4 != 0
    assert ba["landmarks"].shape == ba["landmarks0_shape"]
    np.testing.assert_allclose(ba["poses"], ba["poses_1"], atol=5e-3)
    np.testing.assert_allclose(ba["landmarks"], ba["landmarks_1"],
                               atol=5e-2)
    for world in config5_world[1:]:
        np.testing.assert_array_equal(world["ba"]["poses"], ba["poses"])
        np.testing.assert_array_equal(world["ba"]["landmarks"],
                                      ba["landmarks"])


def test_refuses_the_default_device_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=NO_CARD):
        tconfig5.run_config5(n_particles=64, n_supersteps=1)
