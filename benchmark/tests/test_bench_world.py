"""The benchmark's frozen traffic generators equal the program's today,
at small sizes."""

import numpy as np
import pytest
import torch

from benchmark import world


@pytest.mark.parametrize("args", [(35, 17, 100.0, 0), (500, 9, 50.0, 3)])
def test_synthetic_map_equals_the_programs(args):
    from slam_tpu_torch.maps import synthetic_map
    lms, wps = world.synthetic_map(*args)
    m = synthetic_map(*args)
    np.testing.assert_array_equal(lms, m.landmarks)
    np.testing.assert_array_equal(wps, m.waypoints)


def test_waypoint0_world_equals_config5_setup():
    from slam_tpu_torch.runtime.config5 import config5_setup
    _, m = config5_setup(2000)
    lms, wps = world.make_world(dict(n_landmarks=2000, n_waypoints=17,
                                     radius=200.0, seed=5,
                                     origin="waypoint0"))
    np.testing.assert_array_equal(lms, m.landmarks)
    np.testing.assert_array_equal(wps, m.waypoints)


@pytest.mark.parametrize("seed", [0, 7])
def test_make_ba_problem_equals_the_programs(seed):
    from slam_tpu_torch.posegraph.synthetic import make_ba_problem
    prob, poses, poses0, lms = make_ba_problem(24, 300, K=10, seed=seed,
                                               device="cpu")
    mine = world.make_ba_problem(24, 300, K=10, seed=seed)
    for k in ("poses0", "landmarks0", "odom", "odom_info", "z", "lm_idx",
              "mask", "R"):
        ref = getattr(prob, k)
        got = torch.as_tensor(mine[k]).to(ref.dtype)
        assert torch.equal(got, ref), k
    np.testing.assert_array_equal(mine["poses_true"], poses)
    np.testing.assert_array_equal(mine["lms_true"], lms)
