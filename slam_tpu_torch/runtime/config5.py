"""BASELINE config #5, the filter stage (counterpart:
slam_tpu.runtime.config5).

``config5_setup`` builds the scaling workload's world and config: 10k
landmarks around a loop corridor, a 30 m sensor range, so about 70
landmarks are visible per observation and the per-particle map stays
bounded. On one device the JAX package runs its filter as
``FastSlam1Deferred`` at 2^20 particles with capacity 192:

    cfg, m = config5_setup(10_000, capacity=192, max_obs=96)
    est = FastSlam1Deferred(cfg, m.n_landmarks, device="cuda")
    Runner(cfg, m, "FASTSLAM1", n_particles=2 ** 20,
           estimator=est).run(seed=3, n_ticks=256)

``run_config5``, which feeds the run to bundle adjustment, waits for
the BA port (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

from slam_tpu_torch.config import SlamConfig
from slam_tpu_torch.maps import SlamMap, synthetic_map


def config5_setup(n_landmarks: int = 10_000, capacity: int = 256,
                  max_obs: int = 96, seed: int = 5):
    """(config, map) of the scaling workload, as the JAX package builds
    them: the synthetic loop shifted so that waypoint 0, where the
    vehicle starts, is the origin and landmarks are in range from tick
    0."""
    slam_map = synthetic_map(n_landmarks, n_waypoints=17, radius=200.0,
                             seed=seed)
    shift = slam_map.waypoints[0].copy()
    slam_map = SlamMap(landmarks=slam_map.landmarks - shift,
                       waypoints=slam_map.waypoints - shift)
    cfg = SlamConfig(V=3.0, WHEELBASE=4.0, MAX_RANGE=30.0,
                     SWITCH_HEADING_KNOWN=1,
                     max_landmarks=capacity,
                     max_observations=max_obs)
    return cfg, slam_map
