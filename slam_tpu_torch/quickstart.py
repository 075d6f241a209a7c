"""Quickstart: run each estimator on a map, refine the FastSLAM 1 run's
keyframes with the pose-graph BA stage, and write DataGatherer-style
reports (counterpart: ``examples/quickstart.py``).

    python -m slam_tpu_torch.quickstart [map.mat] [-device cpu]

With no map, a synthetic one. The runs take place on the card; without
one the command raises, unless ``-device cpu`` asks for the CPU. The
reports go to ``quickstart_<method>/`` in the working directory.
"""

from __future__ import annotations

import argparse

import numpy as np

from slam_tpu_torch.config import SlamConfig
from slam_tpu_torch.device import default_device
from slam_tpu_torch.maps import read_map_file, synthetic_map
from slam_tpu_torch.posegraph import problem_from_run, solve_ba
from slam_tpu_torch.runtime import Runner, compute_metrics, write_report


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="python -m slam_tpu_torch.quickstart")
    parser.add_argument("map", nargs="?", help="a .mat map (its .ini beside)")
    parser.add_argument("-device", default=None,
                        help="cuda | cuda:N | cpu (default: the card)")
    args = parser.parse_args(argv)
    device = default_device(args.device)
    if args.map:
        slam_map = read_map_file(args.map)
        cfg = SlamConfig.from_ini(args.map.rsplit(".", 1)[0] + ".ini")
    else:
        slam_map = synthetic_map(40, 20, radius=60.0)
        cfg = SlamConfig(V=2.0, WHEELBASE=2.0, MAX_RANGE=25.0)

    for method, n_particles in [("EKF1", None), ("FASTSLAM1", 100),
                                ("FASTSLAM2", 100)]:
        runner = Runner(cfg, slam_map, method, n_particles=n_particles,
                        device=device)
        result = runner.run(seed=7)
        m = compute_metrics(result)
        print(f"{method:10s} {m.summary()}")
        write_report(result, f"quickstart_{method.lower()}")

    # Offline trajectory refinement over the FastSLAM 1 run's keyframes.
    runner = Runner(cfg, slam_map, "FASTSLAM1", n_particles=100,
                    device=device)
    result = runner.run(seed=7)
    prob = problem_from_run(result, cfg, device=device)
    poses, _ = solve_ba(prob, iters=8)
    act = result.active
    before = np.linalg.norm(result.est_pose[act, :2]
                            - result.true_pose[act, :2], axis=1)
    after = np.linalg.norm(poses[:, :2].cpu().numpy()
                           - result.true_pose[act, :2], axis=1)
    print(f"BA refinement: RMSE {np.sqrt((before**2).mean()):.3f} m -> "
          f"{np.sqrt((after**2).mean()):.3f} m")


if __name__ == "__main__":
    main()
