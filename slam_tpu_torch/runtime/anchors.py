"""The JAX package's accuracy anchors, in one place: what the port's
ATEs and errors are held to, each with the command that measured it on
the JAX package (``slam_tpu``, on the CPU) and its per-seed values.

Two ways of averaging seeds live here, and they are not interchangeable:

- ``chip_smoke.py`` holds its slices to the *RMS* over seeds (the
  ``JAX_*_ATE_M`` constants measured for it);
- ``slam_tpu_torch.bench`` reports bench.py's line ``ate``, the
  *arithmetic mean* over seeds (bench.py:141, :234), and holds it to the
  ``*_MEAN_ATE_M`` constants: the mean of the same JAX runs, on the same
  world, ticks and seeds as the line.

A line passes when its value is below ``ATE_MARGIN`` times its anchor
(BA: within ``BA_ERR_MARGIN`` of it). Nothing here imports anything:
the values are plain numbers, read by ``chip_smoke.py`` and the bench.
"""

# RMS ATE in metres over seeds 3, 4, 5 of the JAX package's FastSLAM 1
# with 100 particles and 2000 ticks on data/dense200 (CPU), measured by:
#   JAX_PLATFORMS=cpu python -c "import numpy as np;
#     from slam_tpu.config import SlamConfig;
#     from slam_tpu.maps import read_map_file;
#     from slam_tpu.runtime import Runner, compute_metrics;
#     m = read_map_file('data/dense200.mat');
#     c = SlamConfig.from_ini('data/dense200.ini');
#     a = [compute_metrics(Runner(c, m, 'FASTSLAM1', n_particles=100)
#          .run(seed=s, n_ticks=2000)).ate_rmse for s in (3, 4, 5)];
#     print(a, np.sqrt(np.mean(np.square(a))))"
# -> [1.4713972806930542, 0.48239609599113464, 1.4304887056350708]
JAX_ANCHOR_ATE_M = 1.2171022811043042
# The same for config #5's world, the JAX package's eager FastSLAM 1 with
# 1024 particles and 256 ticks (CPU), measured by:
#   JAX_PLATFORMS=cpu python -c "import numpy as np;
#     from slam_tpu.runtime import Runner, compute_metrics;
#     from slam_tpu.runtime.config5 import config5_setup;
#     c, m = config5_setup(10_000, capacity=192, max_obs=96);
#     a = [compute_metrics(Runner(c, m, 'FASTSLAM1', n_particles=1024)
#          .run(seed=s, n_ticks=256)).ate_rmse for s in (3, 4, 5)];
#     print(a, np.sqrt(np.mean(np.square(a))))"
# -> [0.050281304866075516, 0.034129798412323, 0.05376854166388512]
JAX_CONFIG5_ATE_M = 0.04684765675876786
# The JAX package's FastSLAM 2 with 100 particles and 2000 ticks on
# data/dense200 (heading known, as its ini says), seeds 3, 4, 5 (CPU):
# the first command with 'FASTSLAM1' replaced by 'FASTSLAM2'
# -> [0.12876757979393005, 0.18276497721672058, 0.1363617181777954]
JAX_FS2_ANCHOR_ATE_M = 0.15119374401455354
# The same on the world of the JAX package's fastslam2_1m bench line
# (bench.py:load_workload without the reference data), FastSLAM 2 with
# 1024 particles and 1024 ticks (CPU: the per-tick predict), measured by:
#   JAX_PLATFORMS=cpu python -c "import numpy as np;
#     from slam_tpu.config import SlamConfig;
#     from slam_tpu.maps import synthetic_map;
#     from slam_tpu.runtime import Runner, compute_metrics;
#     m = synthetic_map(35, 17, radius=100.0);
#     c = SlamConfig(SWITCH_HEADING_KNOWN=0);
#     a = [compute_metrics(Runner(c, m, 'FASTSLAM2', n_particles=1024)
#          .run(seed=s, n_ticks=1024)).ate_rmse for s in (3, 4, 5)];
#     print(a, np.sqrt(np.mean(np.square(a))))"
# -> [0.5435689687728882, 0.4998002350330353, 0.2992551028728485]
JAX_FS2_WEBMAP_ATE_M = 0.46000765042454733
# The JAX package's EKF1 (the dense EkfSlam, its Runner's default
# method), 2000 ticks, on the world of its ekf1_webmap bench line
# (bench.py:475, with load_workload's fallback world), seeds 3-8 as that
# line runs them (CPU), measured by:
#   JAX_PLATFORMS=cpu python -c "import numpy as np;
#     from slam_tpu.config import SlamConfig;
#     from slam_tpu.maps import synthetic_map;
#     from slam_tpu.runtime import Runner, compute_metrics;
#     m = synthetic_map(35, 17, radius=100.0);
#     c = SlamConfig(SWITCH_HEADING_KNOWN=0);
#     a = [compute_metrics(Runner(c, m, 'EKF1').run(seed=s, n_ticks=2000))
#          .ate_rmse for s in (3, 4, 5, 6, 7, 8)];
#     print(a, np.sqrt(np.mean(np.square(a))))"
# -> [1.925543189048767, 2.8779795169830322, 0.4271391034126282,
#     1.9853941202163696, 0.4592718183994293, 1.5500805377960205]
JAX_EKF_WEBMAP_ATE_M = 1.76674845295672
# EKF1 on data/dense200 (heading known), 2000 ticks, seeds 3, 4, 5
# (CPU): the first command with Runner(c, m, 'EKF1') and no particles
# -> [0.5465115308761597, 0.5760853886604309, 0.5243726372718811]
JAX_EKF_DENSE200_ATE_M = 0.5493984258951212
# The JAX package's ekf_10k line (bench.py:247-271): ShardedEkfSlam on a
# one-device mesh, config5_setup(10_000, capacity=10_000, max_obs=96),
# 640 ticks, seeds 3, 4, 5 (CPU), measured by:
#   JAX_PLATFORMS=cpu python -c "import numpy as np, jax;
#     from jax.sharding import Mesh;
#     from slam_tpu.parallel.ekf import ShardedEkfSlam;
#     from slam_tpu.runtime import Runner, compute_metrics;
#     from slam_tpu.runtime.config5 import config5_setup;
#     c, m = config5_setup(10_000, capacity=10_000, max_obs=96);
#     mesh = Mesh(np.array(jax.devices()[:1]), ('lm',));
#     a = [compute_metrics(Runner(c, m, 'EKF1', estimator=ShardedEkfSlam(
#          c, m.n_landmarks, mesh)).run(seed=s, n_ticks=640)).ate_rmse
#          for s in (3, 4, 5)];
#     print(a, np.sqrt(np.mean(np.square(a))))"
# (run on the 8 CPU cores of the H100's host machine, 450 s)
# -> [0.24316486716270447, 0.23860998451709747, 0.20781908929347992]
JAX_EKF_10K_ATE_M = 0.2304001238485464
# The JAX package's composed config #5 on the CPU, as bench_config5 runs
# it but at 1024 particles (bench.py:403-430): RMS over seeds 3, 4, 5 of
# run_config5(n_particles=1024, capacity=192, n_supersteps=32,
# seed=s).ate_refined (JAX_PLATFORMS=cpu, the 8 CPU cores of the H100's
# host machine; its ate_filter RMS: 0.045890827499616364)
# -> [0.021920856088399887, 0.10794076323509216, 0.050334397703409195]
JAX_CONFIG5_REFINED_ATE_M = 0.06991729373954994
# The JAX package's ba_10k line (bench.py:347-400) on the CPU: the mean
# position error of solve_ba_device(prob, iters=30) on
# make_ba_problem(256, 10_000), measured by:
#   JAX_PLATFORMS=cpu python -c "import numpy as np, jax.numpy as jnp;
#     from bench import make_ba_problem;
#     from slam_tpu.posegraph import solve_ba_device;
#     prob, poses, poses0, lms = make_ba_problem(256, 10_000);
#     p, _ = solve_ba_device(prob, iters=30);
#     print(float(jnp.linalg.norm(p[:, :2] - poses[:, :2], axis=1).mean()))"
# (the host machine's CPU; 35 trials, 18 accepted; dead-reckoned error
# 29.436847686767578 m, the MAP floor 1.8217651844024658 m)
JAX_BA10K_ERR_M = 1.7418155670166016
ATE_MARGIN = 2.0
BA_ERR_MARGIN = 0.05

# ---------------------------------------------------------------------------
# The bench lines' anchors (slam_tpu_torch.bench): arithmetic means over
# the line's seeds, as bench.py averages its ATE. "The fallback world" is
# bench.py:load_workload's without the reference data (bench.py:96-106):
# SlamConfig(SWITCH_HEADING_KNOWN=0) on synthetic_map(35, 17, radius=100).
# ---------------------------------------------------------------------------

# fastslam1_webmap: FastSLAM 1, 100 particles, 4000 ticks, seeds 3, 4, 5,
# on the fallback world (CPU), measured by:
#   JAX_PLATFORMS=cpu python -c "import numpy as np;
#     from slam_tpu.config import SlamConfig;
#     from slam_tpu.maps import synthetic_map;
#     from slam_tpu.runtime import Runner, compute_metrics;
#     m = synthetic_map(35, 17, radius=100.0);
#     c = SlamConfig(SWITCH_HEADING_KNOWN=0);
#     a = [compute_metrics(Runner(c, m, 'FASTSLAM1', n_particles=100)
#          .run(seed=s, n_ticks=4000)).ate_rmse for s in (3, 4, 5)];
#     print(a, np.mean(a))"
# -> [1.9334372282028198, 2.672147512435913, 6.539767265319824]
JAX_FS1_WEBMAP_MEAN_ATE_M = 3.715117335319519
# ekf1_webmap: the mean of JAX_EKF_WEBMAP_ATE_M's six per-seed values
# (seeds 3-8, 2000 ticks, the fallback world).
JAX_EKF_WEBMAP_MEAN_ATE_M = 1.5375680476427078
# fastslam2_webmap: the fastslam1_webmap command with 'FASTSLAM2' and
# n_ticks=2000
# -> [2.039633274078369, 1.4723970890045166, 0.8519198894500732]
JAX_FS2_WEBMAP_MEAN_ATE_M = 1.454650084177653
# fastslam2_ring40_1024 (bench.py's fastslam2_loop2_1024 line on
# data/ring40): FastSLAM 2, 1024 particles, 2000 ticks, seeds 3, 4, 5
# (CPU), measured by:
#   JAX_PLATFORMS=cpu python -c "import numpy as np;
#     from slam_tpu.config import SlamConfig;
#     from slam_tpu.maps import read_map_file;
#     from slam_tpu.runtime import Runner, compute_metrics;
#     m = read_map_file('data/ring40.mat');
#     c = SlamConfig.from_ini('data/ring40.ini');
#     a = [compute_metrics(Runner(c, m, 'FASTSLAM2', n_particles=1024)
#          .run(seed=s, n_ticks=2000)).ate_rmse for s in (3, 4, 5)];
#     print(a, np.mean(a))"
# -> [0.09454283863306046, 0.23719258606433868, 0.13303862512111664]
JAX_FS2_RING40_MEAN_ATE_M = 0.1549246832728386
# ekf_10k: one seed, 3, as bench.py runs it: JAX_EKF_10K_ATE_M's
# seed-3 value.
JAX_EKF_10K_SEED3_ATE_M = 0.24316486716270447
# fastslam1_dense200_131072 (bench.py's fastslam1_loop902_131072 line on
# data/dense200): FastSLAM 1, 2^17 particles, 800 ticks, seeds 3, 4, 5,
# measured by (on the 8 CPU cores of the H100's host machine, jax 0.9.0,
# 165 s; on the CPU the JAX package runs the eager FastSlam1, the
# deferred one being its TPU path):
#   JAX_PLATFORMS=cpu python -c "import numpy as np;
#     from slam_tpu.config import SlamConfig;
#     from slam_tpu.maps import read_map_file;
#     from slam_tpu.runtime import Runner, compute_metrics;
#     m = read_map_file('data/dense200.mat');
#     c = SlamConfig.from_ini('data/dense200.ini');
#     a = [compute_metrics(Runner(c, m, 'FASTSLAM1', n_particles=2 ** 17)
#          .run(seed=s, n_ticks=800)).ate_rmse for s in (3, 4, 5)];
#     print(a, np.mean(a))"
# -> [0.37646546959877014, 0.4233950972557068, 0.31103119254112244]
JAX_FS1_DENSE200_131072_MEAN_ATE_M = 0.37029725313186646
# fastslam2_webmap_131072: FastSLAM 2, 2^17 particles, 800 ticks, seeds
# 3, 4, 5, on the fallback world (the same machine, 107 s): the
# fastslam1_webmap command with 'FASTSLAM2', n_particles=2 ** 17 and
# n_ticks=800
# -> [0.4251772165298462, 0.4970102310180664, 0.31211453676223755]
JAX_FS2_WEBMAP_131072_MEAN_ATE_M = 0.41143399477005005
