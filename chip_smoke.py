#!/usr/bin/env python3
"""Smoke test of slam_tpu_torch, the PyTorch / CUDA port, on one NVIDIA
GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. Device: a CUDA card is required; prints its name and power limit
   (nvidia-smi) and turns TF32 off.
2. Build: compiles the CUDA kernels from slam_tpu_torch/csrc.
3. Kernels against their plain PyTorch twins on the card, at the shapes
   the main paths give them: K2 (K=15, L=200, P=100, by slot; and on
   edge cases: P=2^17 + 37, one landmark observed twice, new slots past
   the capacity, no matched observation, K=160, whose threads take
   several k each), bit-equal to K4 on the same inputs wherever the
   matched slots are distinct, and timed beside K4 at P=100 and at the
   ragged P; K4 (K=15, L=200,
   P=2^17; and slice (f)'s K=9, L=40, P=2^20; at each shape its thread
   map and chunk as the library reports them, and the registers of the
   launched instantiation by nvcc -Xptxas -v), G1 (P=100) and G2
   (P=2^17; and P=2^20 at L=40), over the 10 + 5L rows of the resample
   gather; K4 and K5 at config #5's shapes (K=96, L=192, P=2^20; K5
   with a fired resample) and at the full-10k run's (K=96, L=10,000,
   P=32,768), and K5 on edge cases at P=2^16 (all columns from
   one ancestor; the identity but for one tile; a tile whose ancestor
   run is wider than the staging width; L=40; no matched observation;
   one landmark observed twice); K6 and K6b with the noise on and off
   at T=8, P=2^20, at a ragged P (2^20 + 37), at a T (5) that is no
   multiple of the tick loop's unrolling and at a T (300, P=4133) that
   takes more than one launch; K3 (K=15, P=2^20) with matched and unmatched
   slots; K1 (K=15, P=2^20). Gathers, K6 and K6b must be bit-equal to
   their twins (the predicts keep the twins' operation order, and the
   sweep below holds their sincosf and fast wrap to sinf, cosf and the
   fmodf wrap on every float32 bit pattern); the other float outputs
   within rtol 1e-5, atol 1e-5 (the kernels
   sum over k in another order than the twins, and the device libm
   rounds sin/cos/log differently from torch's), K3 within the JAX
   package's golden tolerances of the refinement (xv rtol 1e-4, atol
   1e-5; Pv rtol 1e-3, atol 1e-6), as its chain over K observations
   compounds rounding; headings (and K1's bearings) are compared
   wrapped, as one ulp at +-pi flips a wrapped value by 2 pi. K5 must
   also be bit-equal to G2's gather followed by K4 (the same operation
   order), and its two load branches (staged through shared memory, and
   direct) bit-equal to each other; for the landmark observed twice,
   where the twin computes both updates from the old values, only these
   two hold. Times each kernel and its twin with CUDA events (plain,
   kernel, kernel, plain), the kernel's device time with torch.profiler,
   and where one PyTorch call computes the same function (G1:
   index_select, G2: repeat_interleave) that call too; and computes each
   kernel's bound from the bytes and operations of these inputs. K6
   and K6b are bound by instruction issue, which that bound does not
   see: for them the SASS instructions of 8 ticks are counted
   with cuobjdump and set against the card's issue rate at the SM clock
   that nvidia-smi reports while they run (issue_bound_ms, issue_share).
4. FastSLAM 1 end to end through Runner + compute_metrics; the launch
   counters are reset before each run and read after it:
   (a) eager, data/dense200, P = 100, 2000 ticks, seeds 3, 4, 5: K2
       once per superstep and G1, and not K4 or G2; one host sync per
       superstep (the resample gate);
   (b) the same at P = 131072: K4 and G2, and not K2 or G1;
   (c) BASELINE config #5 composed, through run_config5 (no device
       named): FastSlam1Deferred at P = 2^20 with capacity 192, 32
       supersteps, seeds 3, 4, 5, then problem_from_run and
       solve_ba_sharded: K6 once per superstep, K5 or K4 once per
       superstep, K5 and G2 at least once per run, one host sync (the
       gate) per superstep; the filter's 3-seed RMS ATE below twice
       JAX_CONFIG5_ATE_M, the refined one below twice
       JAX_CONFIG5_REFINED_ATE_M, and on each seed the refined ATE below
       max(2 ATE_filter, 0.15);
   (d) FastSlam1Deferred on dense200 at P = 131072, 2000 ticks, seeds 3,
       4, 5: K5 and K6, and not K2 or G1;
   then FastSLAM 2 through Runner with -method FASTSLAM2:
   (e) dense200 (heading known), P = 100, 2000 ticks, seeds 3, 4, 5:
       K3, K2 once per superstep and G1, and not K4, K6b, G2, K5 or K6;
       one host sync per superstep;
   (f) the JAX package's fastslam2_1m world (heading unknown,
       synthetic_map(35, 17, radius=100)), P = 2^20, 1024 ticks, seeds
       3, 4, 5: K6b once per superstep, K3, K4 and G2, and not K2, G1,
       K5 or K6; one host sync per superstep.
   then config #5's two other bench points, seed 3 each, with the same
   launches and per-seed check: (c') cap256, P = 2^20, capacity 256,
   16 supersteps; (c'') full-10k, P = 32,768, capacity 10,000 (6.6 GB
   of landmark planes per buffer), 16 supersteps.
   No slice may launch K1, which lies on no path. No run names a
   device: the runner, the simulator, the estimator and the final state
   must be on the card by default. Each 3-seed RMS ATE
   must be finite and below twice the JAX package's
   on the same world and seeds (JAX_ANCHOR_ATE_M, JAX_CONFIG5_ATE_M,
   JAX_FS2_ANCHOR_ATE_M, JAX_FS2_WEBMAP_ATE_M).
5. Deferred against eager: FastSlam1Deferred with the per-tick predict
   against FastSlam1, dense200, P = 131072, seed 3, 400 ticks. They draw
   the same random numbers and K5 runs K4's code, so the pose traces and
   the finalized states must be bit-identical, or at least within rtol
   and atol 1e-4; the line printed says which held.
6. Replay: seed 3 at P = 131072 twice, eager and deferred, and slice
   (f) seed 3 twice, give bit-identical estimates (no reduction or scan
   on the paths rounds by timing).
7. EKF-SLAM end to end through Runner, no device named:
   (g) ekf-webmap: EKF1, the default method, on the world of the JAX
       package's ekf1_webmap line (heading unknown, association
       unknown), 2000 ticks, seeds 3-8;
   (h) ekf-dense200: EKF1 on dense200 with the heading known (the
       Joseph heading update every tick), 2000 ticks, seeds 3, 4, 5;
   (i) ekf-10k: the landmark-block ShardedEkfSlam at 10k landmarks
       (config5_setup(10_000, capacity=10_000, max_obs=96), a 1.6 GB
       covariance), 640 ticks, seeds 3, 4, 5.
   Each runs its supersteps with torch.cuda.set_sync_debug_mode("error")
   (any host sync raises) and RunResult.host_syncs 0, launches none of
   the nine kernels, leaves the runner, simulator, estimator and final
   state on the card, and must reach an RMS ATE below twice the JAX
   package's (JAX_EKF_*_ATE_M); one more run is profiled over a window
   for the device time per superstep.
8. Sharded against dense: ShardedEkfSlam against EkfSlam on the JAX
   test's world (16 landmarks, heading known, 240 ticks, seed 5), at its
   tolerances: pose and covariance atol 5e-3, pose block 5e-4, n equal.
9. TF32 held off: two ekf-10k supersteps with the caller's
   torch.backends.cuda.matmul.allow_tf32 True and then False give
   bit-equal states; a bare product at the Pmm pass's shapes under each
   setting shows whether TF32 changes a result on this card.
10. The Pmm pass of ekf-10k (Pmm -= W W', in place, W [20000, 200])
   timed against its bound.
11. ba-10k: bundle adjustment alone, solve_ba_device (30 iterations) on
   make_ba_problem(256, 10_000), and the same solve from the truth (the
   MAP floor): the error must fall below 0.2 of the dead-reckoned one
   and below max(1.25 floor, 0.05) (bench.py's two checks), and lie
   within 5 % of the JAX package's on the same problem
   (JAX_BA10K_ERR_M); a second solve must replay it bit for bit; none
   of the nine kernels may launch. Prints ms per LM trial (CUDA events
   and profiler device time), trials, host reads per solve, peak device
   memory, and the Schur product W All^-1 W' ([768, 20000] x [20000,
   768]) timed against its bound.

The last line is the JSON result; the two lines before it are the
kernel table (JSON: per kernel its launches on the main paths and per
superstep of each slice, error, times, bytes, operations, bound and
share of the bound) and the card's name and power limit.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time

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

MAP, INI = "data/dense200.mat", "data/dense200.ini"
TICKS, SEEDS = 2000, (3, 4, 5)
P_SMALL, P_LARGE = 100, 131072
K_OBS, CAPACITY = 15, 200
# Config #5 on one card, as the JAX package's bench_config5 runs it:
# 10k landmarks, capacity 192, at most 96 observations, 2^20 particles,
# 32 supersteps; and its cap256 and full-10k points (bench.py:499-507).
C5_LANDMARKS, C5_CAPACITY, C5_MAX_OBS = 10_000, 192, 96
C5_P, C5_SUPERSTEPS = 2 ** 20, 32
C5_POINTS = (("config5-cap256", 2 ** 20, 256, 16),
             ("config5-full-10k", 32_768, 10_000, 16))
# The ba_10k problem (keyframes, landmarks) and its iterations.
BA10K_SHAPE, BA10K_ITERS = (256, 10_000), 30
T_PREDICT = 8
# The fastslam2_1m world: heading unknown, 35 landmarks (capacity 40),
# 2^20 particles. Its vehicle first sees a landmark after 63
# supersteps, so 128 supersteps (1024 ticks) are run, not the bench
# line's 8: the update then refines on matched observations and the
# resample fires.
FS2_P, FS2_TICKS = 2 ** 20, 1024
TOL = dict(rtol=1e-5, atol=1e-5)
TOL_REFINE_XV = dict(rtol=1e-4, atol=1e-5)
TOL_REFINE_PV = dict(rtol=1e-3, atol=1e-6)
TOL_PATHS = dict(rtol=1e-4, atol=1e-4)
R = [[0.01, 0.0], [0.0, 0.0003]]
Q = [[0.09, 0.0], [0.0, 0.0025]]
# K5's tiles, as in csrc/resample_update.cu (kTile, kStageWidth): a tile
# of output columns is staged through shared memory when its ancestor
# run, widened to 16-byte edges, fits the staging width.
K5_TILE, K5_STAGE_WIDTH = 512, 768
K5_EDGE_P = 2 ** 16

# The bound of a kernel: the larger of its bytes over the card's memory
# rate and its operations over the float32 rate outside the tensor
# cores (NVIDIA's data sheet for the H100 SXM, at 700 W).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Operations per unit of work, counted from csrc/planes.cuh, predict.cu
# and philox.cuh: each arithmetic operation, comparison, integer
# operation and libm call as one. These bounds are low twice over: a
# libm call is tens of instructions, and 67e12/s counts a fused
# multiply-add as two operations while this build (--fmad=false) fuses
# none, so its multiplies and adds issue at half that rate at best. K6
# and K6b, which instruction issue bounds, get an issue bound beside
# this one (sass_counts, issue_bound).
OPS_JACOBIAN = 65    # jacobians_planes, per (k, p)
OPS_MATCH = 150      # planes.cuh:fs1_match, per matched (k, p)
OPS_INIT = 35        # feature_init_planes, per new (k, p)
OPS_REFINE = 190     # K3 per matched (k, p): Jacobians, refine_pose_planes
OPS_TICK_FS1 = 19    # K6's bicycle step, per (tick, p)
OPS_NOISE = 120      # Philox4x32-10 (98) and Box-Muller (22), per (tick, p)
OPS_TICK_FS2 = 115   # K6b's covariance and bicycle step, per (tick, p)

# The issue bound of K6 and K6b: a thread's SASS instructions over the
# card's issue rate, one warp instruction per scheduler and clock, with
# the integer multiply-adds (IMAD, half the float32 lanes) taking two
# slots.
SMS, SCHEDULERS_PER_SM, LANES = 132, 4, 32
P_RAGGED = 2 ** 20 + 37
# K2's edge cases: a ragged large P, and a K whose K x 8 threads (K2's
# block at P = 100) pass 1024.
P_K2_RAGGED, K_STRIDED = 2 ** 17 + 37, 160
# A T that is no multiple of the tick loop's unrolling, and a T and P
# whose ticks take two launches (csrc/predict.cu:kMaxTicks is 256).
T_ODD, T_LONG, P_LONG = 5, 300, 4133
# The EKF slices: the ekf1_webmap line's six seeds; ekf_10k's 10k
# landmarks (capacity 10k, state N = 20,003) over 640 ticks.
EKF_WEBMAP_SEEDS = (3, 4, 5, 6, 7, 8)
EKF10K_LANDMARKS, EKF10K_TICKS = 10_000, 640
# Sharded against dense (tests/test_parallel_ekf.py:38-57): 16
# landmarks, 240 ticks, seed 5, the JAX test's tolerances.
TOL_SHARDED_POSE, TOL_SHARDED_COV, TOL_SHARDED_P00 = 5e-3, 5e-3, 5e-4

KERNELS = {
    "K2": ("slam_tpu_torch/csrc/observe.cu",
           "slam_tpu/ops/pallas/kernels.py:151"),
    "K4": ("slam_tpu_torch/csrc/fused_update.cu",
           "slam_tpu/ops/pallas/kernels.py:409"),
    "G1": ("slam_tpu_torch/csrc/gather.cu",
           "slam_tpu/ops/pallas/gather.py:128"),
    "G2": ("slam_tpu_torch/csrc/gather.cu",
           "slam_tpu/ops/pallas/gather.py:371"),
    "K5": ("slam_tpu_torch/csrc/resample_update.cu",
           "slam_tpu/ops/pallas/kernels.py:821"),
    "K6": ("slam_tpu_torch/csrc/predict.cu",
           "slam_tpu/ops/pallas/kernels.py:618"),
    "K1": ("slam_tpu_torch/csrc/jacobians.cu",
           "slam_tpu/ops/pallas/kernels.py:79"),
    "K3": ("slam_tpu_torch/csrc/refine.cu",
           "slam_tpu/ops/pallas/kernels.py:225"),
    "K6b": ("slam_tpu_torch/csrc/predict.cu",
            "slam_tpu/ops/pallas/kernels.py:703"),
}


def check(cond, msg: str) -> None:
    """Fail the smoke test; unlike ``assert``, kept under ``python -O``."""
    if not cond:
        raise AssertionError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean milliseconds per call of ``fn`` on the card, after a warm-up,
    by CUDA events around ``iters`` back-to-back calls."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timed_pair(kernel, plain):
    """(kernel ms, plain ms), measured in turns plain, kernel, kernel,
    plain; the smaller of each pair. The twin, up to 1000 times slower,
    is timed over 5 calls."""
    p1 = cuda_ms(plain, iters=5)
    k1 = cuda_ms(kernel)
    k2 = cuda_ms(kernel)
    p2 = cuda_ms(plain, iters=5)
    return min(k1, k2), min(p1, p2)


def measure(kernel, plain, library=None) -> dict:
    """The kernel's and its twin's CUDA-event times (timed_pair), the
    kernel's device time from torch.profiler, and, where one PyTorch
    call computes the same function, that call's two times."""
    from slam_tpu_torch.runtime.profiling import device_ms

    ms, plain_ms = timed_pair(kernel, plain)
    out = dict(ms=ms, plain_ms=plain_ms, device_ms=device_ms(kernel),
               library_ms=None, library_device_ms=None)
    if library is not None:
        out.update(library_ms=cuda_ms(library),
                   library_device_ms=device_ms(library))
    return out


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by): the least time of the work on this card."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(got, want) -> float:
    return max(float((g.double() - w.double()).abs().max())
               for g, w in zip(got, want))


def check_kernels(dev) -> dict:
    """Phase 3: every kernel against its twin at main-path shapes."""
    import numpy as np
    import torch

    from slam_tpu_torch.ops.kernels import kernels as kk

    rng = np.random.default_rng(0)
    g = torch.Generator(device=dev).manual_seed(0)
    results = {}

    def t(a, dtype=torch.float32):
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

    results["K2"] = check_k2(dev, rng, g)

    # K4 and G2 at the shapes of the FS1 slice (b) and of the FS2 slice
    # (f); the first of each is the one timed in the kernel table.
    fs2_K, fs2_L = fs2_shapes()
    results["K4"] = check_k4(dev, rng, g, P_LARGE, CAPACITY, K_OBS,
                             n_map=CAPACITY, live=120, n_match=10, n_new=4)
    results["K4 fs2-1m"] = check_k4(dev, rng, g, FS2_P, fs2_L, fs2_K,
                                    n_map=35, live=20, n_match=5, n_new=3)

    results.update(check_gathers(dev, g, fs2_L))
    results["K5"] = check_k5(dev, rng, g)
    # K4 and K5 at the full-10k run's shapes (phase 4, c''): 10k slots,
    # 32,768 particles, 6.6 GB of landmark planes.
    _, P10k, L10k, _ = C5_POINTS[1]
    full = dict(n_map=C5_LANDMARKS, live=300, n_match=70, n_new=20)
    results["K4 full-10k"] = check_k4(dev, rng, g, P10k, L10k, C5_MAX_OBS,
                                      **full)
    torch.cuda.empty_cache()
    results["K5 full-10k"] = check_k5_fired(dev, rng, g, P10k, L10k,
                                            C5_MAX_OBS, full)
    # K6's main path draws (FastSLAM 1 forces the noise on); K6b's does
    # not (SWITCH_PREDICT_NOISE defaults to 0).
    results["K6"] = check_predict(dev, g, "K6", C5_P, fs2=False,
                                  timed_noise=True)
    results["K3"] = check_k3(dev, rng, g)
    results["K6b"] = check_predict(dev, g, "K6b", FS2_P, fs2=True,
                                   timed_noise=False)
    results["K1"] = check_k1(dev, rng, g)
    return results


def check_gathers(dev, g, fs2_L) -> dict:
    """G1 (P = 100) and G2 (P = 2^17, and P = 2^20 at L = 40) over the
    resample gather's three row sets, 10 + 5L rows: bit-equal to their
    twins and to the library call that computes the same gather
    (index_select by the ancestors for G1, repeat_interleave by the
    offspring counts for G2, on the rows stacked beforehand)."""
    import torch

    from slam_tpu_torch.ops import resampling as rs
    from slam_tpu_torch.ops.kernels import gather as kg

    f32 = dict(dtype=torch.float32, device=dev)
    results = {}
    for name, P, L in (("G1", P_SMALL, CAPACITY), ("G2", P_LARGE, CAPACITY),
                       ("G2 fs2-1m", FS2_P, fs2_L)):
        arrays = [torch.randn((c, P), generator=g, **f32) * 37
                  for c in (10, 2 * L, 3 * L)]
        stacked = torch.cat(arrays)
        rows = stacked.shape[0]
        logw = torch.randn(P, generator=g, **f32) * 2.0
        U = rs.uniform_from_generator(P, g, dev)
        if name == "G1":
            sel = rs.stratified_indices(logw, U)
            kernel, plain = kg.sorted_gather_multi, \
                kg.sorted_gather_multi_plain
            distinct = int(torch.unique(sel).numel())
            library = lambda: torch.index_select(stacked, 1, sel)  # noqa
        else:
            sel = rs.offspring_bounds(
                rs.cumulative_weights(rs.normalize_log_weights(logw)), P, U)
            kernel, plain = kg.bounds_gather_multi, \
                kg.bounds_gather_multi_plain
            counts = torch.diff(sel, prepend=sel.new_zeros(1)).long()
            distinct = int((counts > 0).sum())
            library = lambda: torch.repeat_interleave(  # noqa
                stacked, counts, dim=1, output_size=P)
        got, want = kernel(arrays, sel), plain(arrays, sel)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            if not torch.equal(a, b):
                raise AssertionError(f"{name}: gather is not bit-equal")
        check(torch.equal(library(), torch.cat(got)),
              f"{name}: the library call gathers other values")
        results[name] = dict(
            max_abs_err=max_abs_err(got, want),
            shape=f"rows={rows} P={P} distinct={distinct}",
            bytes=4 * (rows * distinct + P + rows * P), ops=0,
            **measure(lambda: kernel(arrays, sel), lambda: plain(arrays, sel),
                      library))
        del got, want, arrays, stacked
    return results


def update_inputs(dev, rng, g, P, L, K, *, n_map, live, n_match, n_new,
                  twice=False, past_capacity=False):
    """A particle state and an observation batch for K2, K4 and K5 at K
    observations, L slots, P particles: ``live`` landmarks mapped,
    ``n_match`` of them observed, ``n_new`` new ones, the rest masked
    observations of live landmarks. ``twice``: the first landmark is
    observed twice, so two k match one slot. ``past_capacity``: the new
    observations whose slots lie past the L slots stay flagged in ``ok``,
    for the kernel to drop. Returns (state, (z, slot, matched, slot_new,
    ok))."""
    import numpy as np
    import torch

    from slam_tpu_torch.models.particles import init_particles
    from slam_tpu_torch.models.rbpf import associate_known, new_slots

    check(n_match + n_new <= K and live <= L and live + n_new <= n_map
          and (past_capacity or live + n_new <= L),
          "update input: inconsistent sizes")
    f32 = dict(dtype=torch.float32, device=dev)

    def t(a, dtype=torch.float32):
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

    state = init_particles(P, L, n_map, device=dev)
    truth = rng.uniform(-25.0, 25.0, size=(n_map, 2))
    table = np.full(n_map, -1, np.int32)
    table[:live] = rng.permutation(live)
    lm = torch.zeros((2, L, P), **f32)
    lm[:, table[:live]] = t(truth[:live].T[:, :, None])
    lm += 0.2 * torch.randn((2, L, P), generator=g, **f32)
    state.lm.copy_(lm)
    del lm
    state.lm_P[0, :live] = 0.05
    state.lm_P[1, :live] = 0.01
    state.lm_P[2, :live] = 0.04
    state.xv.copy_(0.1 * torch.randn((3, P), generator=g, **f32))
    state = state._replace(n=t(live, torch.int32),
                           da_table=t(table, torch.int32))
    seen = rng.choice(live, n_match, replace=False)
    if twice:
        seen[1] = seen[0]
    ids_np = np.concatenate([seen, np.arange(live, live + n_new),
                             rng.choice(live, K - n_match - n_new)]
                            ).astype(np.int32)
    d = truth[ids_np]
    z = t(np.column_stack([np.hypot(d[:, 0], d[:, 1]),
                           np.arctan2(d[:, 1], d[:, 0])]))
    ids = t(ids_np, torch.int32)
    zmask = t(np.arange(K) < n_match + n_new, torch.bool)
    assoc, is_new = associate_known(state, ids, zmask)
    matched = assoc >= 0
    slot = torch.where(matched, assoc, 0).to(torch.int32)
    slot_new, ok = new_slots(state, is_new)
    if past_capacity:
        ok = is_new
    check(int(matched.sum()) == n_match and int(ok.sum()) == n_new,
          f"update input: expected {n_match} matched and {n_new} new "
          "observations")
    return state, (z, slot, matched, slot_new, ok)


def check_k2(dev, rng, g) -> dict:
    """K2 on by-slot inputs, as K4 takes them, at the main path's shape
    (K = 15, L = 200, P = 100: 120 live landmarks, 10 matched, 4 new)
    and on the edge cases: a ragged large P, one landmark observed
    twice, new slots past the capacity, no matched observation, and
    K = 160, whose K x 8 threads pass 1024 (each thread then takes every
    128th k). Within TOL of its twin on every case, and bit-equal to K4
    on every case whose matched slots are distinct. Times K2 and, as the
    yardstick of its thread map, K4 on the same inputs at P = 100 and at
    the ragged P."""
    import torch

    from slam_tpu_torch.ops.kernels import kernels as kk
    from slam_tpu_torch.runtime.profiling import device_ms

    main = dict(n_map=CAPACITY, live=120, n_match=10, n_new=4)
    # (name, P, K, inputs, bit-equal to K4)
    cases = (("main", P_SMALL, K_OBS, main, True),
             ("ragged large P", P_K2_RAGGED, K_OBS, main, True),
             ("one landmark observed twice", P_SMALL, K_OBS,
              dict(main, twice=True), False),
             ("new slots past the capacity", P_SMALL, K_OBS,
              dict(n_map=CAPACITY + 20, live=CAPACITY - 2, n_match=10,
                   n_new=4, past_capacity=True), True),
             ("no matched observation", P_SMALL, K_OBS,
              dict(main, n_match=0), True),
             ("K x 8 threads past 1024", P_SMALL, K_STRIDED,
              dict(n_map=400, live=150, n_match=100, n_new=20), True))
    err, out = 0.0, {}
    for name, P, K, kw, k4_equal in cases:
        state, batch = update_inputs(dev, rng, g, P, CAPACITY, K, **kw)

        def fresh():
            return (state.xv, state.logw.clone(), state.lm.clone(),
                    state.lm_P.clone(), *batch, R)
        a_k2, a_twin, a_k4 = fresh(), fresh(), fresh()
        kk.observe(*a_k2)
        kk.observe_plain(*a_twin)
        kk.fused_update(*a_k4)
        torch.cuda.synchronize()
        got = a_k2[1:4]
        check(all(bool(torch.isfinite(a).all()) for a in got),
              f"K2 {name}: non-finite output")
        check(kw["n_match"] == 0 or not torch.equal(got[0], state.logw),
              f"K2 {name}: the weights did not move")
        for a, b in zip(got, a_twin[1:4]):
            torch.testing.assert_close(a, b, **TOL)
        if k4_equal:
            check(all(torch.equal(a, b) for a, b in zip(got, a_k4[1:4])),
                  f"K2 {name}: not bit-equal to K4 (max abs err "
                  f"{max_abs_err(got, a_k4[1:4]):.3g})")
        err = max(err, max_abs_err(got, a_twin[1:4]))
        print(f"kernel K2 {name} (K={K} P={P}): within TOL of its twin"
              f"{', bit-equal to K4' if k4_equal else ''}", flush=True)
        if name == "main":
            b_k2, b_twin, b_k4 = fresh(), fresh(), fresh()
            out.update(measure(lambda: kk.observe(*b_k2),
                               lambda: kk.observe_plain(*b_twin)))
            # Reads the pose, the weight and the matched slots; writes
            # the weight and the touched slots.
            n_match, n_new = kw["n_match"], kw["n_new"]
            out.update(
                shape=f"K={K} L={CAPACITY} P={P}",
                bytes=4 * P * (3 + 2 + 10 * n_match + 5 * n_new) + 18 * K,
                ops=P * (n_match * OPS_MATCH + n_new * OPS_INIT),
                k4_ms=cuda_ms(lambda: kk.fused_update(*b_k4)),
                k4_device_ms=device_ms(lambda: kk.fused_update(*b_k4)))
        elif name == "ragged large P":
            b_k2, b_k4 = fresh(), fresh()
            out.update(
                ragged_P=P, ragged_ms=cuda_ms(lambda: kk.observe(*b_k2)),
                ragged_device_ms=device_ms(lambda: kk.observe(*b_k2)),
                ragged_k4_ms=cuda_ms(lambda: kk.fused_update(*b_k4)),
                ragged_k4_device_ms=device_ms(
                    lambda: kk.fused_update(*b_k4)))
        del state, batch, a_k2, a_twin, a_k4
    print(f"kernel K2 against K4 on the same inputs: P={P_SMALL} "
          f"{out['device_ms']} against {out['k4_device_ms']} ms (device); "
          f"P={P_K2_RAGGED} {out['ragged_device_ms']} against "
          f"{out['ragged_k4_device_ms']} ms (device)", flush=True)
    return dict(out, max_abs_err=err)


def ptxas_registers(source) -> dict:
    """{mangled kernel name: (registers, spill store bytes)} of one csrc
    source, by ``nvcc -Xptxas -v`` under the build's flags (the object
    file thrown away)."""
    import re
    import tempfile

    from slam_tpu_torch.ops.kernels import build

    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
             "-o", f"{tmp}/k.o", str(build.CSRC_DIR / source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            timeout=300)
    out = proc.stdout
    check(proc.returncode == 0, f"nvcc -Xptxas -v failed:\n{out}")
    regs = {}
    for part in out.split("Compiling entry function '")[1:]:
        name = part.split("'", 1)[0]
        used = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores", part)
        check(used is not None, f"ptxas: no register count for {name}")
        regs[name] = (int(used.group(1)), int(spill.group(1)) if spill else 0)
    return regs


def check_k4(dev, rng, g, P, L, K, *, n_map, live, n_match, n_new) -> dict:
    """K4 at K observations, L slots, P particles: ``live`` landmarks
    mapped, ``n_match`` of them observed, ``n_new`` new ones and the
    rest masked. Also records K4's map at this P, as the library reports
    it: threads per particle and chunk."""
    import torch

    from slam_tpu_torch.ops.kernels import kernels as kk

    state, batch = update_inputs(dev, rng, g, P, L, K, n_map=n_map,
                                 live=live, n_match=n_match, n_new=n_new)

    def fresh():
        return (state.xv, state.logw.clone(), state.lm.clone(),
                state.lm_P.clone(), *batch, R)
    a_k, a_p = fresh(), fresh()
    kk.fused_update(*a_k)
    kk.fused_update_plain(*a_p)
    torch.cuda.synchronize()
    for a, b in zip(a_k[1:4], a_p[1:4]):
        torch.testing.assert_close(a, b, **TOL)
    err = max_abs_err(a_k[1:4], a_p[1:4])
    del a_k, a_p
    b_k, b_p = fresh(), fresh()
    # Reads the pose, the weight and the matched slots; writes the
    # weight and the touched slots.
    nbytes = 4 * P * (3 + 2 + 5 * n_match + 5 * (n_match + n_new)) + 18 * K
    return dict(max_abs_err=err, shape=f"K={K} L={L} P={P}", bytes=nbytes,
                ops=P * (n_match * OPS_MATCH + n_new * OPS_INIT),
                **dict(zip(("threads_per_particle", "chunk"),
                           kk.fused_update_map(P))),
                **measure(lambda: kk.fused_update(*b_k),
                          lambda: kk.fused_update_plain(*b_p)))


def k5_bounds(dev, rng, g, P, kind):
    """Offspring bounds S [P] for a K5 check: a fired stratified
    resample of random weights, or a chosen ancestor vector."""
    import numpy as np
    import torch

    from slam_tpu_torch.ops import resampling as rs

    if kind == "fired":
        logw = torch.randn(P, generator=g, device=dev)
        return rs.offspring_bounds(
            rs.cumulative_weights(rs.normalize_log_weights(logw)), P,
            rs.uniform_from_generator(P, g, dev))
    anc = np.arange(P)
    tile = K5_TILE
    if kind == "one ancestor":
        anc[:] = P // 3 + 1
    elif kind == "identity but one tile":
        j0 = 5 * tile
        anc[j0:j0 + tile] = np.sort(rng.integers(j0, j0 + tile, tile))
    elif kind == "wide run":     # tile 0 from every 8th of 8 tiles' columns
        anc[:tile] = 8 * np.arange(tile)
        anc[tile:] = np.sort(rng.integers(8 * tile, P, P - tile))
    else:
        raise ValueError(kind)
    S = np.searchsorted(anc, np.arange(P), side="right")
    return torch.tensor(S, dtype=torch.int32, device=dev)


def k5_layout(S) -> dict:
    """What K5's work depends on in S: the distinct ancestors, the share
    of 32-byte sectors of an input row (8 columns) that hold at least
    one of them (what a read must fetch at the memory's granularity),
    and the share of tiles whose ancestor run fits the staging width."""
    import torch

    from slam_tpu_torch.ops import resampling as rs

    P = S.shape[0]
    anc = rs.ancestors_from_bounds(S, P)
    first, last = anc[::K5_TILE], anc[K5_TILE - 1::K5_TILE]
    last = torch.cat([last, anc[-1:]])[:first.shape[0]]
    width = ((last | 3) + 1) - (first & ~3)
    live = torch.diff(S, prepend=S.new_zeros(1)) > 0
    sectors = torch.nn.functional.pad(live, (0, -P % 8)).view(-1, 8)
    return dict(distinct=int(live.sum()),
                live_sectors=float(sectors.any(dim=1).float().mean()),
                staged_tiles=float((width <= K5_STAGE_WIDTH).float().mean()))


def check_k5_case(name, state, batch, S, logw, twin=True) -> float:
    """K5 on one input: bit-equal to G2's gather followed by K4, its
    staged and direct branches bit-equal, and (``twin``) within TOL of
    its twin. Returns the largest error against the twin."""
    import torch

    from slam_tpu_torch.ops.kernels import gather as kg
    from slam_tpu_torch.ops.kernels import kernels as kk

    _, L, P = state.lm.shape

    def args(lw):
        return (state.xv, lw, state.lm, state.lm_P, S, *batch, R)

    def composed(lw):
        lm_g, lmP_g = kg.bounds_gather_multi(
            [state.lm.reshape(2 * L, P), state.lm_P.reshape(3 * L, P)], S)
        lm_g, lmP_g = lm_g.reshape(2, L, P), lmP_g.reshape(3, L, P)
        kk.fused_update(state.xv, lw, lm_g, lmP_g, *batch, R)
        return lm_g, lmP_g

    lw = [logw.clone() for _ in range(3)]
    got = (lw[0], *kk.resample_update(*args(lw[0])))
    for other, what in ((lambda a: kk.resample_update_launch(
            *args(a), staged=False), "its direct branch"),
                        (composed, "G2 + K4")):
        ref = (lw[1], *other(lw[1]))
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            check(torch.equal(a, b), f"K5 {name}: not bit-equal to {what}")
        lw[1] = logw.clone()
        del ref
    err = 0.0
    if twin:
        want = (lw[2], *kk.resample_update_plain(*args(lw[2])))
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, **TOL)
        err = max_abs_err(got, want)
    return err


def check_k5_fired(dev, rng, g, P, L, K, inputs) -> dict:
    """K5 on the offspring bounds of a fired resample at K observations,
    L slots, P particles (``inputs``: update_inputs' counts): bit-equal
    to G2 + K4 and across its branches, within TOL of its twin, and
    timed, with its bytes and operations."""
    import torch

    from slam_tpu_torch.ops.kernels import kernels as kk
    from slam_tpu_torch.runtime.profiling import device_ms

    state, batch = update_inputs(dev, rng, g, P, L, K, **inputs)
    logw = torch.randn(P, generator=g, device=dev)
    S = k5_bounds(dev, rng, g, P, "fired")
    check(not torch.equal(S, torch.arange(1, P + 1, device=dev,
                                          dtype=torch.int32)),
          "K5 input: the bounds are the identity")
    err = check_k5_case(f"K={K} L={L} P={P}", state, batch, S, logw)
    layout = k5_layout(S)

    def args(lw):
        return (state.xv, lw, state.lm, state.lm_P, S, *batch, R)
    lw_k, lw_p, lw_d = logw.clone(), logw.clone(), logw.clone()
    times = measure(lambda: kk.resample_update(*args(lw_k)),
                    lambda: kk.resample_update_plain(*args(lw_p)))

    def direct():
        return kk.resample_update_launch(*args(lw_d), staged=False)
    times.update(direct_ms=cuda_ms(direct), direct_device_ms=device_ms(direct))
    # Reads the pose, the weight, S and every row of the distinct
    # ancestors but those of the new slots; writes the weight and all
    # 5 L rows.
    nbytes = (4 * P * (3 + 1 + 1 + 5 * L + 1)
              + 4 * 5 * (L - inputs["n_new"]) * layout["distinct"] + 18 * K)
    print(f"kernel K5 (K={K} L={L} P={P}): distinct ancestors "
          f"{layout['distinct']}, sectors holding one "
          f"{layout['live_sectors']:.4f}, staged tiles "
          f"{layout['staged_tiles']:.4f}; direct branch "
          f"{times['direct_ms']:.4f} ms", flush=True)
    del state, batch
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, shape=f"K={K} L={L} P={P}", bytes=nbytes,
                ops=P * (inputs["n_match"] * OPS_MATCH
                         + inputs["n_new"] * OPS_INIT), **layout, **times)


def check_k5(dev, rng, g) -> dict:
    """K5 at config #5's shapes: 150 live landmarks of 192 slots, 70
    matched observations, 20 new ones, 6 masked (K = 96), and the
    offspring bounds of a fired resample; then the edge cases at
    P = 2^16."""
    import torch

    L, K = C5_CAPACITY, C5_MAX_OBS
    c5 = dict(n_map=400, live=150, n_match=70, n_new=20)
    out = check_k5_fired(dev, rng, g, C5_P, L, K, c5)
    err = out["max_abs_err"]

    # (name, L, K, inputs, bounds, one landmark observed twice)
    cases = (("one ancestor", L, K, c5, "one ancestor", False),
             ("identity but one tile", L, K, c5, "identity but one tile",
              False),
             ("wide run", L, K, c5, "wide run", False),
             ("L=40", 40, 9, dict(n_map=35, live=20, n_match=5, n_new=3),
              "fired", False),
             ("no matched observation", L, K, dict(c5, n_match=0), "fired",
              False),
             ("one landmark observed twice", L, K, c5, "fired", True))
    Pe = K5_EDGE_P
    for name, Le, Ke, kw, kind, twice in cases:
        st, bt = update_inputs(dev, rng, g, Pe, Le, Ke, **kw, twice=twice)
        Se = k5_bounds(dev, rng, g, Pe, kind)
        e = check_k5_case(name, st, bt, Se,
                          torch.randn(Pe, generator=g, device=dev),
                          twin=not twice)
        err = max(err, e)
        lay = k5_layout(Se)
        if kind == "wide run":
            check(lay["staged_tiles"] < 1.0, "K5 wide run: every tile staged")
        print(f"kernel K5 edge case {name} (K={Ke} L={Le} P={Pe}): "
              f"bit-equal to G2 + K4 and across branches"
              f"{'' if twice else ', within TOL of the twin'}; "
              f"staged tiles {lay['staged_tiles']:.4f}", flush=True)
    return dict(out, max_abs_err=err)


def predict_inputs(dev, g, P, T, fs2: bool):
    """Poses xv [3, P] (and, ``fs2``, pose covariances Pv [6, P]),
    controls [T, 2] and a key for K6 or K6b."""
    import torch

    f32 = dict(dtype=torch.float32, device=dev)
    state = [torch.randn((3, P), generator=g, **f32)]
    if fs2:
        Pv = torch.zeros((6, P), **f32)
        Pv[0], Pv[3], Pv[5] = 0.02, 0.02, 0.01
        state.append(Pv)
    ctl = torch.stack([3.0 + 0.3 * torch.randn(T, generator=g, **f32),
                       0.1 * torch.randn(T, generator=g, **f32)], dim=1)
    seed = torch.randint(-2 ** 31, 2 ** 31, (2,), dtype=torch.int32,
                         generator=g, device=dev)
    return state, ctl, seed


def check_predict(dev, g, name, P, fs2: bool, timed_noise: bool) -> dict:
    """K6 (or, ``fs2``, K6b) bit for bit against its twin, the noise on
    and off: at T = 8 and P particles (the main path's shape, whose
    ``timed_noise`` arm is timed), at T = 8 and a ragged P, at T_ODD and
    at T_LONG."""
    import torch

    from slam_tpu_torch.ops.kernels import predict as kp

    kernel, plain = ((kp.fs2_predict_multi, kp.fs2_predict_multi_plain)
                     if fs2 else
                     (kp.fs1_predict_multi, kp.fs1_predict_multi_plain))
    err = 0.0
    for T, Pc in ((T_PREDICT, P), (T_PREDICT, P_RAGGED),
                  (T_ODD, P_RAGGED), (T_LONG, P_LONG)):
        state, ctl, seed = predict_inputs(dev, g, Pc, T, fs2)
        for noise in (True, False):
            kw = dict(wheelbase=4.0, dt=0.025, add_noise=noise)
            got = [a.clone() for a in state]
            want = [a.clone() for a in state]
            kernel(*got, seed, ctl, Q, **kw)
            plain(*want, seed, ctl, Q, **kw)
            torch.cuda.synchronize()
            check(all(bool(torch.isfinite(a).all()) for a in got),
                  f"{name}: non-finite output")
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"{name} T={T} P={Pc} noise={noise}: not bit-equal to "
                  f"its twin (max abs err {max_abs_err(got, want):.3g})")
            check(not torch.equal(got[0], state[0]),
                  f"{name}: the poses did not move")
            err = max(err, max_abs_err(got, want))
        print(f"kernel {name} T={T} P={Pc}: bit-equal to its twin, noise "
              "on and off", flush=True)
    state, ctl, seed = predict_inputs(dev, g, P, T_PREDICT, fs2)
    a, b = [t.clone() for t in state], [t.clone() for t in state]
    kw = dict(wheelbase=4.0, dt=0.025, add_noise=timed_noise)

    def run():
        return kernel(*a, seed, ctl, Q, **kw)
    times = measure(run, lambda: plain(*b, seed, ctl, Q, **kw))
    rows = 18 if fs2 else 6          # floats read and written per particle
    ops = OPS_TICK_FS2 if fs2 else OPS_TICK_FS1
    return dict(max_abs_err=err,
                shape=f"T={T_PREDICT} P={P} noise "
                      f"{'on' if timed_noise else 'off'}",
                bytes=4 * rows * P + 8 * T_PREDICT + 8,
                ops=P * T_PREDICT * (ops + (OPS_NOISE if timed_noise else 0)),
                sm_clock_mhz=sm_clock_mhz_under(run), threads=P, **times)


def sm_clock_mhz_under(fn) -> float:
    """The SM clock nvidia-smi reports while ``fn`` is launched back to
    back: the launches go on until the query has returned."""
    import torch

    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm",
         "--format=csv,noheader,nounits"],
        stdout=subprocess.PIPE, text=True)
    while proc.poll() is None:
        for _ in range(50):
            fn()
    torch.cuda.synchronize()
    check(proc.returncode == 0, "nvidia-smi could not read clocks.sm")
    return float(proc.stdout.read().strip().splitlines()[0])


# The instantiations the main paths launch: K6 with the noise on, K6b
# with it off (their mangled names' template arguments).
SASS_KERNELS = {"K6": "fs1_predict_multi_kernelILb1EE",
                "K6b": "fs2_predict_multi_kernelILb0EE"}
TICK_UNROLL = 4  # kTickUnroll in csrc/predict.cu
# SASS that only a slow path runs: an out-of-line call (division, square
# root), the stack and float64 work of the large-argument trig reduction,
# fmodf's truncation.
SASS_COLD = ("CALL", "RET", "STL", "LDL", "DMUL", "FRND")


def sass_hot_path(ops, trips: int) -> list:
    """The opcodes a thread issues on its usual way through a predict
    kernel. ``ops``: its SASS as (address, predicated, opcode, operands).
    The tick loop (the widest backward branch) is walked ``trips`` times.
    A forward branch is followed when it is unconditional, or when what
    it jumps over holds a slow-path instruction (SASS_COLD) or a loop
    other than the tick loop; any other conditional branch falls
    through. A predicated instruction counts: it takes its issue slot
    whatever the predicate."""
    at = {addr: i for i, (addr, *_) in enumerate(ops)}
    jumps = {i: at[int(args.split("0x")[-1].split()[0], 16)]
             for i, (_, _, op, args) in enumerate(ops)
             if op.split(".")[0] == "BRA"}
    loop = max((i - j, i) for i, j in jumps.items() if j <= i)[1]

    def cold(i, j):
        return any(ops[k][2].split(".")[0] in SASS_COLD
                   or jumps.get(k, k + 1) <= k for k in range(i + 1, j))

    hot, i = [], 0
    while True:
        _, pred, op, _ = ops[i]
        hot.append(op.split(".")[0])
        if hot[-1] == "EXIT" and not pred:
            return hot
        j = jumps.get(i, i + 1)
        if i == loop:
            trips -= 1
            i = j if trips else i + 1
        elif j > i + 1 and not i < loop < j and (not pred or cold(i, j)):
            i = j
        else:
            check(j > i, f"SASS: a loop on the hot path at {ops[i][0]:#x}")
            i += 1


def sass_counts(lib_path) -> dict:
    """{kernel: SASS instruction counts} of K6's and K6b's main-path
    instantiations, by ``cuobjdump -sass`` on the built library: the hot
    path of one thread through T = 8 ticks (sass_hot_path), split by the
    pipe that bounds its issue: ``imad`` the integer multiply-adds
    (IMAD*, IMUL*, UIMAD*: half the float32 lanes), ``f32`` float32
    arithmetic, compares and selects (F* but conversions), ``other`` the
    rest; and ``static``, every instruction of the kernel, slow paths
    included. K6b's hot path is that of the 248 threads of a block that
    compute no tick's shared terms."""
    import os
    import re

    from slam_tpu_torch.ops.kernels import build

    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    inst = re.compile(r"^\s+/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                      r"([A-Z][\w.]*)\s*([^;]*);")
    counts = {}
    for name, tag in SASS_KERNELS.items():
        blocks = [b for b in text.split("Function : ")[1:]
                  if tag in b.split(None, 1)[0]]
        check(len(blocks) == 1, f"cuobjdump lists {len(blocks)} {tag}")
        ops = [(int(m.group(1), 16), bool(m.group(2)), m.group(3), m.group(4))
               for m in map(inst.match, blocks[0].splitlines()) if m]
        hot = sass_hot_path(ops, T_PREDICT // TICK_UNROLL)
        imad = sum(op in ("IMAD", "IMUL", "UIMAD") for op in hot)
        f32 = sum(op[0] == "F" and not op.startswith("F2") for op in hot)
        counts[name] = dict(hot=len(hot), imad=imad, f32=f32,
                            other=len(hot) - imad - f32, static=len(ops))
    return counts


def issue_bound(st: dict, sass: dict) -> dict:
    """The least time the card's schedulers need to issue the kernel's
    instructions, as compiled, at the clock it ran at: ``threads`` x
    (f32 + other + 2 imad) issue slots over SMS x SCHEDULERS_PER_SM x
    LANES slots per clock; its share is of the kernel's device time (at
    these sizes the events time can be the host's enqueue rate). It
    measures how well this code keeps the issue pipes busy, not how
    little code the function needs: a wasteful body scores as high as a
    lean one, so kernels are ranked by ``bound_ms``, not by this."""
    slots = st["threads"] * (sass["f32"] + sass["other"] + 2 * sass["imad"])
    rate = SMS * SCHEDULERS_PER_SM * LANES * st["sm_clock_mhz"] * 1e6
    ms = slots / rate * 1e3
    return dict(issue_bound_ms=ms,
                issue_share=ms / (st["device_ms"] or st["ms"]), sass=sass)


def check_fast_math(dev) -> dict:
    """K6's and K6b's two substitutions on every float32 bit pattern:
    sincosf against sinf and cosf, wrap_angle_fast against wrap_angle."""
    import torch

    from slam_tpu_torch.ops.kernels import predict as kp

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sweep = kp.fast_math_sweep(dev)
    seconds = time.perf_counter() - t0
    print(f"fast-math sweep over 2^32 float32 patterns: {json.dumps(sweep)} "
          f"in {seconds:.2f} s", flush=True)
    check(not any(sweep[k] for k in ("sin_mismatches", "cos_mismatches",
                                     "wrap_mismatches")),
          f"fast-math sweep: K6 and K6b use a substitute that is not "
          f"bit-equal to what it replaces: {sweep}")
    return dict(sweep, seconds=seconds)


def gathered_planes(dev, rng, g, P, K):
    """xv [3, P] near the origin and landmark planes [K, P] gathered for
    K observations at 3 to 25 m, with their (range, bearing) z [K, 2]."""
    import numpy as np
    import torch

    f32 = dict(dtype=torch.float32, device=dev)
    xv = torch.randn((3, P), generator=g, **f32) * torch.tensor(
        [[0.3], [0.3], [0.05]], **f32)
    rngk = rng.uniform(3.0, 25.0, K)
    brg = rng.uniform(-1.4, 1.4, K)
    lmx = (torch.tensor(rngk * np.cos(brg), **f32)[:, None]
           + 0.3 * torch.randn((K, P), generator=g, **f32))
    lmy = (torch.tensor(rngk * np.sin(brg), **f32)[:, None]
           + 0.3 * torch.randn((K, P), generator=g, **f32))
    A = 0.2 * torch.randn((K, P), generator=g, **f32)
    planes = [lmx, lmy, A * A + 0.02, 0.3 * A * A, A * A + 0.03]
    z = torch.tensor(np.column_stack([rngk + rng.normal(size=K) * 0.1,
                                      brg + rng.normal(size=K) * 0.017]),
                     **f32)
    return xv, planes, z


def compare_poses(got, want, tol) -> float:
    """assert_close on x, y and on the wrapped heading difference; the
    largest absolute difference."""
    import torch

    from slam_tpu_torch.geometry import wrap_angle
    torch.testing.assert_close(got[:2], want[:2], **tol)
    dth = wrap_angle(got[2] - want[2])
    torch.testing.assert_close(dth, torch.zeros_like(dth), **tol)
    return max_abs_err([got[:2], dth], [want[:2], torch.zeros_like(dth)])


def check_k3(dev, rng, g) -> dict:
    """K3 at K = 15, P = 2^20: every fifth observation unmatched, its
    planes those of a landmark at the particle's own position (zero
    distance), which the kernel must pass by untouched; Pv at the scale
    a superstep of predict accumulates."""
    import torch

    from slam_tpu_torch.ops.kernels import kernels as kk

    P, K = FS2_P, K_OBS
    xv, planes, z = gathered_planes(dev, rng, g, P, K)
    matched = torch.arange(K, device=dev) % 5 != 4
    planes[0][~matched] = xv[0]
    planes[1][~matched] = xv[1]
    B = 0.01 * torch.randn((3, 3, P), generator=g, device=dev)
    M = torch.einsum("ikp,jkp->ijp", B, B) + 1e-5 * torch.eye(
        3, device=dev)[:, :, None]
    Pv = torch.stack([M[0, 0], M[0, 1], M[0, 2], M[1, 1], M[1, 2],
                      M[2, 2]]).contiguous()
    args = (xv, Pv, *planes, z, matched, R)
    got, want = kk.fs2_refine(*args), kk.fs2_refine_plain(*args)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all()),
          "K3: non-finite output")
    err = compare_poses(got[0], want[0], TOL_REFINE_XV)
    torch.testing.assert_close(got[1], want[1], **TOL_REFINE_PV)
    err = max(err, max_abs_err([got[1]], [want[1]]))
    n_match = int(matched.sum())
    # Reads the pose, Pv and the matched k's planes; writes pose and Pv.
    return dict(max_abs_err=err, shape=f"K={K} P={P}",
                bytes=4 * P * (9 + 5 * n_match + 9) + 9 * K,
                ops=P * n_match * OPS_REFINE,
                **measure(lambda: kk.fs2_refine(*args),
                          lambda: kk.fs2_refine_plain(*args)))


def check_k1(dev, rng, g) -> dict:
    """K1 at K = 15, P = 2^20 against pk.jacobians_planes."""
    import torch

    from slam_tpu_torch.geometry import wrap_angle
    from slam_tpu_torch.ops import planes as pk
    from slam_tpu_torch.ops.kernels import kernels as kk

    P, K = FS2_P, K_OBS
    xv, planes, _ = gathered_planes(dev, rng, g, P, K)

    def plain():
        return pk.jacobians_planes(xv[0:1], xv[1:2], xv[2:3], *planes,
                                   *pk.sym2_host(R))
    got, want = kk.jacobians(xv, *planes, R), plain()
    torch.cuda.synchronize()
    err = 0.0
    for name, a, b in zip(got._fields, got, want):
        b = b.expand_as(a)
        if name == "zb":
            a, b = wrap_angle(a - b), torch.zeros_like(a)
        torch.testing.assert_close(a, b, **TOL)
        err = max(err, max_abs_err([a], [b]))
    del got, want
    return dict(max_abs_err=err, shape=f"K={K} P={P}",
                bytes=4 * P * (3 + 5 * K + 13 * K), ops=K * P * OPS_JACOBIAN,
                **measure(lambda: kk.jacobians(xv, *planes, R), plain))


def dense200():
    from slam_tpu_torch.config import SlamConfig
    from slam_tpu_torch.maps import read_map_file
    return SlamConfig.from_ini(INI), read_map_file(MAP)


def fs2_webmap():
    """The world of the JAX package's fastslam2_1m line without the
    reference data (bench.py:load_workload): heading unknown."""
    from slam_tpu_torch.config import SlamConfig
    from slam_tpu_torch.maps import synthetic_map
    return SlamConfig(SWITCH_HEADING_KNOWN=0), synthetic_map(35, 17,
                                                             radius=100.0)


def fs2_shapes():
    """(K, L) of slice (f): the simulator's max_obs and FastSlam2's
    landmark capacity on the fastslam2_1m world."""
    from slam_tpu_torch.models import FastSlam2
    from slam_tpu_torch.sim.simulator import Simulator
    cfg, slam_map = fs2_webmap()
    return (Simulator(cfg, slam_map).max_obs,
            FastSlam2(cfg, slam_map.n_landmarks).capacity)


def run_once(dev, kind, cfg, slam_map, P, seed, ticks):
    """One run through Runner, as a user calls it: (result, finalized
    particle state). ``kind``: "eager" (-method FASTSLAM1), "fs2"
    (-method FASTSLAM2), "deferred" (FastSlam1Deferred with K6) or
    "deferred-per-tick" (FastSlam1Deferred with the per-tick predict).
    No device is named: everything must come to lie on the card ``dev``
    by default."""
    import torch

    from slam_tpu_torch.models import FastSlam1Deferred
    from slam_tpu_torch.runtime import Runner
    if kind in ("eager", "fs2"):
        method = "FASTSLAM2" if kind == "fs2" else "FASTSLAM1"
        runner = Runner(cfg, slam_map, method, n_particles=P)
    else:
        est = FastSlam1Deferred(cfg, slam_map.n_landmarks,
                                fused_predict=kind == "deferred")
        runner = Runner(cfg, slam_map, "FASTSLAM1", n_particles=P,
                        estimator=est)
    result = runner.run(seed=seed, n_ticks=ticks)
    final = (runner.est.finalize(result.final_state)
             if hasattr(runner.est, "finalize") else result.final_state)
    on_card = [runner.device, runner.est.device, runner.sim.device,
               runner.sim.landmarks.device,
               *(t.device for t in final if isinstance(t, torch.Tensor))]
    check(all(d.type == "cuda" and (d.index or 0) == (dev.index or 0)
              for d in on_card),
          f"{kind}: with no device named the run is not on {dev}: "
          f"{sorted({str(d) for d in on_card})}")
    return result, final


def run_slice(dev, name, world, kind, P, ticks, anchor, on, off=(),
              per_superstep=()) -> dict:
    """Phase 4: three seeds at P particles. Checks the traces, the final
    state, the kernels each run launched (reset before it, read after
    it), and the 3-seed RMS ATE against twice the JAX anchor.
    ``per_superstep``: kernels that must launch exactly once per
    superstep."""
    import numpy as np
    import torch

    from slam_tpu_torch.ops import kernels
    from slam_tpu_torch.runtime import compute_metrics

    cfg, slam_map = world
    T = ticks // cfg.steps_per_observe
    ates, rates, syncs = [], [], []
    total = dict.fromkeys(kernels.WRAPPERS, 0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for seed in SEEDS:
        kernels.reset_launch_counts()
        result, fs = run_once(dev, kind, cfg, slam_map, P, seed, ticks)
        counts = kernels.launch_counts()
        m = compute_metrics(result)
        check(result.est_pose.shape == (T, 3),
              f"{name}: est_pose shape {result.est_pose.shape}")
        check(np.isfinite(result.est_pose).all(), f"{name}: non-finite pose")
        check(fs.lm.shape[-1] == P and fs.lm.shape[0] == 2,
              f"{name}: landmark planes {tuple(fs.lm.shape)}")
        check(bool(torch.isfinite(fs.logw).all()),
              f"{name}: non-finite weights")
        check(int(fs.n) > 0, f"{name}: no landmark was mapped")
        check(math.isfinite(m.ate_rmse), f"{name}: non-finite ATE")
        for k in on:
            check(counts[k] > 0, f"{name} seed {seed}: {k} was never "
                  f"launched {counts}")
        for k in off:
            check(counts[k] == 0, f"{name} seed {seed}: {k} should not "
                  f"run {counts}")
        for k in per_superstep:
            check(counts[k] == T, f"{name} seed {seed}: {k} launched "
                  f"{counts[k]} times in {T} supersteps")
        total = {k: total[k] + counts[k] for k in total}
        ates.append(m.ate_rmse)
        rates.append(m.steps_per_second)
        syncs.append(m.host_syncs_per_superstep)
        print(f"  {name} P={P} seed={seed}: {m.summary()} {counts}",
              flush=True)
        # Free this run's state before the next, so that the peak is one
        # run's.
        del result, fs
    rms = float(np.sqrt(np.mean(np.square(ates))))
    ate_bound = ATE_MARGIN * anchor
    check(rms < ate_bound, f"{name}: RMS ATE {rms} >= {ate_bound}")
    summary = dict(P=P, ate_rmse_3seed=rms, ates=ates, steps_per_s=rates,
                   host_syncs_per_superstep=syncs, launches=total,
                   launches_per_superstep={
                       k: n / (len(SEEDS) * T) for k, n in total.items()
                       if n},
                   ate_bound=ate_bound,
                   peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                   seconds=time.perf_counter() - t0)
    print(f"slice {name}: {json.dumps(summary)}", flush=True)
    return summary


def run_config5_slice(dev, name, P, capacity, n_supersteps, seeds,
                      filter_anchor=None, refined_anchor=None,
                      on=()) -> dict:
    """Phase 4, BASELINE config #5 composed: run_config5 per seed, no
    device named. Checks each result as tests/test_config5.py does
    (keyframes, map, finite errors, the refinement within max(2
    ATE_filter, 0.15), a BA iteration), the kernels each run launched
    (reset before it, read after it: K6 and one of K5 or K4 per
    superstep, the kernels in ``on`` at least once, none of the others)
    and its host syncs (the gate, once per superstep; BA's reads are
    its own), the peak device memory (the filter's state lies on the
    card), and the 3-seed RMS ATEs against twice the JAX anchors given."""
    import numpy as np
    import torch

    from slam_tpu_torch.models import rbpf
    from slam_tpu_torch.ops import kernels
    from slam_tpu_torch.runtime.config5 import run_config5

    total = dict.fromkeys(kernels.WRAPPERS, 0)
    results = []
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for seed in seeds:
        kernels.reset_launch_counts()
        syncs = rbpf.host_bool.count
        r = run_config5(n_particles=P, capacity=capacity,
                        n_supersteps=n_supersteps, seed=seed)
        syncs = rbpf.host_bool.count - syncs
        counts = kernels.launch_counts()
        check(r.n_keyframes == n_supersteps and r.n_landmarks_map
              == C5_LANDMARKS and r.n_landmarks_observed > 50,
              f"{name} seed {seed}: {r}")
        check(all(math.isfinite(v) for v in (r.ate_filter, r.ate_refined,
                                             r.ba_seconds)),
              f"{name} seed {seed}: non-finite result {r}")
        check(r.ate_refined < max(2.0 * r.ate_filter, 0.15),
              f"{name} seed {seed}: refined ATE {r.ate_refined} against "
              f"the filter's {r.ate_filter}")
        check(r.ba_iters >= 1, f"{name} seed {seed}: no BA iteration")
        check(counts["K6"] == n_supersteps
              and counts["K5"] + counts["K4"] == n_supersteps,
              f"{name} seed {seed}: launches {counts} in {n_supersteps} "
              "supersteps")
        for k in on:
            check(counts[k] > 0, f"{name} seed {seed}: {k} was never "
                  f"launched {counts}")
        for k in ("K2", "G1", "K3", "K6b", "K1"):
            check(counts[k] == 0, f"{name} seed {seed}: {k} should not "
                  f"run {counts}")
        check(syncs == n_supersteps, f"{name} seed {seed}: {syncs} gate "
              f"syncs in {n_supersteps} supersteps")
        total = {k: total[k] + counts[k] for k in total}
        results.append(r._asdict())
        print(f"  {name} P={P} capacity={capacity} seed={seed}: "
              f"{json.dumps(r._asdict())} {counts}", flush=True)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # 5 float32 planes per (particle, slot), on the card.
    check(peak * 2 ** 30 > 20 * P * capacity,
          f"{name}: peak device memory {peak} GiB; the run was not on "
          "the card")

    def rms(key):
        return float(np.sqrt(np.mean([r[key] ** 2 for r in results])))
    summary = dict(
        P=P, capacity=capacity, supersteps=n_supersteps, seeds=list(seeds),
        ate_filter=rms("ate_filter"), ate_refined=rms("ate_refined"),
        results=results, launches=total,
        launches_per_superstep={k: n / (len(seeds) * n_supersteps)
                                for k, n in total.items() if n},
        host_syncs_per_superstep=1.0, peak_gib=peak,
        seconds=time.perf_counter() - t0)
    for key, anchor in (("ate_filter", filter_anchor),
                        ("ate_refined", refined_anchor)):
        if anchor is not None:
            summary[f"{key}_bound"] = ATE_MARGIN * anchor
            check(summary[key] < ATE_MARGIN * anchor,
                  f"{name}: RMS {key} {summary[key]} >= "
                  f"{ATE_MARGIN * anchor}")
    print(f"slice {name}: {json.dumps(summary)}", flush=True)
    return summary


def check_ba_10k(dev, card: str) -> dict:
    """Phase 11: the ba_10k line on the card. solve_ba_device on
    make_ba_problem(256, 10_000), no device named, then from the truth
    (the MAP floor); bench.py's quality checks, the error within
    BA_ERR_MARGIN of the JAX package's, a bit-identical replay, no
    kernel launched; the profile of a solve (profiling.profile_ba) and
    the Schur product against its bound."""
    import dataclasses

    import numpy as np
    import torch

    from slam_tpu_torch.models.ekf import full_f32
    from slam_tpu_torch.ops import kernels
    from slam_tpu_torch.posegraph import solve_ba_device
    from slam_tpu_torch.posegraph.synthetic import make_ba_problem
    from slam_tpu_torch.runtime.profiling import (
        ba_products,
        device_ms,
        profile_ba,
    )

    t0 = time.perf_counter()
    prob, poses, poses0, lms = make_ba_problem(*BA10K_SHAPE)
    check(prob.poses0.device.type == "cuda",
          f"ba-10k: with no device named the problem is on "
          f"{prob.poses0.device}")
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    p, _, info = solve_ba_device(prob, iters=BA10K_ITERS, return_info=True)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    def mean_err(q):
        return float(np.linalg.norm(q[:, :2].cpu().numpy() - poses[:, :2],
                                    axis=1).mean())
    err_init = float(np.linalg.norm(poses0[:, :2] - poses[:, :2],
                                    axis=1).mean())
    err = mean_err(p)
    prob_t = dataclasses.replace(
        prob, poses0=torch.tensor(poses, device=dev),
        landmarks0=torch.tensor(lms, device=dev))
    floor = mean_err(solve_ba_device(prob_t, iters=BA10K_ITERS)[0])
    check(err < 0.2 * err_init, f"ba-10k: error {err} >= 0.2 x {err_init}")
    check(err < max(1.25 * floor, 0.05),
          f"ba-10k: error {err} against the MAP floor {floor}")
    check(abs(err - JAX_BA10K_ERR_M) <= BA_ERR_MARGIN * JAX_BA10K_ERR_M,
          f"ba-10k: error {err}, the JAX package's {JAX_BA10K_ERR_M}")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    p2, _, info2 = solve_ba_device(prob, iters=BA10K_ITERS,
                                   return_info=True)
    end.record()
    torch.cuda.synchronize()
    check(torch.equal(p, p2) and info2["n_steps"] == info["n_steps"],
          "ba-10k: a second solve gave other poses or trials")
    prof = profile_ba(prob, solve_ba_device, BA10K_ITERS, top=8)
    counts = kernels.launch_counts()
    check(not any(counts.values()), f"ba-10k: kernels launched {counts}")

    W, WA, S = ba_products(prob)
    with full_f32():
        ms = min(cuda_ms(lambda: WA @ W.T), cuda_ms(lambda: WA @ W.T))
        dev_ms = device_ms(lambda: WA @ W.T)
    rows, cols = W.shape
    ops, nbytes = 2.0 * rows * rows * cols, 4.0 * (2 * rows * cols
                                                   + rows * rows)
    b_ms, by = bound(nbytes, ops)
    schur = dict(shape=f"[{rows}, {cols}] x [{cols}, {rows}]", ms=ms,
                 device_ms=dev_ms, ops=ops, bytes=nbytes, bound_ms=b_ms,
                 bound_by=by, share=b_ms / ms)
    out = dict(err_init=err_init, err=err, map_floor=floor,
               jax_err=JAX_BA10K_ERR_M, n_steps=info["n_steps"],
               n_accepted=info["n_accepted"], host_reads=info["host_reads"],
               events_ms_per_trial=start.elapsed_time(end) / info["n_steps"],
               first_solve_s=first_s, peak_gib=peak, replay="bit-identical",
               profile=prof, schur=schur,
               seconds=time.perf_counter() - t0, card=card)
    print(f"ba-10k: {json.dumps(out)}", flush=True)
    del W, WA, S
    torch.cuda.empty_cache()
    return out


def check_deferred_vs_eager(dev) -> str:
    """Phase 5: the deferred path with the per-tick predict against the
    eager path; returns "bit-identical" or "within 1e-4"."""
    import numpy as np
    import torch

    from slam_tpu_torch.models.particles import FIELDS

    world = dense200()
    (r_e, f_e), (r_d, f_d) = (
        run_once(dev, kind, *world, P_LARGE, SEEDS[0], 400)
        for kind in ("eager", "deferred-per-tick"))
    same = np.array_equal(r_d.est_pose, r_e.est_pose) and all(
        torch.equal(getattr(f_d, f), getattr(f_e, f)) for f in FIELDS)
    if not same:
        np.testing.assert_allclose(r_d.est_pose, r_e.est_pose, **TOL_PATHS)
        for f in FIELDS:
            torch.testing.assert_close(getattr(f_d, f), getattr(f_e, f),
                                       **TOL_PATHS)
    held = "bit-identical" if same else "within rtol/atol 1e-4"
    print(f"deferred (per-tick predict) vs eager, P={P_LARGE} "
          f"seed={SEEDS[0]} 400 ticks: {held}", flush=True)
    return held


def check_replay(dev) -> None:
    """Phase 6: a seed replays bit for bit on the card, on the eager and
    deferred FastSLAM 1 paths and on slice (f)."""
    import numpy as np

    for kind, world, P, ticks in (("eager", dense200(), P_LARGE, 400),
                                  ("deferred", dense200(), P_LARGE, 400),
                                  ("fs2", fs2_webmap(), FS2_P, FS2_TICKS)):
        poses = [run_once(dev, kind, *world, P, SEEDS[0],
                          ticks)[0].est_pose for _ in range(2)]
        if not np.array_equal(poses[0], poses[1]):
            raise AssertionError(f"replay ({kind}): the same seed gave "
                                 "other estimates")
        print(f"replay {kind} P={P} seed={SEEDS[0]}: bit-identical",
              flush=True)


def ekf10k():
    """The world of the JAX package's ekf_10k line: config #5's map with
    capacity for all 10k landmarks."""
    from slam_tpu_torch.runtime.config5 import config5_setup
    return config5_setup(EKF10K_LANDMARKS, capacity=EKF10K_LANDMARKS,
                         max_obs=C5_MAX_OBS)


def ekf_runner(world, sharded: bool):
    """A Runner of the EKF as a user builds it, no device named: EKF1,
    the default method, or ShardedEkfSlam as the ekf_10k line runs it."""
    from slam_tpu_torch.runtime import Runner
    cfg, slam_map = world
    if not sharded:
        return Runner(cfg, slam_map)
    from slam_tpu_torch.parallel.ekf import ShardedEkfSlam
    return Runner(cfg, slam_map, "EKF1",
                  estimator=ShardedEkfSlam(cfg, slam_map.n_landmarks))


@contextlib.contextmanager
def syncs_raise(runner, T: int):
    """Run the supersteps under torch.cuda.set_sync_debug_mode("error"),
    from the first predict to the end of update ``T``: any device-to-host
    sync in the loop (an .item(), a bool of a tensor, a boolean-mask
    index, a checked factorization) raises. Yields [updates done]."""
    import torch

    est = runner.est
    predict, update = est.predict, est.update
    done = [0]

    def guarded_predict(*args, **kw):
        torch.cuda.set_sync_debug_mode("error")
        return predict(*args, **kw)

    def guarded_update(*args, **kw):
        out = update(*args, **kw)
        done[0] += 1
        if done[0] == T:
            torch.cuda.set_sync_debug_mode(0)
        return out

    est.predict, est.update = guarded_predict, guarded_update
    try:
        yield done
    finally:
        torch.cuda.set_sync_debug_mode(0)
        del est.predict, est.update


def on_card(dev, runner, tensors) -> list:
    """Devices of the runner, its estimator and simulator and the given
    tensors that are not the card ``dev``."""
    devices = [runner.device, runner.est.device, runner.sim.device,
               runner.sim.landmarks.device, *(t.device for t in tensors)]
    return sorted({str(d) for d in devices
                   if d.type != "cuda" or (d.index or 0) != (dev.index or 0)})


def run_ekf_slice(dev, name, world, sharded, ticks, seeds, anchor,
                  window) -> dict:
    """Phase 7: an EKF slice through Runner, no device named. Each seed
    runs with syncs raising; none of the nine kernels may launch; the
    runner, simulator, estimator and final state must be on the card;
    the RMS ATE over the seeds finite and below twice the JAX anchor.
    Then one run profiled over ``window`` (warm-up, measured supersteps)
    gives the device time per superstep."""
    import numpy as np
    import torch

    from slam_tpu_torch.ops import kernels
    from slam_tpu_torch.runtime import compute_metrics
    from slam_tpu_torch.runtime.profiling import profile_runner

    cfg, _ = world
    T = ticks // cfg.steps_per_observe
    ates, rates = [], []
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for seed in seeds:
        runner = ekf_runner(world, sharded)
        kernels.reset_launch_counts()
        with syncs_raise(runner, T) as done:
            result = runner.run(seed=seed, n_ticks=ticks)
        counts = kernels.launch_counts()
        fs = result.final_state
        m = compute_metrics(result)
        check(done[0] == T, f"{name}: {done[0]} of {T} updates ran")
        check(result.host_syncs == 0,
              f"{name} seed {seed}: {result.host_syncs} host syncs")
        check(not any(counts.values()),
              f"{name} seed {seed}: kernels launched {counts}")
        away = on_card(dev, runner, [t for t in fs
                                     if isinstance(t, torch.Tensor)])
        check(not away, f"{name}: with no device named the run is not on "
              f"{dev}: {away}")
        check(result.est_pose.shape == (T, 3),
              f"{name}: est_pose shape {result.est_pose.shape}")
        check(np.isfinite(result.est_pose).all(), f"{name}: non-finite pose")
        check(int(fs.n) > 0, f"{name}: no landmark was mapped")
        check(math.isfinite(m.ate_rmse), f"{name}: non-finite ATE")
        ates.append(m.ate_rmse)
        rates.append(m.steps_per_second)
        print(f"  {name} seed={seed}: {m.summary()} n={int(fs.n)}",
              flush=True)
        del result, fs, runner
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    seconds = time.perf_counter() - t0
    rms = float(np.sqrt(np.mean(np.square(ates))))
    ate_bound = ATE_MARGIN * anchor
    check(rms < ate_bound, f"{name}: RMS ATE {rms} >= {ate_bound}")
    prof = profile_runner(ekf_runner(world, sharded), *window,
                          seed=seeds[0], top=6)
    check(prof["host_syncs_per_superstep"] == 0
          and not prof["launches_per_superstep"],
          f"{name}: profiled window {prof['host_syncs_per_superstep']} "
          f"syncs, launches {prof['launches_per_superstep']}")
    summary = dict(seeds=list(seeds), ate_rmse=rms, ates=ates,
                   steps_per_s=rates, host_syncs_per_superstep=0,
                   launches=dict.fromkeys(kernels.WRAPPERS, 0),
                   launches_per_superstep={}, ate_bound=ate_bound,
                   peak_gib=peak, seconds=seconds, profile=prof)
    print(f"slice {name}: {json.dumps(summary)}", flush=True)
    return summary


def check_sharded_vs_dense() -> dict:
    """Phase 8: the port's ShardedEkfSlam against its EkfSlam on the card,
    on the JAX test's world (tests/test_parallel_ekf.py:38-57), at its
    tolerances."""
    import numpy as np

    from slam_tpu_torch.config import SlamConfig
    from slam_tpu_torch.maps import synthetic_map
    from slam_tpu_torch.parallel.ekf import dense_covariance

    slam_map = synthetic_map(16, 12, radius=40.0, seed=7)
    cfg = SlamConfig(SWITCH_HEADING_KNOWN=1, max_landmarks=16)
    world = (cfg, slam_map)
    res_d = ekf_runner(world, sharded=False).run(seed=5, n_ticks=240)
    res_s = ekf_runner(world, sharded=True).run(seed=5, n_ticks=240)
    d, s = res_d.final_state, res_s.final_state
    Pd = d.P.cpu().numpy()
    Ps = dense_covariance(s).cpu().numpy()
    errs = dict(pose=float(np.abs(res_s.est_pose - res_d.est_pose).max()),
                cov=float(np.abs(Ps - Pd).max()),
                pose_block=float(np.abs(Ps[:3, :3] - Pd[:3, :3]).max()),
                x=float((s.x - d.x).abs().max()))
    check(int(s.n) == int(d.n) > 0, f"sharded n {int(s.n)}, dense {int(d.n)}")
    for key, tol in (("pose", TOL_SHARDED_POSE), ("cov", TOL_SHARDED_COV),
                     ("pose_block", TOL_SHARDED_P00),
                     ("x", TOL_SHARDED_POSE)):
        check(errs[key] <= tol, f"sharded vs dense: {key} {errs[key]} > "
              f"{tol}")
    print(f"sharded vs dense EKF, 16 landmarks, 240 ticks, seed 5: "
          f"{json.dumps(errs)}, n = {int(s.n)}", flush=True)
    return errs


def check_tf32_held_off(dev) -> dict:
    """Phase 9: two supersteps of ekf-10k with the caller's
    torch.backends.cuda.matmul.allow_tf32 True, then False: bit-equal
    states. As a control, one product at the Pmm pass's shapes, outside
    the estimator, under each setting."""
    import torch

    from slam_tpu_torch.parallel.ekf import sharded_state_to_numpy

    world = ekf10k()
    runs = []
    try:
        for tf32 in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            result = ekf_runner(world, sharded=True).run(
                seed=SEEDS[0], n_ticks=2 * world[0].steps_per_observe)
            runs.append((result.est_pose,
                         sharded_state_to_numpy(result.final_state)))
            del result
        g = torch.Generator(device=dev).manual_seed(0)
        W = torch.randn((2 * EKF10K_LANDMARKS, 2 * C5_MAX_OBS + 8),
                        generator=g, device=dev)
        bare = []
        for tf32 in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            bare.append(W[:1024] @ W.T)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    import numpy as np
    (pose_t, st_t), (pose_f, st_f) = runs
    same = np.array_equal(pose_t, pose_f) and all(
        np.array_equal(st_t[f], st_f[f]) for f in st_t)
    check(same, "ekf-10k: TF32 allowed by the caller changed the result")
    control = not torch.equal(bare[0], bare[1])
    out = dict(bit_equal=same, n=int(st_f["n"]),
               tf32_changes_a_bare_product=control)
    print(f"TF32 held off (ekf-10k, 2 supersteps): {json.dumps(out)}",
          flush=True)
    return out


def time_pmm_pass(dev) -> dict:
    """The one pass over Pmm at ekf-10k's shapes, as the update runs it:
    Pmm -= W W' in place, W [2L, 2K + 8] (the batch update's 2K columns
    and a superstep's 8 deferred heading terms). Bound: 2 (2L)^2 (2K + 8)
    operations at the float32 rate, against 2 (2L)^2 x 4 bytes."""
    import torch

    from slam_tpu_torch.models.ekf import full_f32
    from slam_tpu_torch.runtime.profiling import device_ms

    L2, k = 2 * EKF10K_LANDMARKS, 2 * C5_MAX_OBS + 8
    g = torch.Generator(device=dev).manual_seed(0)
    Pmm = torch.zeros((L2, L2), device=dev)
    W = torch.randn((L2, k), generator=g, device=dev) * 1e-3

    def fn():
        Pmm.addmm_(W, W.T, alpha=-1.0)
    with full_f32():
        ms = min(cuda_ms(fn), cuda_ms(fn))
        dev_ms = device_ms(fn)
    ops, nbytes = 2.0 * L2 * L2 * k, 2.0 * 4 * L2 * L2 + 4.0 * L2 * k
    b_ms, by = bound(nbytes, ops)
    out = dict(shape=f"[{L2}, {L2}] -= [{L2}, {k}] [{k}, {L2}]", ms=ms,
               device_ms=dev_ms, ops=ops, bytes=nbytes, bound_ms=b_ms,
               bound_by=by, share=b_ms / ms)
    print(f"ekf-10k Pmm pass: {json.dumps(out)}", flush=True)
    del Pmm, W
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this smoke test needs an NVIDIA GPU")
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)

    from slam_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    lib_path = build.build_library()
    build.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {lib_path.name}",
          flush=True)

    # Compiled before the timed phase, not beside it: some kernels' times
    # are host-bound.
    k4_regs = ptxas_registers("fused_update.cu")
    t0 = time.perf_counter()
    kernel_stats = check_kernels(dev)
    print(f"kernels: {time.perf_counter() - t0:.1f} s", flush=True)
    fast_math = check_fast_math(dev)
    sass = sass_counts(lib_path)
    for name, st in kernel_stats.items():
        b_ms, by = bound(st["bytes"], st["ops"])
        st.update(bound_ms=b_ms, bound_by=by, share=b_ms / st["ms"])
        k4_map = ""
        if name.split()[0] == "K4":
            T = st["threads_per_particle"]
            (regs, spill), = [v for n, v in k4_regs.items()
                              if f"fs1_fused_update_kernelILi{T}E" in n]
            st.update(registers=regs, spill_store_bytes=spill)
            k4_map = (f", share of device time "
                      f"{b_ms / (st['device_ms'] or st['ms']):.3f}; "
                      f"{T} threads per particle, chunk {st['chunk']}, "
                      f"{regs} registers, {spill} bytes spilled")
        if name in sass:
            st.update(issue_bound(st, sass[name]))
            print(f"kernel {name}: issue bound {st['issue_bound_ms']:.4f} ms "
                  f"(share {st['issue_share']:.3f}) from {sass[name]} at "
                  f"{st['sm_clock_mhz']:.0f} MHz", flush=True)
        lib = ("" if st["library_ms"] is None else
               f", library {st['library_ms']:.4f} ms (device "
               f"{st['library_device_ms']})")
        print(f"kernel {name} ({st['shape']}): {st['ms']:.4f} ms (device "
              f"{st['device_ms']}), plain {st['plain_ms']:.4f} ms, bound "
              f"{b_ms:.4f} ms by {by} ({st['bytes']:.4g} B, "
              f"{st['ops']:.4g} ops), share {st['share']:.3f}{lib}{k4_map}, "
              f"max_abs_err {st['max_abs_err']:.3g} [{card}]", flush=True)
    torch.cuda.empty_cache()

    small = run_slice(dev, "eager-small", dense200(), "eager", P_SMALL,
                      TICKS, JAX_ANCHOR_ATE_M, on=("K2", "G1"),
                      off=("K4", "K5", "K6", "G2", "K3", "K6b", "K1"),
                      per_superstep=("K2",))
    check(all(s == 1 for s in small["host_syncs_per_superstep"]),
          "eager-small: host syncs per superstep "
          f"{small['host_syncs_per_superstep']}")
    large = run_slice(dev, "eager-large", dense200(), "eager", P_LARGE,
                      TICKS, JAX_ANCHOR_ATE_M, on=("K4", "G2"),
                      off=("K2", "K5", "K6", "G1", "K3", "K6b", "K1"))
    c5 = run_config5_slice(dev, "config5", C5_P, C5_CAPACITY,
                           C5_SUPERSTEPS, SEEDS, JAX_CONFIG5_ATE_M,
                           JAX_CONFIG5_REFINED_ATE_M, on=("K5", "G2"))
    c5_points = {name: run_config5_slice(dev, name, P, cap, n, SEEDS[:1])
                 for name, P, cap, n in C5_POINTS}
    torch.cuda.empty_cache()
    deferred = run_slice(dev, "deferred-large", dense200(), "deferred",
                         P_LARGE, TICKS, JAX_ANCHOR_ATE_M, on=("K5", "K6"),
                         off=("K2", "G1", "K3", "K6b", "K1"))
    fs2_small = run_slice(dev, "fs2-small", dense200(), "fs2", P_SMALL,
                          TICKS, JAX_FS2_ANCHOR_ATE_M, on=("K3", "K2", "G1"),
                          off=("K4", "K6b", "G2", "K5", "K6", "K1"),
                          per_superstep=("K2",))
    check(all(s == 1 for s in fs2_small["host_syncs_per_superstep"]),
          "fs2-small: host syncs per superstep "
          f"{fs2_small['host_syncs_per_superstep']}")
    from slam_tpu_torch.sim.simulator import Simulator
    print(f"fs2-1m world: max_obs K = {Simulator(*fs2_webmap()).max_obs}",
          flush=True)
    fs2_1m = run_slice(dev, "fs2-1m", fs2_webmap(), "fs2", FS2_P,
                       FS2_TICKS, JAX_FS2_WEBMAP_ATE_M,
                       on=("K6b", "K3", "K4", "G2"),
                       off=("K2", "G1", "K5", "K6", "K1"),
                       per_superstep=("K6b",))
    check(all(s == 1 for s in fs2_1m["host_syncs_per_superstep"]),
          "fs2-1m: host syncs per superstep "
          f"{fs2_1m['host_syncs_per_superstep']}")
    check_deferred_vs_eager(dev)
    check_replay(dev)

    ekf_webmap = run_ekf_slice(dev, "ekf-webmap", fs2_webmap(), False,
                               TICKS, EKF_WEBMAP_SEEDS, JAX_EKF_WEBMAP_ATE_M,
                               window=(80, 40))
    ekf_dense200 = run_ekf_slice(dev, "ekf-dense200", dense200(), False,
                                 TICKS, SEEDS, JAX_EKF_DENSE200_ATE_M,
                                 window=(150, 40))
    ekf_10k = run_ekf_slice(dev, "ekf-10k", ekf10k(), True, EKF10K_TICKS,
                            SEEDS, JAX_EKF_10K_ATE_M, window=(16, 16))
    check_sharded_vs_dense()
    check_tf32_held_off(dev)
    time_pmm_pass(dev)
    torch.cuda.empty_cache()
    check_ba_10k(dev, card)

    # Main-path launches of each kernel: the sum of the counts of the
    # phase-4 runs. K1 lies on no path (the JAX package calls it only
    # from tests); every slice checks that it stayed at 0. The error is
    # the largest over a kernel's checks (K4 and G2 at two shapes each);
    # the times are those of its first check.
    slices = dict(zip(("eager-small", "eager-large", "config5",
                       "deferred-large", "fs2-small", "fs2-1m"),
                      (small, large, c5, deferred, fs2_small, fs2_1m)))
    slices.update(c5_points)
    # The slices that launch none of the nine kernels (ba-10k: checked in
    # its phase).
    ekf_slices = {"ekf-webmap": ekf_webmap, "ekf-dense200": ekf_dense200,
                  "ekf-10k": ekf_10k}
    slices.update(ekf_slices)
    ekf_slices["ba-10k"] = None
    launches = {k: sum(s["launches"][k] for s in slices.values())
                for k in KERNELS}
    errs = {k: max(st["max_abs_err"] for n, st in kernel_stats.items()
                   if n.split()[0] == k) for k in KERNELS}
    fields = ("ms", "plain_ms", "device_ms", "bound_ms", "bound_by",
              "share", "bytes", "ops", "library_ms", "library_device_ms",
              "shape")
    table = []
    for name in ("K1", "K2", "K3", "K4", "K5", "K6", "K6b", "G1", "G2"):
        st = kernel_stats[name]
        row = dict(name=name, route="cuda", source=KERNELS[name][0],
                   replaces=KERNELS[name][1], launches=launches[name],
                   launches_per_superstep={
                       **{sl: s["launches_per_superstep"][name]
                          for sl, s in slices.items()
                          if name in s["launches_per_superstep"]},
                       **dict.fromkeys(ekf_slices, 0)},
                   max_abs_err=errs[name], **{f: st[f] for f in fields})
        if name == "K2":
            row.update({f: st[f] for f in (
                "k4_ms", "k4_device_ms", "ragged_P", "ragged_ms",
                "ragged_device_ms", "ragged_k4_ms", "ragged_k4_device_ms")})
        if name == "K4":
            row.update(chunk=st["chunk"], shapes=[
                {f: s[f] for f in ("shape", "ms", "device_ms", "bound_ms",
                                   "threads_per_particle", "registers",
                                   "spill_store_bytes")}
                for n, s in kernel_stats.items() if n.split()[0] == "K4"])
        if name == "K5":
            row.update({f: st[f] for f in ("direct_ms", "direct_device_ms",
                                           "distinct", "live_sectors",
                                           "staged_tiles")})
        if name in sass:
            row.update({f: st[f] for f in ("issue_bound_ms", "issue_share",
                                           "sass", "sm_clock_mhz")},
                       fast_math_sweep=fast_math)
        table.append(row)
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": table}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
