#!/usr/bin/env python3
"""Smoke test of slam_tpu_torch, the PyTorch / CUDA port, on one NVIDIA
GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. Device: a CUDA card is required; prints its name and power limit
   (nvidia-smi) and turns TF32 off.
2. Build: compiles the CUDA kernels from slam_tpu_torch/csrc.
3. Kernels against their plain PyTorch twins on the card: first the
   bench's gate (slam_tpu_torch.ops.kernels.selfcheck.run: each kernel
   once at the shapes the bench lines give it), then at the shapes the
   main paths give them: K2 (K=15, L=200, P=100, by slot; and on
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
   slots; K1 (K=15, P=2^20); S1, the simulator's control ticks, over a
   4000-tick drive of the webmap world (500 launches of T=8) and timed
   at T=8, its latency from its device times at T=64 and T=256; E1, the
   block EKF's predict tick, at ekf-10k's shapes (L=10,000, D=16) on
   both arms of the heading against its twin run in float64 (each
   output's error at most twice the eager float32 code's), timed beside
   the twin (the eager code, ~77 launches), with its wrapper's host time
   a call and the estimator's whole predict call by the host clock; F2,
   FastSLAM 2's predict tick with the heading known, at P=2^17 and
   2^17 + 37 on both arms of the heading and of the noise, Pv zero and
   not, and across +-pi, timed on the heading-known, noise-off arm
   beside its twin (the eager tick, ~195 launches), with the same two
   host times; R1, a fired resample's offspring bounds, at P=2^20 and
   2^17 on every kind of selfcheck.bounds_inputs (prefix sums that dip
   at the twin's row edges and R1's tile edges among them), bit-equal to
   its twin, and timed beside it and beside torch.cummax on the same
   unscanned bounds (the port's eager form before R1; library_ms).
   Gathers, K6, K6b, F2 and S1 must be bit-equal to their twins (the
   predicts and S1 keep the twins' operation order, and the sweep below
   holds the predicts' sincosf and the fast wrap to sinf, cosf and the
   fmodf wrap on every float32 bit pattern); the other float outputs
   within rtol 1e-5, atol 1e-5 (the kernels
   sum over k in another order than the twins, and the device libm
   rounds sin/cos/log differently from torch's), K3 within the JAX
   package's golden tolerances of the refinement (xv rtol 1e-4, atol
   1e-5; Pv rtol 1e-3, atol 1e-6), as its chain over K observations
   compounds rounding; headings (and K1's bearings) are compared
   wrapped, as one ulp at +-pi flips a wrapped value by 2 pi. K5 must
   also be bit-equal to G2's gather followed by K4 with its empty rows
   zeroed (the same operation order), and its two load branches (staged through shared memory, and
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
   counters are reset before each run and read after it (in every run
   of this and the later phases S1 launches once per superstep):
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
       K3, K2 once per superstep, F2 once per tick and G1, and not K4,
       K6b, G2, K5 or K6; one host sync per superstep;
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
   the nine estimator kernels (S1 once per superstep; E1, in (i) alone,
   once per tick), leaves the
   runner, simulator, estimator and final state on the card, and must
   reach an RMS ATE below twice the JAX
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
12. (k) ckpt-deferred: FastSlam1Deferred on dense200 at P = 131,072,
   seed 3, through Runner.run_checkpointed: unbroken to superstep 200,
   then interrupted at a superstep after the first sighting (137) where
   a resample is pending (read from the unbroken run's updates) and
   resumed with resume=True. The traces, est_pose, true_pose and the
   final DeferredState (every plane, S, n, da_table, pending) must be
   bit-equal; the boundaries after superstep 137 (at least two) and the
   pending one are printed; K4, K5, K6 and G2 must launch, and K5 again
   right after the resume. Prints the checkpoint's bytes (file and
   state), every save's and load's seconds, and the walls of the runs.
13. (l) ckpt-small: slices (a) (FS1, P = 100: K2, G1) and (h) (EKF1,
   heading known: cuBLAS, cuSOLVER) checkpointed in chunks of 50,
   unbroken to 200 and resumed from 150, bit-equal; then run_resilient
   on (a) with one failure injected after the first chunk must end as
   the clean run.
14. (m) stream: run_streaming of (a) and (h), 160 supersteps, into an
   in-process socket that checks every message by the rules of
   tests/test_telemetry.py's StrictController with the port's
   decode_message (no libzmq needed): the setup first, one turn per
   superstep, the clouds (a) or the ellipses (h) there; the same run
   headless must equal Runner.run bit for bit. Prints steps/s of run,
   of the headless stream and of the stream with telemetry, and the
   host reads per superstep.
15. (n) CLI: python -m slam_tpu_torch -m data/dense200.mat -method
   FASTSLAM1 -ckpt DIR/run at 1200 ticks, then at 1600 with -profile
   DIR2 (it resumes): the checkpoint's superstep and the supersteps
   reported must follow, and the trace must name K2 and G1
   (fs1_observe_kernel, gather_kernel). Then time_phases on slice (a).
16. The sharded filters (slam_tpu_torch.parallel), in one NCCL process
   group of one rank (init_distributed with no device named; the card's
   machine holds one H100, and NCCL runs one rank per device): K4's
   cross-shard weight arm at K=96, L=192, P=2^20 bit-equal to the
   in-place K4 and within TOL of its twin's arm (the planes, and the
   weights' delta), timed beside it; then through Runner, no device
   named, one host sync per superstep each: (o) sharded-fs1,
   ShardedFastSlam1 on (b)'s world and P (K4 and G2, K4 once per
   superstep), (p) sharded-fs2-small, ShardedFastSlam2 on (e)'s (K3, K2
   once per superstep, G1), (q) sharded-lm-config5,
   LandmarkShardedFastSlam1 on a (1, 1) mesh at config #5's world and
   width (capacity 192, 96 observations, P=2^20, 32 supersteps, seed 3;
   K4 with the cross-shard arm once per superstep, G2); ATEs below twice
   JAX_ANCHOR_ATE_M, JAX_FS2_ANCHOR_ATE_M and JAX_CONFIG5_ATE_M.
17. The mesh paths, in the same group (destroyed after this phase):
   K2's cross-shard weight arm at K=96 (70 matched, 20 new), L=192,
   P=1,000,000 against the in-place K2 (the line says whether bit-equal
   or within TOL) and within TOL of its twin's arm, timed beside it;
   G1 over 970 rows at P=1,000,000 bit-equal to its twin and to
   index_select, timed beside both, with its bound; then, no run naming
   a device:
   (r) ekf-10k-mesh: ShardedEkfSlam on make_mesh(1, axis="l") on (i)'s
       world, 640 ticks, seed 3, and the same run with no mesh: each
       with 0 host syncs under set_sync_debug_mode("error") and no
       kernel launched; est_pose and the final state bit-equal; ATE
       below twice JAX_EKF_10K_ATE_M;
   (s) ba-10k-mesh: solve_ba_sharded on make_ba_problem(256, 10_000),
       30 iterations, on a landmark mesh of one rank and on none: poses,
       landmarks, costs, trials and host reads equal; ms per LM trial
       beside (j)'s;
   (t) config5-mesh: run_config5() with JAX's defaults (P=1,000,000,
       (1, 1), capacity 192, 32 supersteps, seed 3), which takes
       LandmarkShardedFastSlam1 (K2 with its arm once per superstep, G1)
       and solve_ba_sharded on the one-rank landmark mesh; one host
       sync per superstep; tests/test_config5.py's checks; the filter's
       and the refined ATE below twice their JAX anchors; a replay gives
       the same errors bit for bit;
   (u) ckpt-sharded: ShardedFastSlam1 on dense200 at P=16,384 through
       run_checkpointed in chunks of 50, unbroken to superstep 200, then
       cut at 150 and resumed: one checkpoint, holding the rank's Philox
       stream, and the resumed run bit-equal (K4, G2).
18. The bench entry (slam_tpu_torch.bench), through its functions with
   no device named, at bench.py's full sizes: the primary line
   fastslam1_webmap (FastSLAM 1, P = 100, 4000 ticks, seeds 3-5, then a
   16000-tick run of seed 3: K2 and S1 once per superstep, G1 and R1,
   nothing else)
   and the ba_10k line (no kernel; bench.py's two checks); the primary
   JSON has bench.py's four keys, and each line lies within its limit
   (the ATE below twice the JAX package's mean on the same world, ticks
   and seeds; BA's error within 5 % of the JAX package's). Both lines are
   printed.

The last line is the JSON result; the two lines before it are the
kernel table (JSON: per kernel its launches on the main paths and per
superstep of each slice, error, times, bytes, operations, bound and
share of the bound) and the card's name and power limit.
"""

from __future__ import annotations

import contextlib
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time

from slam_tpu_torch.device import card_line
from slam_tpu_torch.ops.kernels import selfcheck
from slam_tpu_torch.ops.kernels.selfcheck import (
    K5_TILE,
    TOL,
    Q,
    R,
    check,
    compare_refine,
    gather_inputs,
    gathered_planes,
    k5_bounds,
    max_abs_err,
    predict_inputs,
    refine_inputs,
    update_inputs,
)
from slam_tpu_torch.runtime.anchors import (
    ATE_MARGIN,
    BA_ERR_MARGIN,
    JAX_ANCHOR_ATE_M,
    JAX_BA10K_ERR_M,
    JAX_CONFIG5_ATE_M,
    JAX_CONFIG5_REFINED_ATE_M,
    JAX_EKF_10K_ATE_M,
    JAX_EKF_DENSE200_ATE_M,
    JAX_EKF_WEBMAP_ATE_M,
    JAX_FS2_ANCHOR_ATE_M,
    JAX_FS2_WEBMAP_ATE_M,
)

MAP, INI = "data/dense200.mat", "data/dense200.ini"
TICKS, SEEDS = 2000, (3, 4, 5)
P_SMALL, P_LARGE = 100, 131072
K_OBS, CAPACITY = 15, 200
# Config #5 on one card, as the JAX package's bench_config5 runs it:
# 10k landmarks, capacity 192, at most 96 observations, 2^20 particles,
# 32 supersteps; and its cap256 and full-10k points (bench.py:499-507).
C5_LANDMARKS, C5_CAPACITY, C5_MAX_OBS = 10_000, 192, 96
C5_P, C5_SUPERSTEPS = 2 ** 20, 32
# run_config5()'s own default width, the JAX package's: 1,000,000
# particles, no multiple of 128 or 512, so on a mesh it takes K2 and G1.
C5_JAX_P = 1_000_000
# (u): the sharded checkpointed run's particle count.
P_CKPT_SHARDED = 16_384
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
TOL_PATHS = dict(rtol=1e-4, atol=1e-4)
# K5's staging width, as in csrc/resample_update.cu (kStageWidth): a
# tile of output columns (K5_TILE) is staged through shared memory when
# its ancestor run, widened to 16-byte edges, fits it.
K5_STAGE_WIDTH = 768
K5_EDGE_P = 2 ** 16
# The live slots of config5-full10k.mapped's start (800 supersteps from
# waypoint 0), for K5 at the full-10k shapes.
FULL10K_LIVE = 1469

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
OPS_TICK_SIM = 70    # S1's steering, truth, controls and odometry, a tick
OPS_COLUMN_E1 = 26   # E1's heading arm per map column (in double)
OPS_CHAIN_E1 = 300   # E1's 3x3 chain, once a block
# F2 per particle: the controls (8), fs2_terms (16 and a sincosf),
# K6b's covariance and bicycle step (OPS_TICK_FS2) and the heading
# update (three divides, two wraps, the gain and the six Joseph terms:
# ~75).
OPS_TICK_F2 = 215
# S1's drives: the 4000-tick webmap drive of its card test, T = 8 a
# launch; and the long launches whose device times give its latency.
SIM_SUPERSTEPS, SIM_LONG = 500, (64, 256)

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
    "S1": ("slam_tpu_torch/csrc/sim_control.cu",
           "none: the simulator's control ticks (sim/vehicle.py)"),
    "E1": ("slam_tpu_torch/csrc/ekf_predict.cu",
           "none: the block EKF's predict tick (parallel/ekf.py; XLA's in "
           "the JAX package)"),
    "F2": ("slam_tpu_torch/csrc/predict.cu",
           "none: FastSLAM 2's predict tick with the heading known "
           "(models/fastslam2.py; XLA's in the JAX package)"),
    "R1": ("slam_tpu_torch/csrc/offspring_bounds.cu",
           "none: a fired resample's offspring bounds (ops/resampling.py; "
           "XLA's in the JAX package)"),
}


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


def check_kernels(dev) -> dict:
    """Phase 3: every kernel against its twin at main-path shapes."""
    import numpy as np
    import torch

    from slam_tpu_torch.ops.kernels import kernels as kk

    t0 = time.perf_counter()
    gate = selfcheck.run(dev)
    print(f"kernel gate (selfcheck.run, the bench lines' shapes): "
          f"{json.dumps(gate)} in {time.perf_counter() - t0:.2f} s",
          flush=True)
    rng = np.random.default_rng(0)
    g = torch.Generator(device=dev).manual_seed(0)
    results = {}

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
    results["K5 full-10k"] = check_k5_fired(
        dev, rng, g, P10k, L10k, C5_MAX_OBS,
        dict(full, live=FULL10K_LIVE), all_rows=True)
    # K6's main path draws (FastSLAM 1 forces the noise on); K6b's does
    # not (SWITCH_PREDICT_NOISE defaults to 0).
    results["K6"] = check_predict(dev, g, "K6", C5_P, fs2=False,
                                  timed_noise=True)
    results["K3"] = check_k3(dev, rng, g)
    results["K6b"] = check_predict(dev, g, "K6b", FS2_P, fs2=True,
                                   timed_noise=False)
    results["K1"] = check_k1(dev, rng, g)
    results["S1"] = check_sim_control(dev, g)
    results["E1"] = check_ekf_predict(dev, g)
    results["F2"] = check_fs2_tick(dev, g)
    results["R1"] = check_r1(dev, g, C5_P)
    results["R1 fs2"] = check_r1(dev, g, P_LARGE)
    return results


def host_us(fn, iters: int = 500) -> float:
    """Microseconds of the host's clock per call of ``fn``, over ``iters``
    back-to-back calls after a warm-up, the device synced before and
    after (not inside: the enqueue is what is timed)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * seconds / iters


def check_ekf_predict(dev, g) -> dict:
    """E1 at ekf-10k's shapes on both arms against the float64 twin
    (selfcheck.check_ekf_predict: each output within twice the eager
    float32 code's error), then timed on the heading arm, 15 of the 16
    columns used (the tick writes the last), beside its twin (the eager
    code on the card); its wrapper's host time a call, and that of the
    estimator's whole predict (ShardedEkfSlam.predict, as Runner calls
    it once a tick), by the host clock."""
    from slam_tpu_torch.config import SlamConfig
    from slam_tpu_torch.models.ekf import full_f32
    from slam_tpu_torch.ops.kernels import ekf as ke
    from slam_tpu_torch.parallel import ekf as pe

    L, D = selfcheck.EKF10K["L"], selfcheck.EKF10K["D"]
    st = selfcheck.check_ekf_predict(dev, g, L, D)
    state, (v, gg, phi), Q, kw, shard = selfcheck.ekf_predict_case(
        dev, g, L, D, D - 1)

    def kernel():
        ke.ekf_predict_tick(state.x, state.P00, state.P0m, state.hk, D - 1,
                            v, gg, phi, Q, heading_known=True, **kw)

    def plain():
        with full_f32():
            pe._predict_local_plain(state, v, gg, Q, kw["wheelbase"],
                                    kw["dt"], phi, kw["sigma_phi"], True,
                                    shard)
    est = pe.ShardedEkfSlam(SlamConfig(max_landmarks=L), L, device=dev)
    times = measure(kernel, plain)
    wrapper_us = host_us(kernel)
    predict_us = host_us(lambda: est.predict(state, None, v, gg, phi))
    print(f"kernel E1 (L={L}, D={D}): errors against the float64 twin "
          f"{json.dumps(st['errors'])}; wrapper {wrapper_us:.1f} us a call "
          f"on the host, ShardedEkfSlam.predict {predict_us:.1f} us",
          flush=True)
    L2 = 2 * L
    nbytes = (2 * 4 * (3 + L2) + 2 * 36 + 2 * 4 * 3 * L2 + 4 * L2 + 16
              + 3 * 4)
    return dict(max_abs_err=st["max_abs_err"], shape=f"L={L}, D={D}, "
                "heading observed", bytes=nbytes,
                ops=OPS_COLUMN_E1 * L2 + OPS_CHAIN_E1, errors=st["errors"],
                wrapper_host_us=wrapper_us, predict_host_us=predict_us,
                **times)


def check_fs2_tick(dev, g) -> dict:
    """F2 bit for bit against its twin (the eager tick on the card) at P =
    2^17 and a ragged P, on both arms of the heading and of the noise,
    with Pv zero and not, and across +-pi; then timed on the FastSLAM 2
    cell's arm (the heading known, the noise off) beside the twin (~195
    launches); its wrapper's host time a call, and that of the
    estimator's whole predict (``FastSlam2.predict``, the normals' draw
    included, as Runner calls it once a tick), by the host clock."""
    import torch

    from slam_tpu_torch.ops.kernels import predict as kp

    err, n = 0.0, 0
    for P in (P_LARGE, P_K2_RAGGED):
        for heading_known in (True, False):
            for noise in (False, True):
                for pv_zero in (False, True):
                    est, state, ticks = selfcheck.fs2_tick_case(
                        dev, g, P, heading_known=heading_known, noise=noise,
                        pv_zero=pv_zero)
                    got, want = selfcheck.fs2_tick_pair(est, state, ticks,
                                                        seed=n)
                    torch.cuda.synchronize()
                    err = max(err, selfcheck._bit_equal(
                        f"F2 P={P} heading={heading_known} noise={noise} "
                        f"Pv zero={pv_zero}", got, want))
                    n += 1
    for start in (math.pi - 5e-3, -math.pi + 5e-3):
        est, state, (vn, _, phi) = selfcheck.fs2_tick_case(
            dev, g, P_LARGE, heading=start, wheelbase=2.0)
        gn = torch.tensor(math.copysign(0.5, start), dtype=torch.float32,
                          device=dev)
        got, want = selfcheck.fs2_tick_pair(est, state, (vn, gn, phi), n)
        torch.cuda.synchronize()
        selfcheck._bit_equal(f"F2 through +-pi from {start}", got, want)
        check(bool((torch.sign(got[0][2]) != math.copysign(1.0, start))
                   .all()), "F2: the headings did not cross +-pi")
        n += 1
    print(f"kernel F2: bit-equal to its twin in {n} cases (P = {P_LARGE} "
          f"and {P_K2_RAGGED}; heading, noise, Pv zero; across +-pi)",
          flush=True)
    est, state, ticks = selfcheck.fs2_tick_case(dev, g, P_LARGE)
    gen = torch.Generator(device=dev).manual_seed(0)
    eps = torch.randn((2, P_LARGE), generator=gen, device=dev)
    kw = dict(wheelbase=est.config.WHEELBASE, dt=est.config.DT_CONTROLS,
              r=est.config.sigmaT ** 2, add_noise=False, heading_known=True)
    a = state._replace(xv=state.xv.clone(), Pv=state.Pv.clone())
    b = state._replace(xv=state.xv.clone(), Pv=state.Pv.clone())

    def kernel():
        kp.fs2_predict_tick(a.xv, a.Pv, eps, *ticks, est._chol_q, est._q,
                            **kw)

    times = measure(kernel, lambda: est._predict_plain(b, gen, *ticks))
    wrapper_us = host_us(kernel)
    predict_us = host_us(lambda: est.predict(a, gen, *ticks))
    print(f"kernel F2 (P={P_LARGE}): wrapper {wrapper_us:.1f} us a call on "
          f"the host, FastSlam2.predict {predict_us:.1f} us", flush=True)
    return dict(max_abs_err=err, shape=f"P={P_LARGE}, heading known, noise "
                "off", bytes=4 * (11 + 9) * P_LARGE + 12,
                ops=OPS_TICK_F2 * P_LARGE, wrapper_host_us=wrapper_us,
                predict_host_us=predict_us, **times)


def check_r1(dev, g, P) -> dict:
    """R1 at P on every kind of ``selfcheck.bounds_inputs``, bit-equal to
    its twin; then timed on a prefix sum of random weights beside the twin
    and beside torch.cummax over the same unscanned bounds (the running
    max the eager form took, one block of PyTorch's scan; the yardstick
    only: the port no longer calls it)."""
    import torch

    from slam_tpu_torch.ops import resampling as rs
    from slam_tpu_torch.ops.kernels import bounds as kb

    selfcheck.check_offspring_bounds(dev, g, P)
    csum, U = selfcheck.bounds_inputs(dev, g, P, "random")
    t = csum * float(P)
    k = torch.clamp(t.to(torch.int32), 0, P - 1)
    raw = k + (U(k) < t - k.to(torch.float32)).to(torch.int32)
    times = measure(lambda: kb.offspring_bounds(csum, P, U),
                    lambda: rs.offspring_bounds_plain(csum, P, U),
                    lambda: torch.cummax(raw, dim=0))
    print(f"kernel R1 (P={P}): bit-equal to its twin on "
          f"{len(selfcheck.BOUNDS_KINDS)} kinds of prefix sum", flush=True)
    return dict(max_abs_err=0.0, shape=f"P={P}", bytes=12 * P, ops=0,
                **times)


def check_sim_control(dev, g) -> dict:
    """S1 bit for bit against its twin over the gate's drive at
    SIM_SUPERSTEPS launches of T = 8, then timed at T = 8 beside the
    twin (the eager code: ~72 launches a tick). Its bound is the latency
    of one thread's chain of ticks, read from the device times of the
    SIM_LONG launches: (their difference per tick) x 8."""
    from slam_tpu_torch.ops.kernels import vehicle as kv
    from slam_tpu_torch.runtime.profiling import device_ms

    st = selfcheck.check_sim_control(dev, g, SIM_SUPERSTEPS)
    sim, vehicle, noise, kw = selfcheck.sim_drive(dev, g, max(SIM_LONG))

    def launch(T):
        rows = noise[:T]
        return lambda: kv.control_multi(vehicle, sim.waypoints, rows, **kw)
    times = measure(launch(T_PREDICT), lambda: kv.control_multi_plain(
        vehicle, sim.waypoints, noise[:T_PREDICT], **kw))
    (t_a, ms_a), (t_b, ms_b) = [(T, device_ms(launch(T))) for T in SIM_LONG]
    tick_ms = (ms_b - ms_a) / (t_b - t_a)
    print(f"kernel S1 ({st['shape']}): bit-equal to its twin; device ms at "
          f"T = {t_a}, {t_b}: {ms_a:.5f}, {ms_b:.5f} ({1e3 * tick_ms:.3f} "
          "us a tick)", flush=True)
    T = T_PREDICT
    return dict(max_abs_err=0.0, shape=f"T={T}, the gate's drive of "
                f"{SIM_SUPERSTEPS} launches", latency_ms=T * tick_ms,
                long_device_ms={t_a: ms_a, t_b: ms_b},
                bytes=2 * 25 + T * (8 + 8 + 12 + 16) + 12,
                ops=OPS_TICK_SIM * T, **times)


def check_gathers(dev, g, fs2_L) -> dict:
    """G1 (P = 100) and G2 (P = 2^17, and P = 2^20 at L = 40) over the
    resample gather's three row sets, 10 + 5L rows: bit-equal to their
    twins and to the library call that computes the same gather
    (index_select by the ancestors for G1, repeat_interleave by the
    offspring counts for G2, on the rows stacked beforehand)."""
    import torch

    results = {}
    for name, P, L in (("G1", P_SMALL, CAPACITY), ("G2", P_LARGE, CAPACITY),
                       ("G2 fs2-1m", FS2_P, fs2_L)):
        arrays, sel, kernel, plain = gather_inputs(dev, g, name[:2], P, L)
        stacked = torch.cat(arrays)
        rows = stacked.shape[0]
        if name == "G1":
            distinct = int(torch.unique(sel).numel())
            library = lambda: torch.index_select(stacked, 1, sel)  # noqa
        else:
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
    """K5 on one input: bit-equal to G2's gather followed by K4 with the
    empty rows zeroed, its staged and direct branches bit-equal, and
    (``twin``) within TOL of its twin. Returns the largest error against
    the twin."""
    import torch

    from slam_tpu_torch.ops.kernels import kernels as kk
    from slam_tpu_torch.ops.kernels.selfcheck import k5_composed

    def args(lw):
        return (state.xv, lw, state.lm, state.lm_P, S, *batch, R, state.n)

    lw = [logw.clone() for _ in range(3)]
    got = (lw[0], *kk.resample_update(*args(lw[0])))
    for other, what in ((lambda a: kk.resample_update_launch(
            *args(a), staged=False), "its direct branch"),
                        (lambda a: k5_composed(state, batch, S, a),
                         "G2 + K4")):
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


def k5_bytes(P, L, K, live, distinct) -> int:
    """K5's least bytes: the poses, the weights (read and written) and S;
    every one of the 5 L rows written (live or zero); the ``live`` rows
    it reads, once from each distinct ancestor (the new features' rows
    are not read); the observations."""
    return 4 * P * (3 + 1 + 1 + 5 * L + 1) + 4 * 5 * live * distinct + 18 * K


def check_k5_fired(dev, rng, g, P, L, K, inputs, all_rows=False) -> dict:
    """K5 on the offspring bounds of a fired resample at K observations,
    L slots, P particles, ``inputs["live"]`` of them live (``inputs``:
    update_inputs' counts): bit-equal to G2 + K4 and across its
    branches, within TOL of its twin, and timed, with its bytes and
    operations. ``all_rows``: also timed with the live count at L, so
    that every row is copied (the grid alone, against the live rows)."""
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

    def args(lw, n=state.n):
        return (state.xv, lw, state.lm, state.lm_P, S, *batch, R, n)
    lw_k, lw_p, lw_d = logw.clone(), logw.clone(), logw.clone()
    times = measure(lambda: kk.resample_update(*args(lw_k)),
                    lambda: kk.resample_update_plain(*args(lw_p)))

    def direct():
        return kk.resample_update_launch(*args(lw_d), staged=False)
    times.update(direct_ms=cuda_ms(direct), direct_device_ms=device_ms(direct))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    chunks = kk.resample_update_chunks(P, L, sms)
    nbytes = k5_bytes(P, L, K, inputs["live"], layout["distinct"])
    print(f"kernel K5 (K={K} L={L} P={P} n={inputs['live']}): "
          f"{chunks} chunks of {-(-P // K5_TILE)} tiles; distinct ancestors "
          f"{layout['distinct']}, sectors holding one "
          f"{layout['live_sectors']:.4f}, staged tiles "
          f"{layout['staged_tiles']:.4f}; direct branch "
          f"{times['direct_ms']:.4f} ms", flush=True)
    out = dict(max_abs_err=err, shape=f"K={K} L={L} P={P} n={inputs['live']}",
               bytes=nbytes, chunks=chunks,
               ops=P * (inputs["n_match"] * OPS_MATCH
                        + inputs["n_new"] * OPS_INIT), **layout, **times)
    if all_rows:
        full = torch.tensor(L, dtype=torch.int32, device=dev)
        lw_a = logw.clone()

        def every_row():
            return kk.resample_update(*args(lw_a, full))
        ms_a, dev_a = cuda_ms(every_row), device_ms(every_row)
        bytes_a = k5_bytes(P, L, K, L - inputs["n_new"], layout["distinct"])
        b_ms, _ = bound(bytes_a, out["ops"])
        out["all_rows"] = dict(ms=ms_a, device_ms=dev_a, bytes=bytes_a,
                               bound_ms=b_ms, share=b_ms / ms_a)
        print(f"kernel K5 (K={K} L={L} P={P} n={L}, every row copied): "
              f"{ms_a:.4f} ms (device {dev_a}), bound {b_ms:.4f} ms "
              f"({bytes_a:.4g} B), share {b_ms / ms_a:.3f}", flush=True)
    del state, batch
    torch.cuda.empty_cache()
    return out


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


def check_k3(dev, rng, g) -> dict:
    """K3 at K = 15, P = 2^20 on selfcheck.refine_inputs: every fifth
    observation unmatched; at the golden tolerances."""
    import torch

    from slam_tpu_torch.ops.kernels import kernels as kk

    P, K = FS2_P, K_OBS
    args = refine_inputs(dev, rng, g, P, K)
    got, want = kk.fs2_refine(*args), kk.fs2_refine_plain(*args)
    torch.cuda.synchronize()
    err = compare_refine(got, want)
    n_match = int(args[-2].sum())
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
    (-method FASTSLAM2), "deferred" (FastSlam1Deferred with K6),
    "deferred-per-tick" (FastSlam1Deferred with the per-tick predict),
    or a function (cfg, slam_map, P) -> estimator (the sharded filters
    of phase 16). No device is named: everything must come to lie on
    the card ``dev`` by default."""
    import torch

    from slam_tpu_torch.models import FastSlam1Deferred
    from slam_tpu_torch.runtime import Runner
    if callable(kind):
        runner = Runner(cfg, slam_map, n_particles=P,
                        estimator=kind(cfg, slam_map, P))
    elif kind in ("eager", "fs2"):
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
              per_superstep=(), seeds=SEEDS) -> dict:
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
    for seed in seeds:
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
        for k in ("S1", *per_superstep):
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
    summary = dict(P=P, seeds=list(seeds), ate_rmse_3seed=rms, ates=ates,
                   steps_per_s=rates,
                   host_syncs_per_superstep=syncs, launches=total,
                   launches_per_superstep={
                       k: n / (len(seeds) * T) for k, n in total.items()
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
        check(counts["K6"] == counts["S1"] == n_supersteps
              and counts["K5"] + counts["K4"] == n_supersteps,
              f"{name} seed {seed}: launches {counts} in {n_supersteps} "
              "supersteps")
        for k in on:
            check(counts[k] > 0, f"{name} seed {seed}: {k} was never "
                  f"launched {counts}")
        for k in ("K2", "G1", "K3", "K6b", "F2", "K1"):
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
    runs with syncs raising; S1 launches once a superstep, E1 once a
    tick of the block EKF (``sharded``), and none of the nine estimator
    kernels; the runner, simulator, estimator and
    final state must be on the card;
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
    # E1 runs the block EKF's predict, once a tick.
    e1 = cfg.steps_per_observe if sharded else 0
    per_superstep = {"S1": 1.0, **({"E1": float(e1)} if e1 else {})}
    ates, rates = [], []
    total = dict.fromkeys(kernels.WRAPPERS, 0)
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
        ekf_launches(f"{name} seed {seed}", counts, T, e1=e1 * T)
        total = {k: total[k] + counts[k] for k in total}
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
          and prof["launches_per_superstep"] == per_superstep,
          f"{name}: profiled window {prof['host_syncs_per_superstep']} "
          f"syncs, launches {prof['launches_per_superstep']}")
    summary = dict(seeds=list(seeds), ate_rmse=rms, ates=ates,
                   steps_per_s=rates, host_syncs_per_superstep=0,
                   launches=total, launches_per_superstep=per_superstep,
                   ate_bound=ate_bound,
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


# --- phases 12-15: the runtime edges ----------------------------------------
# dense200's vehicle first sees a landmark at superstep 137; the
# checkpointed and streamed runs go to superstep 200 (1600 ticks).
FIRST_SIGHTING, EDGE_SUPERSTEPS = 137, 200
# (m): to superstep 160, so the last 23 stream the landmarks too.
STREAM_SUPERSTEPS = 160
# (l): chunks of 50 supersteps, the interrupted run stops at 150.
SMALL_EVERY, SMALL_CUT = 50, 150


def state_tensors(state) -> list:
    """The tensors of a state, its fields depth first."""
    import torch
    out = []
    for v in state:
        if isinstance(v, tuple):
            out += state_tensors(v)
        elif isinstance(v, torch.Tensor):
            out.append(v)
    return out


TRACES = ("true_pose", "est_pose", "active", "obs_count", "obs_range_sum",
          "obs_z", "obs_mask", "obs_ids", "odom")


def same_traces(name, full, part, start: int) -> None:
    """The traces of ``part`` are rows ``start`` on of ``full``'s, bit
    for bit."""
    import numpy as np

    n = len(part.est_pose)
    for f in TRACES:
        check(np.array_equal(getattr(full, f)[start:start + n],
                             getattr(part, f)),
              f"{name}: {f} differs from the unbroken run's")


def same_run(name, full, tail) -> None:
    """``tail`` (a resumed run) is the end of ``full`` bit for bit: the
    nine traces and every tensor and host value of the final state."""
    import torch

    same_traces(name, full, tail, len(full.est_pose) - len(tail.est_pose))
    a, b = state_tensors(full.final_state), state_tensors(tail.final_state)
    check(len(a) == len(b) and all(x.dtype == y.dtype and torch.equal(x, y)
                                   for x, y in zip(a, b)),
          f"{name}: the final states differ")
    check(getattr(full.final_state, "pending", None)
          == getattr(tail.final_state, "pending", None),
          f"{name}: the pending flags differ")


class Recorded:
    """An estimator that records ``pending`` after each update; every
    other attribute is the estimator's."""

    def __init__(self, est):
        self._est, self.pending = est, []

    def update(self, *args, **kw):
        out = self._est.update(*args, **kw)
        self.pending.append(out.pending)
        return out

    def __getattr__(self, name):
        return getattr(self._est, name)


@contextlib.contextmanager
def timed_checkpoints(io: list):
    """Times every save and load of the checkpointed runs inside (host
    clock, after a device sync), with the bytes: the npz file's, and
    the state's in device memory."""
    import os

    import torch

    from slam_tpu_torch.runtime import checkpoint

    save, load = checkpoint.save_checkpoint, checkpoint.load_checkpoint

    def nbytes(*states):
        return sum(t.numel() * t.element_size()
                   for st in states for t in state_tensors(st))

    def timed_save(path, sim_state, est_state, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = save(path, sim_state, est_state, *args, **kw)
        io.append(dict(op="save", s=time.perf_counter() - t0,
                       file_bytes=os.path.getsize(out),
                       state_bytes=nbytes(sim_state.vehicle, est_state)))
        return out

    def timed_load(*args, **kw):
        t0 = time.perf_counter()
        out = load(*args, **kw)
        torch.cuda.synchronize()
        io.append(dict(op="load", s=time.perf_counter() - t0,
                       state_bytes=nbytes(out[0].vehicle, out[1])))
        return out

    checkpoint.save_checkpoint, checkpoint.load_checkpoint = (timed_save,
                                                              timed_load)
    try:
        yield io
    finally:
        checkpoint.save_checkpoint, checkpoint.load_checkpoint = save, load


def edge_slice(counts, run_supersteps, **extra) -> dict:
    """A slice record for the kernel table: its launches, in total and
    per superstep of the ``run_supersteps`` they were counted over."""
    return dict(launches=counts, launches_per_superstep={
        k: n / run_supersteps for k, n in counts.items() if n}, **extra)


def ekf_launches(name, counts, n_supersteps, e1: int = 0) -> None:
    """A run of an EKF: S1, the simulator's control ticks, once a
    superstep, E1 ``e1`` times (the block EKF's predict, once a tick;
    the dense EKF launches none), and nothing else."""
    check(counts["S1"] == n_supersteps and counts["E1"] == e1
          and not any(n for k, n in counts.items() if k not in ("S1", "E1")),
          f"{name}: launches {counts} in {n_supersteps} supersteps")


def check_ckpt_deferred(dev, tmp) -> dict:
    """Phase 12 (k): FastSlam1Deferred on dense200 at P = 131,072, seed
    3, checkpointed: unbroken to superstep 200, then cut at a superstep
    after the first sighting where a resample is pending (read from the
    unbroken run), and resumed from there. Everything bit-equal."""
    import os

    from slam_tpu_torch.models import FastSlam1Deferred
    from slam_tpu_torch.ops import kernels
    from slam_tpu_torch.runtime import Runner

    cfg, slam_map = dense200()
    period, N = cfg.steps_per_observe, EDGE_SUPERSTEPS

    def runner():
        est = Recorded(FastSlam1Deferred(cfg, slam_map.n_landmarks))
        return Runner(cfg, slam_map, "FASTSLAM1", n_particles=P_LARGE,
                      estimator=est)

    io = []
    with timed_checkpoints(io):
        kernels.reset_launch_counts()
        r = runner()
        full = r.run_checkpointed(seed=3, n_ticks=N * period, every=N,
                                  ckpt_path=os.path.join(tmp, "full"))
        counts = kernels.launch_counts()
        check(not on_card(dev, r, state_tensors(full.final_state)),
              "ckpt-deferred: with no device named the run is not on "
              f"{dev}")
        pending = [i + 1 for i, p in enumerate(r.est.pending) if p]
        late = [s for s in pending if FIRST_SIGHTING < s <= N - 10]
        check(late, f"ckpt-deferred: no resample pending between superstep "
              f"{FIRST_SIGHTING} and {N - 10}: {pending}")
        cut = next((s for s in late if s >= 150), late[0])
        ck = os.path.join(tmp, "cut")
        first = runner().run_checkpointed(seed=3, n_ticks=cut * period,
                                          every=cut, ckpt_path=ck)
        with open(ck + ".json") as fh:
            host = json.load(fh)["est_host"]
        check(host == [True], f"ckpt-deferred: the checkpoint at {cut} has "
              f"pending {host}")
        kernels.reset_launch_counts()
        resumed = runner().run_checkpointed(seed=3, n_ticks=N * period,
                                            every=N - cut, ckpt_path=ck,
                                            resume=True)
        counts_resumed = kernels.launch_counts()
    for k in ("K4", "K5", "K6", "G2"):
        check(counts[k] > 0, f"ckpt-deferred: {k} was never launched "
              f"{counts}")
    for k in ("K2", "G1", "K3", "K6b", "F2", "K1"):
        check(counts[k] == 0, f"ckpt-deferred: {k} should not run {counts}")
    check(counts_resumed["K5"] > 0, "ckpt-deferred: K5 did not run after "
          f"the resume on a pending resample {counts_resumed}")
    same_traces("ckpt-deferred (cut)", full, first, 0)
    same_run("ckpt-deferred", full, resumed)
    boundaries = [s for s in (cut, N) if s > FIRST_SIGHTING]
    check(len(boundaries) >= 2, f"ckpt-deferred: boundaries {boundaries}")
    saves = [e for e in io if e["op"] == "save"]
    loads = [e for e in io if e["op"] == "load"]
    out = edge_slice(
        {k: counts[k] + counts_resumed[k] for k in counts},
        N + N - cut, P=P_LARGE, supersteps=N, cut=cut,
        boundaries_after_sighting=boundaries, pending_boundaries=[cut],
        launches_unbroken={k: counts[k] for k in ("K4", "K5", "K6", "G2")},
        launches_resumed={k: counts_resumed[k]
                          for k in ("K4", "K5", "K6", "G2")},
        checkpoint_file_bytes=saves[-1]["file_bytes"],
        state_bytes=saves[-1]["state_bytes"],
        save_s=[e["s"] for e in saves], load_s=[e["s"] for e in loads],
        save_gb_per_s=saves[-1]["state_bytes"] / saves[-1]["s"] / 1e9,
        load_gb_per_s=loads[-1]["state_bytes"] / loads[-1]["s"] / 1e9,
        wall_unbroken_s=full.wall_seconds,
        wall_interrupted_s=first.wall_seconds,
        wall_resumed_s=resumed.wall_seconds)
    print(f"slice ckpt-deferred: {json.dumps(out)}", flush=True)
    return out


def check_ckpt_small(dev, tmp) -> dict:
    """Phase 13 (l): slices (a) (FS1, P = 100) and (h) (EKF1, heading
    known) on dense200, seed 3, checkpointed in chunks of 50 supersteps:
    unbroken to 200, and cut at 150 and resumed; bit-equal. Then
    run_resilient on (a) with one failure injected after the first
    chunk: it must end as the clean run ends."""
    import os

    from slam_tpu_torch.ops import kernels
    from slam_tpu_torch.runtime import Runner
    from slam_tpu_torch.runtime.resilience import run_resilient

    cfg, slam_map = dense200()
    period, N = cfg.steps_per_observe, EDGE_SUPERSTEPS
    makers = {
        "ckpt-fs1": lambda: Runner(cfg, slam_map, "FASTSLAM1",
                                   n_particles=P_SMALL),
        "ckpt-ekf": lambda: ekf_runner((cfg, slam_map), False)}
    out = {}
    for name, make in makers.items():
        kw = dict(seed=3, every=SMALL_EVERY)
        kernels.reset_launch_counts()
        r = make()
        full = r.run_checkpointed(n_ticks=N * period,
                                  ckpt_path=os.path.join(tmp, name), **kw)
        counts = kernels.launch_counts()
        check(not on_card(dev, r, state_tensors(full.final_state)),
              f"{name}: with no device named the run is not on {dev}")
        ck = os.path.join(tmp, name + "-cut")
        make().run_checkpointed(n_ticks=SMALL_CUT * period, ckpt_path=ck,
                                **kw)
        resumed = make().run_checkpointed(n_ticks=N * period, ckpt_path=ck,
                                          resume=True, **kw)
        check(len(resumed.est_pose) == N - SMALL_CUT,
              f"{name}: {len(resumed.est_pose)} resumed supersteps")
        same_run(name, full, resumed)
        out[name] = edge_slice(counts, N, full=full)
    fs1 = out["ckpt-fs1"]
    check(fs1["launches"]["K2"] == N and fs1["launches"]["G1"] > 0,
          f"ckpt-fs1: launches {fs1['launches']}")
    ekf_launches("ckpt-ekf", out["ckpt-ekf"]["launches"], N)

    class Flaky(Runner):
        """Fails in its first checkpointed run after the first chunk is
        saved (tests/test_resilience.py's FlakyRunner)."""
        failures = 0

        def run_checkpointed(self, **kw):
            if not kw.get("resume"):
                Flaky.failures += 1
                try:
                    super().run_checkpointed(**{
                        **kw, "n_ticks": SMALL_EVERY * period})
                finally:
                    raise RuntimeError("injected failure")
            return super().run_checkpointed(**kw)

    got = run_resilient(Flaky(cfg, slam_map, "FASTSLAM1",
                              n_particles=P_SMALL),
                        seed=3, n_ticks=N * period, every=SMALL_EVERY,
                        ckpt_path=os.path.join(tmp, "flaky"), backoff_s=0.0)
    check(Flaky.failures == 1 and len(got.est_pose) == N - SMALL_EVERY,
          f"run_resilient: {Flaky.failures} failures, "
          f"{len(got.est_pose)} supersteps")
    same_run("run_resilient", out["ckpt-fs1"].pop("full"), got)
    out["ckpt-ekf"].pop("full")
    print(f"ckpt-small: bit-equal across a resume at {SMALL_CUT} (FS1 "
          f"P={P_SMALL}, EKF1); run_resilient recovered after 1 failure; "
          f"{json.dumps(out)}", flush=True)
    return out


class StrictGui:
    """tests/test_telemetry.py's StrictController on the port's
    ``decode_message``: every scalar one frame of its width, every frame
    consumed, setCovEllipse indices below the latest covEllipseAdd,
    laser lines 4 rows, ellipses 2, and each plot() turn exactly one
    true and estimated position and car (what the stock GUI's
    DataGatherer::nextTurn relies on)."""

    TURN = ("addTruePosition", "addEstimatedPosition",
            "setCarTruePosition", "setCarEstimatedPosition")
    WIDTHS = {"addTruePosition": (8, 8), "addEstimatedPosition": (8, 8),
              "setCarTruePosition": (8, 8, 8),
              "setCarEstimatedPosition": (8, 8, 8),
              "setPlotRange": (8, 8, 8, 8), "setCarSize": (8, 4),
              "covEllipseAdd": (4,), "loopTime": (4,)}
    XY = ("setLandmarks", "setWaypoints", "setParticles",
          "setFeatureParticles")

    def __init__(self):
        self.counts, self.turn, self.tags = {}, {}, []
        self.capacity, self.n_turns, self.done = None, 0, False

    def send_multipart(self, frames):
        import struct

        from slam_tpu_torch.runtime.telemetry import decode_message

        check(not self.done, "telemetry: a message after endPlot")
        tag, body = decode_message([bytes(f) for f in frames])
        self.counts[tag] = self.counts.get(tag, 0) + 1
        self.tags.append(tag)
        if tag in self.XY:
            n = struct.unpack(">i", body[0])[0]
            m = struct.unpack(">i", body[1 + n])[0]
            check(n == m and len(body) == 2 + n + m
                  and all(len(f) == 8 for f in body[1:1 + n]
                          + body[2 + n:]), f"telemetry: {tag} layout")
        elif tag in ("setLaserLines", "setCovEllipse"):
            rows, cols = (struct.unpack(">I", f)[0] for f in body[:2])
            extra = 1 if tag == "setCovEllipse" else 0
            check(len(body) == 2 + rows * cols + extra
                  and all(len(f) == 4 for f in body[2:]),
                  f"telemetry: {tag} layout")
            check(rows == (4 if tag == "setLaserLines" else 2),
                  f"telemetry: {tag} has {rows} rows")
            if extra:
                idx = struct.unpack(">i", body[-1])[0]
                check(self.capacity is not None and 0 <= idx < self.capacity,
                      f"telemetry: ellipse {idx} of {self.capacity}")
        elif tag in self.WIDTHS:
            check(len(frames) - 1 == len(self.WIDTHS[tag])
                  and all(len(f) == w for f, w in zip(frames[1:],
                                                      self.WIDTHS[tag])),
                  f"telemetry: {tag} frames")
            if tag == "covEllipseAdd":
                self.capacity = body[0]
            if tag in self.TURN:
                self.turn[tag] = self.turn.get(tag, 0) + 1
        elif tag == "setSimulationName":
            check(len(body) == 1 and body[0], "telemetry: simulation name")
        elif tag == "plot":
            check(not body and self.turn == dict.fromkeys(self.TURN, 1),
                  f"telemetry: a turn of {self.turn}")
            self.turn, self.n_turns = {}, self.n_turns + 1
        elif tag == "endPlot":
            check(not body, "telemetry: endPlot frames")
            self.done = True
        else:
            check(tag == "clear" and not body, f"telemetry: tag {tag!r}")


def check_stream(dev) -> dict:
    """Phase 14 (m): run_streaming of slices (a) and (h) on dense200,
    seed 3, 160 supersteps, into a StrictGui; its setup first, one turn
    per superstep, the clouds or the ellipses there. Beside it the same
    run headless (its traces bit-equal to run's) and run itself, for
    steps/s with and without telemetry, and the host reads per
    superstep."""
    import numpy as np

    from slam_tpu_torch.ops import kernels
    from slam_tpu_torch.runtime import Runner
    from slam_tpu_torch.runtime.telemetry import NetworkPlot

    cfg, slam_map = dense200()
    ticks = STREAM_SUPERSTEPS * cfg.steps_per_observe
    setup = ["setPlotRange", "setSimulationName", "setCarSize",
             "setCarSize", "setLandmarks", "setWaypoints"]
    out = {}
    for name, make, needs in (
            ("stream-fs1", lambda: Runner(cfg, slam_map, "FASTSLAM1",
                                          n_particles=P_SMALL),
             ("setParticles", "setFeatureParticles")),
            ("stream-ekf", lambda: ekf_runner((cfg, slam_map), False),
             ("covEllipseAdd", "setCovEllipse"))):
        ref = make().run(seed=3, n_ticks=ticks)
        headless = make().run_streaming(seed=3, n_ticks=ticks)
        for f in ref._fields[:9]:
            check(np.array_equal(getattr(ref, f), getattr(headless, f)),
                  f"{name}: the headless stream's {f} differs from run's")
        gui = StrictGui()
        kernels.reset_launch_counts()
        res = make().run_streaming(seed=3, n_ticks=ticks, sim_name="dense200",
                                   plot=NetworkPlot(socket=gui))
        counts = kernels.launch_counts()
        n = len(res.est_pose)
        check(gui.done and gui.n_turns == n == STREAM_SUPERSTEPS,
              f"{name}: {gui.n_turns} turns, {n} supersteps")
        check(gui.tags[:len(setup)] == setup,
              f"{name}: setup {gui.tags[:len(setup)]}")
        for tag in needs:
            check(gui.counts.get(tag, 0) > 0, f"{name}: no {tag}")
        rates = {k: r.n_ticks / r.wall_seconds
                 for k, r in (("run", ref), ("headless", headless),
                              ("plot", res))}
        out[name] = edge_slice(
            counts, n, steps_per_s=rates,
            host_reads_per_superstep={
                k: r.host_syncs / len(r.est_pose)
                for k, r in (("run", ref), ("headless", headless),
                             ("plot", res))},
            messages=sum(gui.counts.values()))
        print(f"slice {name}: {json.dumps(out[name])}", flush=True)
    check(out["stream-fs1"]["launches"]["K2"] == STREAM_SUPERSTEPS
          and out["stream-fs1"]["launches"]["G1"] > 0,
          f"stream-fs1: launches {out['stream-fs1']['launches']}")
    ekf_launches("stream-ekf", out["stream-ekf"]["launches"],
                 STREAM_SUPERSTEPS)
    return out


def check_cli(tmp) -> dict:
    """Phase 15 (n): the command line, as a user runs it: FASTSLAM1 on
    dense200 (P = 100 from its .ini) with -ckpt to superstep 150, then
    again to 200 under -profile (it resumes), whose trace must name the run's CUDA kernels K2 (fs1_observe_kernel) and
    G1 (gather_kernel). Then time_phases on slice (a)."""
    import glob
    import inspect
    import os

    import numpy as np

    from slam_tpu_torch.runtime import Runner
    from slam_tpu_torch.runtime.profiling import time_phases

    cfg, slam_map = dense200()
    period = cfg.steps_per_observe
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    ck, prof = os.path.join(tmp, "cli", "run"), os.path.join(tmp, "prof")
    out = {}
    # The CLI's chunk: run_checkpointed's default; a run ends on a chunk.
    every = inspect.signature(Runner.run_checkpointed).parameters[
        "every"].default
    start = 0
    for ticks, extra in ((1200, ()), (1600, ("-profile", prof))):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "slam_tpu_torch", "-m", MAP, "-method",
             "FASTSLAM1", "-seed", "3", "-ticks", str(ticks), "-ckpt", ck,
             "-n", "cli", "-out", tmp, *extra],
            capture_output=True, text=True, timeout=600, cwd=root, env=env)
        check(proc.returncode == 0, f"cli -ticks {ticks}: exit "
              f"{proc.returncode}: {proc.stderr[-2000:]}")
        with open(ck + ".json") as fh:
            at = json.load(fh)["superstep"]
        rows = np.loadtxt(os.path.join(tmp, "cli", "errors.txt")).shape[0]
        n = ticks // period
        check(at == start + -(-(n - start) // every) * every
              and rows == n - start,
              f"cli -ticks {ticks}: checkpoint at {at}, {rows} rows")
        start = at
        check("on cuda" in proc.stderr, f"cli: not on the card: "
              f"{proc.stderr[-500:]}")
        out[f"ticks_{ticks}_s"] = time.perf_counter() - t0
        print(f"cli -ticks {ticks} -ckpt{' -profile' if extra else ''}: "
              f"checkpoint at superstep {at}, {rows} supersteps reported, "
              f"{out[f'ticks_{ticks}_s']:.1f} s; "
              f"{proc.stderr.strip().splitlines()[-2]}", flush=True)
    traces = glob.glob(os.path.join(prof, "*.pt.trace.json"))
    check(len(traces) == 1, f"cli -profile: traces {traces}")
    with open(traces[0]) as fh:
        text = fh.read()
    names = {k: text.count(f"{k}") for k in ("fs1_observe_kernel",
                                              "gather_kernel")}
    check(all(names.values()), f"cli -profile: kernel names in the trace "
          f"{names}")
    out.update(trace_bytes=len(text), trace_kernel_mentions=names)
    del text
    out["time_phases_a"] = time_phases(
        Runner(cfg, slam_map, "FASTSLAM1", n_particles=P_SMALL), seed=3)
    print(f"cli: {json.dumps(out)}", flush=True)
    return out


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def check_k4_cross_shard(dev, group) -> dict:
    """Phase 16: K4's cross-shard weight arm (kernels.cross_shard_update:
    K4 into a zeroed [P] buffer, its all-reduce over the landmark shards,
    the add to logw) at config #5's shape, K = 96 (70 matched, 20 new),
    L = 192, P = 2^20, on the NCCL group of one: bit-equal to the
    in-place K4 and within TOL of the twin's arm (the planes, and the
    weights' delta); timed beside the in-place K4 (CUDA events and
    device time)."""
    import numpy as np
    import torch

    from slam_tpu_torch.ops.kernels import kernels as kk
    from slam_tpu_torch.runtime.profiling import device_ms

    rng = np.random.default_rng(16)
    g = torch.Generator(device=dev).manual_seed(16)
    n_match, n_new, K, L, P = 70, 20, C5_MAX_OBS, C5_CAPACITY, C5_P
    state, batch = update_inputs(dev, rng, g, P, L, K, n_map=C5_LANDMARKS,
                                 live=150, n_match=n_match, n_new=n_new)

    def fresh():
        return (state.xv, state.logw.clone(), state.lm.clone(),
                state.lm_P.clone(), *batch, R)
    arm, in_place = fresh(), fresh()
    kk.fused_update(*arm, group=group)
    kk.fused_update(*in_place)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(arm[1:4], in_place[1:4])),
          "K4 cross-shard arm: not bit-equal to the in-place K4 (max abs "
          f"err {max_abs_err(arm[1:4], in_place[1:4]):.3g})")
    del in_place
    twin = fresh()
    kk.cross_shard_update(kk.fused_update_plain, *twin, group)
    torch.cuda.synchronize()
    # The weights as the arm's delta: -log P plus a sum of 70 terms can
    # cancel to near 0, where rtol says nothing of the sum's rounding.
    got = (arm[1] - state.logw, *arm[2:4])
    want = (twin[1] - state.logw, *twin[2:4])
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **TOL)
    err = max_abs_err(got, want)
    del arm, twin
    torch.cuda.empty_cache()
    b_arm, b_twin = fresh(), fresh()
    out = measure(lambda: kk.fused_update(*b_arm, group=group),
                  lambda: kk.cross_shard_update(kk.fused_update_plain,
                                                *b_twin, group))
    del b_twin
    b_in = fresh()
    out.update(in_place_ms=cuda_ms(lambda: kk.fused_update(*b_in)),
               in_place_device_ms=device_ms(lambda: kk.fused_update(*b_in)))
    # K4's bytes (check_k4), with the weight buffer d in logw's place,
    # and the arm's own: d zeroed, then logw += d reads both and writes
    # logw. The all-reduce over one rank moves nothing.
    nbytes = (4 * P * (3 + 2 + 5 * n_match + 5 * (n_match + n_new)) + 18 * K
              + 16 * P)
    b_ms, by = bound(nbytes, P * (n_match * OPS_MATCH + n_new * OPS_INIT))
    out.update(max_abs_err=err, bit_equal_in_place=True, bytes=nbytes,
               bound_ms=b_ms, bound_by=by, share=b_ms / out["ms"],
               shape=f"K={K} L={L} P={P}, one landmark shard")
    print(f"kernel K4 cross-shard arm ({out['shape']}): {out['ms']:.4f} ms "
          f"(device {out['device_ms']}), in place {out['in_place_ms']:.4f} "
          f"ms (device {out['in_place_device_ms']}), twin's arm "
          f"{out['plain_ms']:.4f} ms, bound {b_ms:.4f} ms by {by}; "
          f"bit-equal to the in-place K4, max_abs_err {err:.3g} against "
          "the twin", flush=True)
    del b_arm, b_in, state, batch
    torch.cuda.empty_cache()
    return out


def check_sharded(dev) -> dict:
    """Phase 16: the sharded filters through Runner, in the NCCL process
    group of one rank that main starts (nccl_group): the card holds one
    H100, and NCCL runs one rank per device. Their collectives run over
    groups of one; their kernels on the whole block. K4's cross-shard
    arm first (check_k4_cross_shard), then (o) ShardedFastSlam1 on (b)'s
    world and P, (p) ShardedFastSlam2 on (e)'s and (q)
    LandmarkShardedFastSlam1 on a (1, 1) mesh at config #5's world,
    width and supersteps, seed 3. Each run: one host sync per superstep,
    the ATE against (b)'s, (e)'s and (c)'s JAX anchors."""
    from slam_tpu_torch.parallel import (
        ShardedFastSlam1,
        ShardedFastSlam2,
        make_mesh,
    )
    from slam_tpu_torch.parallel.landmarks import (
        LandmarkShardedFastSlam1,
        make_mesh_2d,
    )
    from slam_tpu_torch.runtime.config5 import config5_setup

    t0 = time.perf_counter()
    mesh, mesh2 = make_mesh(), make_mesh_2d(1, 1)
    arm = check_k4_cross_shard(dev, mesh2.get_group("l"))
    runs = {}
    runs["sharded-fs1"] = run_slice(
        dev, "sharded-fs1", dense200(),
        lambda c, m, P: ShardedFastSlam1(c, m.n_landmarks, mesh, P),
        P_LARGE, TICKS, JAX_ANCHOR_ATE_M, on=("K4", "G2"),
        off=("K2", "K5", "K6", "G1", "K3", "K6b", "F2", "K1"),
        per_superstep=("K4",))
    runs["sharded-fs2-small"] = run_slice(
        dev, "sharded-fs2-small", dense200(),
        lambda c, m, P: ShardedFastSlam2(c, m.n_landmarks, mesh, P),
        P_SMALL, TICKS, JAX_FS2_ANCHOR_ATE_M, on=("K3", "K2", "G1"),
        off=("K4", "K6b", "G2", "K5", "K6", "F2", "K1"),
        per_superstep=("K2", "K3"))
    runs["sharded-lm-config5"] = run_slice(
        dev, "sharded-lm-config5",
        config5_setup(C5_LANDMARKS, capacity=C5_CAPACITY,
                      max_obs=C5_MAX_OBS),
        lambda c, m, P: LandmarkShardedFastSlam1(c, m.n_landmarks,
                                                 mesh2, P),
        C5_P, C5_SUPERSTEPS * T_PREDICT, JAX_CONFIG5_ATE_M,
        on=("K4", "G2"), off=("K2", "K5", "K6", "G1", "K3", "K6b", "F2", "K1"),
        per_superstep=("K4",), seeds=SEEDS[:1])
    for name, run in runs.items():
        check(all(x == 1 for x in run["host_syncs_per_superstep"]),
              f"{name}: host syncs per superstep "
              f"{run['host_syncs_per_superstep']}")
    print(f"sharded phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return dict(runs=runs, k4_cross_shard=arm)


@contextlib.contextmanager
def nccl_group(dev):
    """An NCCL process group of one rank on the card, for phases 16 and
    17 (init_distributed with no device named, on a free localhost
    port); destroyed on the way out."""
    import torch.distributed as dist

    from slam_tpu_torch.parallel.distributed import init_distributed

    rank_dev = init_distributed(f"tcp://localhost:{free_port()}", 1, 0)
    try:
        check(dist.get_backend() == "nccl" and rank_dev == dev,
              f"process group: backend {dist.get_backend()} on {rank_dev}")
        yield
    finally:
        dist.destroy_process_group()


def check_k2_cross_shard(dev, group) -> dict:
    """Phase 17: K2's cross-shard weight arm (kernels.cross_shard_update
    around K2) at the shape of config #5 at JAX's default width, K = 96
    (70 matched, 20 new), L = 192, P = 1,000,000 (no multiple of 128,
    so the landmark-sharded filter takes K2), on the NCCL group of one:
    against the in-place K2 (bit-equal, or within TOL: which is
    printed) and within TOL of the twin's arm (the planes, and the
    weights' delta); timed beside the in-place K2."""
    import numpy as np
    import torch

    from slam_tpu_torch.ops.kernels import kernels as kk
    from slam_tpu_torch.runtime.profiling import device_ms

    rng = np.random.default_rng(17)
    g = torch.Generator(device=dev).manual_seed(17)
    n_match, n_new, K, L, P = 70, 20, C5_MAX_OBS, C5_CAPACITY, C5_JAX_P
    state, batch = update_inputs(dev, rng, g, P, L, K, n_map=C5_LANDMARKS,
                                 live=150, n_match=n_match, n_new=n_new)

    def fresh():
        return (state.xv, state.logw.clone(), state.lm.clone(),
                state.lm_P.clone(), *batch, R)

    def deltas(out):
        return (out[1] - state.logw, *out[2:4])
    arm, in_place = fresh(), fresh()
    kk.observe(*arm, group=group)
    kk.observe(*in_place)
    torch.cuda.synchronize()
    bit_equal = all(torch.equal(a, b) for a, b in zip(arm[1:4],
                                                      in_place[1:4]))
    for a, b in zip(deltas(arm), deltas(in_place)):
        torch.testing.assert_close(a, b, **TOL)
    err_in_place = max_abs_err(deltas(arm), deltas(in_place))
    del in_place
    twin = fresh()
    kk.cross_shard_update(kk.observe_plain, *twin, group)
    torch.cuda.synchronize()
    got, want = deltas(arm), deltas(twin)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **TOL)
    err = max_abs_err(got, want)
    del arm, twin, got, want
    torch.cuda.empty_cache()
    b_arm, b_twin = fresh(), fresh()
    out = measure(lambda: kk.observe(*b_arm, group=group),
                  lambda: kk.cross_shard_update(kk.observe_plain, *b_twin,
                                                group))
    del b_twin
    b_in = fresh()
    out.update(in_place_ms=cuda_ms(lambda: kk.observe(*b_in)),
               in_place_device_ms=device_ms(lambda: kk.observe(*b_in)))
    # K2's bytes (check_k2) and the arm's own: d zeroed, then logw += d
    # reads both and writes logw.
    nbytes = (4 * P * (3 + 2 + 10 * n_match + 5 * n_new) + 18 * K
              + 16 * P)
    ops = P * (n_match * OPS_MATCH + n_new * OPS_INIT)
    b_ms, by = bound(nbytes, ops)
    out.update(max_abs_err=err, in_place_max_abs_err=err_in_place,
               bit_equal_in_place=bit_equal, bytes=nbytes, ops=ops,
               bound_ms=b_ms, bound_by=by, share=b_ms / out["ms"],
               shape=f"K={K} L={L} P={P}, one landmark shard")
    print(f"kernel K2 cross-shard arm ({out['shape']}): {out['ms']:.4f} ms "
          f"(device {out['device_ms']}), in place {out['in_place_ms']:.4f} "
          f"ms (device {out['in_place_device_ms']}), twin's arm "
          f"{out['plain_ms']:.4f} ms, bound {b_ms:.4f} ms by {by}; "
          f"{'bit-equal to' if bit_equal else 'within TOL of'} the in-place "
          f"K2 (max abs err {err_in_place:.3g}), max_abs_err {err:.3g} "
          "against the twin's arm", flush=True)
    del b_arm, b_in, state, batch
    torch.cuda.empty_cache()
    return out


def check_g1_at_width(dev) -> dict:
    """Phase 17: G1 over the resample gather's 10 + 5L rows (L = 192:
    970) at P = 1,000,000, the one-rank ring_resample's arm at a P that
    is no multiple of 512: bit-equal to its twin and to index_select by
    the same ancestors, timed beside them, with its bound."""
    import torch

    from slam_tpu_torch.ops import resampling as rs
    from slam_tpu_torch.ops.kernels import gather as kg

    g = torch.Generator(device=dev).manual_seed(171)
    f32 = dict(dtype=torch.float32, device=dev)
    P, L = C5_JAX_P, C5_CAPACITY
    arrays = [torch.randn((c, P), generator=g, **f32) * 37
              for c in (10, 2 * L, 3 * L)]
    stacked = torch.cat(arrays)
    rows = stacked.shape[0]
    logw = torch.randn(P, generator=g, **f32) * 2.0
    sel = rs.stratified_indices(logw, rs.uniform_from_generator(P, g, dev))
    distinct = int(torch.unique(sel).numel())
    got = kg.sorted_gather_multi(arrays, sel)
    want = kg.sorted_gather_multi_plain(arrays, sel)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          "G1 at P = 1e6: not bit-equal to its twin")
    check(torch.equal(torch.index_select(stacked, 1, sel), torch.cat(got)),
          "G1 at P = 1e6: index_select gathers other values")
    del got, want
    torch.cuda.empty_cache()
    out = measure(lambda: kg.sorted_gather_multi(arrays, sel),
                  lambda: kg.sorted_gather_multi_plain(arrays, sel),
                  lambda: torch.index_select(stacked, 1, sel))
    nbytes = 4 * (rows * distinct + P + rows * P)
    b_ms, by = bound(nbytes, 0)
    out.update(max_abs_err=0.0, bytes=nbytes, ops=0, bound_ms=b_ms,
               bound_by=by, share=b_ms / out["ms"],
               shape=f"rows={rows} P={P} distinct={distinct}")
    print(f"kernel G1 ({out['shape']}): {out['ms']:.4f} ms (device "
          f"{out['device_ms']}), plain {out['plain_ms']:.4f} ms, "
          f"index_select {out['library_ms']:.4f} ms (device "
          f"{out['library_device_ms']}), bound {b_ms:.4f} ms by {by} "
          f"({nbytes:.4g} B), share {out['share']:.3f}; bit-equal to the "
          "twin and to index_select", flush=True)
    del arrays, stacked
    torch.cuda.empty_cache()
    return out


def check_ekf_mesh(dev) -> dict:
    """Phase 17 (r) ekf-10k-mesh: ShardedEkfSlam on make_mesh(1,
    axis="l") on (i)'s world, 640 ticks, seed 3, through Runner with no
    device named, and the same run with no mesh: 0 host syncs under
    set_sync_debug_mode("error"), S1 and E1 alone launched; est_pose and the
    final state bit-equal; the ATE below twice JAX_EKF_10K_ATE_M."""
    import numpy as np
    import torch

    from slam_tpu_torch.ops import kernels
    from slam_tpu_torch.parallel import make_mesh
    from slam_tpu_torch.parallel.ekf import ShardedEkfSlam
    from slam_tpu_torch.runtime import Runner, compute_metrics

    t0 = time.perf_counter()
    cfg, slam_map = ekf10k()
    T = EKF10K_TICKS // cfg.steps_per_observe
    runs, walls = {}, {}
    for name, mesh in (("no mesh", None), ("mesh", make_mesh(1, axis="l"))):
        runner = Runner(cfg, slam_map, "EKF1", estimator=ShardedEkfSlam(
            cfg, slam_map.n_landmarks, mesh))
        kernels.reset_launch_counts()
        with syncs_raise(runner, T) as done:
            result = runner.run(seed=3, n_ticks=EKF10K_TICKS)
        counts = kernels.launch_counts()
        check(done[0] == T and result.host_syncs == 0,
              f"ekf-10k-mesh ({name}): {done[0]} of {T} updates, "
              f"{result.host_syncs} host syncs")
        ekf_launches(f"ekf-10k-mesh ({name})", counts, T,
                     e1=EKF10K_TICKS)
        away = on_card(dev, runner, state_tensors(result.final_state))
        check(not away, f"ekf-10k-mesh ({name}): not on {dev}: {away}")
        runs[name] = result
        walls[name] = result.wall_seconds
    a, b = runs["no mesh"], runs["mesh"]
    check(np.array_equal(a.est_pose, b.est_pose),
          "ekf-10k-mesh: est_pose differs from the run with no mesh")
    check(all(torch.equal(x, y) for x, y in zip(
        state_tensors(a.final_state), state_tensors(b.final_state)))
          and a.final_state.hk_n == b.final_state.hk_n,
          "ekf-10k-mesh: the final state differs from the run with no mesh")
    ate = compute_metrics(b).ate_rmse
    bound_m = ATE_MARGIN * JAX_EKF_10K_ATE_M
    check(ate < bound_m, f"ekf-10k-mesh: ATE {ate} >= {bound_m}")
    out = dict(ate_rmse=ate, ate_bound=bound_m, n=int(b.final_state.n),
               host_syncs_per_superstep=0, wall_s=walls,
               steps_per_s={k: EKF10K_TICKS / w for k, w in walls.items()},
               bit_equal_to_no_mesh=True, launches=counts,
               launches_per_superstep={
                   "S1": 1.0, "E1": float(cfg.steps_per_observe)},
               seconds=time.perf_counter() - t0)
    print(f"slice ekf-10k-mesh: {json.dumps(out)}", flush=True)
    del runs, a, b
    torch.cuda.empty_cache()
    return out


def check_ba_mesh(dev, ba10k: dict) -> dict:
    """Phase 17 (s) ba-10k-mesh: solve_ba_sharded on make_ba_problem(256,
    10_000), 30 iterations, on a landmark mesh of one rank and on no
    mesh: the same poses and landmarks bit for bit, the same costs,
    trials and host reads; no kernel launched; the error below 0.2 of
    the dead-reckoned one (bench.py's first check). ms per LM trial by
    CUDA events, beside (j)'s solve_ba_device."""
    import numpy as np
    import torch

    from slam_tpu_torch.ops import kernels
    from slam_tpu_torch.parallel.mesh import mesh_over
    from slam_tpu_torch.posegraph import solve_ba_sharded
    from slam_tpu_torch.posegraph.synthetic import make_ba_problem

    t0 = time.perf_counter()
    prob, poses, poses0, _ = make_ba_problem(*BA10K_SHAPE)
    solves = {}
    kernels.reset_launch_counts()
    for name, mesh in (("no mesh", None),
                       ("mesh", mesh_over([0], (1,), ("l",)))):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        p, lm, info = solve_ba_sharded(prob, mesh, iters=BA10K_ITERS,
                                       return_info=True)
        end.record()
        torch.cuda.synchronize()
        solves[name] = (p, lm, info, start.elapsed_time(end)
                        / info["n_steps"])
    counts = kernels.launch_counts()
    check(not any(counts.values()), f"ba-10k-mesh: kernels launched {counts}")
    (p0, l0, i0, ms0), (p1, l1, i1, ms1) = solves["no mesh"], solves["mesh"]
    check(torch.equal(p0, p1) and torch.equal(l0, l1),
          "ba-10k-mesh: not bit-equal to the solve with no mesh")
    check(i0 == i1, f"ba-10k-mesh: {i1} against {i0}")
    check(l1.shape == (BA10K_SHAPE[1], 2), f"ba-10k-mesh: landmarks "
          f"{tuple(l1.shape)}")
    err_init = float(np.linalg.norm(poses0[:, :2] - poses[:, :2],
                                    axis=1).mean())
    err = float(np.linalg.norm(p1[:, :2].cpu().numpy() - poses[:, :2],
                               axis=1).mean())
    check(err < 0.2 * err_init, f"ba-10k-mesh: error {err} >= 0.2 x "
          f"{err_init}")
    out = dict(err=err, err_init=err_init, n_steps=i1["n_steps"],
               n_iters=i1["n_iters"], host_reads=i1["host_reads"],
               events_ms_per_trial={"no mesh": ms0, "mesh": ms1},
               j_events_ms_per_trial=ba10k["events_ms_per_trial"],
               bit_equal_to_no_mesh=True,
               seconds=time.perf_counter() - t0)
    print(f"ba-10k-mesh: {json.dumps(out)}", flush=True)
    return out


def check_config5_mesh(dev) -> dict:
    """Phase 17 (t) config5-mesh: run_config5() with JAX's defaults in the
    NCCL group: P = 1,000,000 on a (1, 1) mesh, capacity 192, 32
    supersteps, seed 3; JAX's rule takes LandmarkShardedFastSlam1 there
    (1e6 is no multiple of 512), so K2 with its cross-shard arm once per
    superstep (1e6 is no multiple of 128) and G1 on each fired resample,
    and none of K4, K5, K6, G2; one host sync (the gate) per superstep;
    tests/test_config5.py's checks; the filter's and the refined ATE
    below twice JAX_CONFIG5_ATE_M and JAX_CONFIG5_REFINED_ATE_M; a
    second run gives the same errors, bit for bit."""
    import torch

    from slam_tpu_torch.models import rbpf
    from slam_tpu_torch.ops import kernels
    from slam_tpu_torch.runtime import config5

    t0 = time.perf_counter()
    built = []
    cls = config5.LandmarkShardedFastSlam1

    def spy(*args, **kw):
        est = cls(*args, **kw)
        built.append((type(est).__name__, est.device, est.mesh.shape))
        return est
    config5.LandmarkShardedFastSlam1 = spy
    try:
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        syncs = rbpf.host_bool.count
        r = config5.run_config5()
        syncs = rbpf.host_bool.count - syncs
        counts = kernels.launch_counts()
    finally:
        config5.LandmarkShardedFastSlam1 = cls
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n = C5_SUPERSTEPS
    check(len(built) == 1 and built[0][1] == dev,
          f"config5-mesh: the filter built {built}")
    check(r.n_keyframes == n and r.n_landmarks_map == C5_LANDMARKS
          and r.n_landmarks_observed > 50, f"config5-mesh: {r}")
    check(all(math.isfinite(v) for v in (r.ate_filter, r.ate_refined,
                                         r.ba_seconds)),
          f"config5-mesh: non-finite result {r}")
    check(r.ate_refined < max(2.0 * r.ate_filter, 0.15),
          f"config5-mesh: refined ATE {r.ate_refined} against the "
          f"filter's {r.ate_filter}")
    check(r.ba_iters >= 1, "config5-mesh: no BA iteration")
    check(counts["K2"] == counts["S1"] == n and counts["G1"] > 0,
          f"config5-mesh: launches {counts} in {n} supersteps")
    for k in ("K4", "K5", "K6", "G2", "K3", "K6b", "F2", "K1"):
        check(counts[k] == 0, f"config5-mesh: {k} should not run {counts}")
    check(syncs == n, f"config5-mesh: {syncs} gate syncs in {n} supersteps")
    for key, anchor in (("ate_filter", JAX_CONFIG5_ATE_M),
                        ("ate_refined", JAX_CONFIG5_REFINED_ATE_M)):
        check(getattr(r, key) < ATE_MARGIN * anchor,
              f"config5-mesh: {key} {getattr(r, key)} >= "
              f"{ATE_MARGIN * anchor}")
    # 5 float32 planes per (particle, slot), on the card.
    check(peak * 2 ** 30 > 20 * C5_JAX_P * C5_CAPACITY,
          f"config5-mesh: peak device memory {peak} GiB")
    # A replay: the one-rank resample's prefix sum must round the same
    # way on every run (ops.resampling._cumsum_blocked).
    r2 = config5.run_config5()
    replay = ("ate_filter", "ate_refined", "n_landmarks_observed",
              "ba_iters")
    check(all(getattr(r, k) == getattr(r2, k) for k in replay),
          f"config5-mesh: a replay differs: {r2} against {r}")
    out = edge_slice(counts, n, result=r._asdict(), P=C5_JAX_P,
                     filter=built[0][0], host_syncs_per_superstep=1.0,
                     peak_gib=peak, seconds=time.perf_counter() - t0)
    print(f"slice config5-mesh: {json.dumps(out)}", flush=True)
    return out


def check_ckpt_sharded(dev, tmp) -> dict:
    """Phase 17 (u) ckpt-sharded: ShardedFastSlam1 on dense200 at
    P = 16,384 (make_mesh over the one rank, no device named), seed 3,
    through run_checkpointed in chunks of 50: unbroken to superstep 200,
    then cut at 150 (after the first sighting at 137) and resumed. One
    checkpoint file pair per run, holding the rank's Philox stream;
    the resumed run bit-equal to the unbroken one (traces and state)."""
    import os

    import numpy as np

    from slam_tpu_torch.ops import kernels
    from slam_tpu_torch.parallel import ShardedFastSlam1, make_mesh
    from slam_tpu_torch.runtime import Runner

    t0 = time.perf_counter()
    cfg, slam_map = dense200()
    period, N = cfg.steps_per_observe, EDGE_SUPERSTEPS
    mesh = make_mesh()

    def make():
        est = ShardedFastSlam1(cfg, slam_map.n_landmarks, mesh,
                               P_CKPT_SHARDED)
        return Runner(cfg, slam_map, "FASTSLAM1", n_particles=P_CKPT_SHARDED,
                      estimator=est)
    kw = dict(seed=3, every=SMALL_EVERY)
    kernels.reset_launch_counts()
    r = make()
    full = r.run_checkpointed(n_ticks=N * period, ckpt_path=os.path.join(
        tmp, "sharded-full", "run"), **kw)
    check(not on_card(dev, r, state_tensors(full.final_state)),
          f"ckpt-sharded: with no device named the run is not on {dev}")
    check(full.host_syncs == N, f"ckpt-sharded: {full.host_syncs} host "
          f"syncs in {N} supersteps")
    ck = os.path.join(tmp, "sharded-cut", "run")
    make().run_checkpointed(n_ticks=SMALL_CUT * period, ckpt_path=ck, **kw)
    files = sorted(os.listdir(os.path.dirname(ck)))
    check(files == ["run.json", "run.npz"], f"ckpt-sharded: files {files}")
    with open(ck + ".json") as fh:
        manifest = json.load(fh)
    with np.load(ck + ".npz") as data:
        streams = data["streams"]
    check(manifest["mesh_shape"] == [1] and manifest["superstep"]
          == SMALL_CUT and streams.shape[0] == 1,
          f"ckpt-sharded: manifest {manifest}, streams {streams.shape}")
    resumed = make().run_checkpointed(n_ticks=N * period, ckpt_path=ck,
                                      resume=True, **kw)
    counts = kernels.launch_counts()
    check(len(resumed.est_pose) == N - SMALL_CUT,
          f"ckpt-sharded: {len(resumed.est_pose)} resumed supersteps")
    same_run("ckpt-sharded", full, resumed)
    for k in ("K4", "G2"):
        check(counts[k] > 0, f"ckpt-sharded: {k} was never launched {counts}")
    for k in ("K2", "G1", "K5", "K6", "K3", "K6b", "F2", "K1"):
        check(counts[k] == 0, f"ckpt-sharded: {k} should not run {counts}")
    out = edge_slice(counts, 2 * N, P=P_CKPT_SHARDED, supersteps=N,
                     cut=SMALL_CUT, stream_state_bytes=int(streams.shape[1]),
                     host_syncs_per_superstep=1.0,
                     seconds=time.perf_counter() - t0)
    print(f"slice ckpt-sharded: bit-equal across a resume at {SMALL_CUT}; "
          f"{json.dumps(out)}", flush=True)
    return out


def check_mesh_paths(dev, ba10k: dict) -> dict:
    """Phase 17, in the NCCL group of phase 16: K2's cross-shard arm and
    G1 at JAX's default config #5 width (P = 1,000,000), then (r)
    ekf-10k-mesh, (s) ba-10k-mesh, (t) config5-mesh and (u)
    ckpt-sharded."""
    import torch

    from slam_tpu_torch.parallel.landmarks import make_mesh_2d

    t0 = time.perf_counter()
    k2_arm = check_k2_cross_shard(dev, make_mesh_2d(1, 1).get_group("l"))
    g1 = check_g1_at_width(dev)
    ekf = check_ekf_mesh(dev)
    ba = check_ba_mesh(dev, ba10k)
    torch.cuda.empty_cache()
    c5 = check_config5_mesh(dev)
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        ckpt = check_ckpt_sharded(dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"mesh phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return dict(k2_cross_shard=k2_arm, g1_at_width=g1,
                runs={"ekf-10k-mesh": ekf, "config5-mesh": c5,
                      "ckpt-sharded": ckpt}, ba=ba)


def check_bench_entry(dev) -> dict:
    """Phase 18: slam_tpu_torch.bench's primary line (fastslam1_webmap:
    FastSLAM 1, P = 100, 4000 ticks, seeds 3-5 and one 16000-tick run)
    and its ba_10k line, at bench.py's full sizes, through the module's
    functions with no device named. The primary JSON has bench.py's four
    keys; the line's ATE lies below its limit (twice the JAX package's
    mean on the same world, ticks and seeds) and ba_10k's error within
    5 % of the JAX package's (bench.py's two checks raise inside the
    line); K2 launches once per superstep and G1 at least once, R1 as
    often as G1 (each fired resample's bounds), nothing else.
    {"bench-fastslam1_webmap": slice}."""
    import torch

    from slam_tpu_torch import bench
    from slam_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    lines = bench.bench_run("FASTSLAM1", 100)
    counts = kernels.launch_counts()
    supersteps = (len(SEEDS) * 4000 + 4 * 4000) // T_PREDICT
    primary = bench.primary_json(lines)
    check(list(primary) == ["metric", "value", "unit", "vs_baseline"]
          and primary["metric"] == bench.PRIMARY_METRIC
          and primary["unit"] == "steps/s" and primary["vs_baseline"] is None
          and primary["value"] > 0,
          f"bench: the primary JSON {primary}")
    check(counts["K2"] == counts["S1"] == supersteps and counts["G1"] > 0
          and counts["R1"] == counts["G1"]
          and not any(n for k, n in counts.items()
                      if k not in ("K2", "G1", "S1", "R1")),
          f"bench fastslam1_webmap: launches {counts} in {supersteps} "
          "supersteps")
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    lines.update(bench.bench_ba_10k())
    check(not any(kernels.launch_counts().values()),
          f"bench ba_10k: kernels launched {kernels.launch_counts()}")
    check(lines["fastslam1_webmap"]["ate_limit"] is not None
          and lines["ba_10k"]["err_vs_jax_limit"] is not None,
          "bench: a line at bench.py's sizes has no limit")
    warnings = bench.accuracy_warnings(lines)
    check(not warnings, f"bench: over the limits {warnings}")
    print(f"bench primary JSON: {json.dumps(primary)}", flush=True)
    for name, line in lines.items():
        print(f"bench line {name}: {json.dumps(line)}", flush=True)
    seconds = time.perf_counter() - t0
    print(f"bench entry phase: {seconds:.1f} s", flush=True)
    return {"bench-fastslam1_webmap": dict(
        launches=counts,
        launches_per_superstep={k: n / supersteps for k, n in counts.items()
                                if n},
        primary=primary, lines=lines, seconds=seconds)}


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
        b_ms, by = (bound(st["bytes"], st["ops"]) if "latency_ms" not in st
                    else (st["latency_ms"], "latency"))
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
                      off=("K4", "K5", "K6", "G2", "K3", "K6b", "F2", "K1"),
                      per_superstep=("K2",))
    check(all(s == 1 for s in small["host_syncs_per_superstep"]),
          "eager-small: host syncs per superstep "
          f"{small['host_syncs_per_superstep']}")
    large = run_slice(dev, "eager-large", dense200(), "eager", P_LARGE,
                      TICKS, JAX_ANCHOR_ATE_M, on=("K4", "G2"),
                      off=("K2", "K5", "K6", "G1", "K3", "K6b", "F2", "K1"))
    c5 = run_config5_slice(dev, "config5", C5_P, C5_CAPACITY,
                           C5_SUPERSTEPS, SEEDS, JAX_CONFIG5_ATE_M,
                           JAX_CONFIG5_REFINED_ATE_M, on=("K5", "G2"))
    c5_points = {name: run_config5_slice(dev, name, P, cap, n, SEEDS[:1])
                 for name, P, cap, n in C5_POINTS}
    torch.cuda.empty_cache()
    deferred = run_slice(dev, "deferred-large", dense200(), "deferred",
                         P_LARGE, TICKS, JAX_ANCHOR_ATE_M, on=("K5", "K6"),
                         off=("K2", "G1", "K3", "K6b", "F2", "K1"))
    fs2_small = run_slice(dev, "fs2-small", dense200(), "fs2", P_SMALL,
                          TICKS, JAX_FS2_ANCHOR_ATE_M,
                          on=("K3", "K2", "G1", "F2"),
                          off=("K4", "K6b", "G2", "K5", "K6", "K1"),
                          per_superstep=("K2",))
    check(all(s == 1 for s in fs2_small["host_syncs_per_superstep"]),
          "fs2-small: host syncs per superstep "
          f"{fs2_small['host_syncs_per_superstep']}")
    # The heading known: F2 once a tick.
    check(fs2_small["launches"]["F2"] == len(SEEDS) * TICKS,
          f"fs2-small: F2 launched {fs2_small['launches']['F2']} times in "
          f"{len(SEEDS) * TICKS} ticks")
    from slam_tpu_torch.sim.simulator import Simulator
    print(f"fs2-1m world: max_obs K = {Simulator(*fs2_webmap()).max_obs}",
          flush=True)
    fs2_1m = run_slice(dev, "fs2-1m", fs2_webmap(), "fs2", FS2_P,
                       FS2_TICKS, JAX_FS2_WEBMAP_ATE_M,
                       on=("K6b", "K3", "K4", "G2"),
                       off=("K2", "G1", "K5", "K6", "F2", "K1"),
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
    ba10k = check_ba_10k(dev, card)

    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        ckpt_deferred = check_ckpt_deferred(dev, tmp)
        torch.cuda.empty_cache()
        ckpt_small = check_ckpt_small(dev, tmp)
        streams = check_stream(dev)
        check_cli(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    with nccl_group(dev):
        sharded = check_sharded(dev)
        torch.cuda.empty_cache()
        meshed = check_mesh_paths(dev, ba10k)
    torch.cuda.empty_cache()
    bench_entry = check_bench_entry(dev)

    # Main-path launches of each kernel: the sum of the counts of the
    # runs of phases 4, 12-14, 16, 17 and 18. K1 lies on no path (the JAX
    # package calls it only from tests); every slice checks that it
    # stayed at 0. The error is the largest over a kernel's checks (K4 at
    # three shapes and its cross-shard arm, K2 and its arm, G2 at two);
    # the times are those of its first check.
    slices = dict(zip(("eager-small", "eager-large", "config5",
                       "deferred-large", "fs2-small", "fs2-1m"),
                      (small, large, c5, deferred, fs2_small, fs2_1m)))
    slices.update(c5_points)
    # The slices that launch none of the nine estimator kernels (ba-10k:
    # checked in its phase); of them, E1 runs in those of the block EKF.
    ekf_slices = {"ekf-webmap": ekf_webmap, "ekf-dense200": ekf_dense200,
                  "ekf-10k": ekf_10k}
    slices.update(ekf_slices)
    ekf_slices["ba-10k"] = None
    # Phases 12-14: the checkpointed, resumed and streamed paths.
    slices["ckpt-deferred"] = ckpt_deferred
    slices.update(ckpt_small)
    slices.update(streams)
    # Phase 16: the sharded filters; phase 17: the mesh paths.
    slices.update(sharded["runs"])
    slices.update(meshed["runs"])
    # Phase 18: the bench entry's primary line (ba_10k launches none).
    slices.update(bench_entry)
    ekf_slices.update({"ckpt-ekf": None, "stream-ekf": None,
                       "ekf-10k-mesh": None, "ba-10k-mesh": None})
    no_e1 = [k for k in ekf_slices if k not in ("ekf-10k", "ekf-10k-mesh")]
    launches = {k: sum(s["launches"][k] for s in slices.values())
                for k in KERNELS}
    errs = {k: max(st["max_abs_err"] for n, st in kernel_stats.items()
                   if n.split()[0] == k) for k in KERNELS}
    errs["K4"] = max(errs["K4"], sharded["k4_cross_shard"]["max_abs_err"])
    errs["K2"] = max(errs["K2"], meshed["k2_cross_shard"]["max_abs_err"])
    fields = ("ms", "plain_ms", "device_ms", "bound_ms", "bound_by",
              "share", "bytes", "ops", "library_ms", "library_device_ms",
              "shape")
    table = []
    for name in ("K1", "K2", "K3", "K4", "K5", "K6", "K6b", "G1", "G2",
                 "S1", "E1", "F2", "R1"):
        st = kernel_stats[name]
        # S1 runs in every slice with a simulator, the EKFs' too; E1 in
        # the block EKF's.
        zero = {"S1": ("ba-10k", "ba-10k-mesh"),
                "E1": no_e1}.get(name, ekf_slices)
        row = dict(name=name, route="cuda", source=KERNELS[name][0],
                   replaces=KERNELS[name][1], launches=launches[name],
                   launches_per_superstep={
                       **{sl: s["launches_per_superstep"][name]
                          for sl, s in slices.items()
                          if name in s["launches_per_superstep"]},
                       **dict.fromkeys(zero, 0)},
                   max_abs_err=errs[name], **{f: st[f] for f in fields})
        if name == "K2":
            row.update({f: st[f] for f in (
                "k4_ms", "k4_device_ms", "ragged_P", "ragged_ms",
                "ragged_device_ms", "ragged_k4_ms", "ragged_k4_device_ms")},
                cross_shard=meshed["k2_cross_shard"])
        if name == "G1":
            row.update(at_width=meshed["g1_at_width"])
        if name == "K4":
            row.update(chunk=st["chunk"], shapes=[
                {f: s[f] for f in ("shape", "ms", "device_ms", "bound_ms",
                                   "threads_per_particle", "registers",
                                   "spill_store_bytes")}
                for n, s in kernel_stats.items() if n.split()[0] == "K4"],
                cross_shard=sharded["k4_cross_shard"])
        if name == "K5":
            row.update({f: st[f] for f in ("direct_ms", "direct_device_ms",
                                           "distinct", "live_sectors",
                                           "staged_tiles", "chunks")})
            full = kernel_stats["K5 full-10k"]
            row.update(full_10k={f: full[f] for f in (
                "shape", "ms", "device_ms", "bound_ms", "share", "bytes",
                "chunks", "distinct", "all_rows")})
        if name == "S1":
            row.update(long_device_ms=st["long_device_ms"])
        if name == "E1":
            row.update({f: st[f] for f in ("wrapper_host_us",
                                           "predict_host_us", "errors")})
        if name == "F2":
            row.update({f: st[f] for f in ("wrapper_host_us",
                                           "predict_host_us")})
        if name == "R1":
            row.update(fs2={f: kernel_stats["R1 fs2"][f] for f in fields})
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
