#!/usr/bin/env python3
"""Smoke test of slam_tpu_torch, the PyTorch / CUDA port, on one NVIDIA
GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. Device: a CUDA card is required; prints its name and power limit
   (nvidia-smi) and turns TF32 off.
2. Build: compiles the CUDA kernels from slam_tpu_torch/csrc.
3. Kernels against their plain PyTorch twins on the card, at the shapes
   the main paths give them: K2 (K=15, P=100), K4 (K=15, L=200,
   P=2^17; and slice (f)'s K=9, L=40, P=2^20), G1 (P=100) and G2
   (P=2^17; and P=2^20 at L=40), over the 10 + 5L rows of the resample
   gather; K5 at config #5's shapes (K=96, L=192, P=2^20)
   with a fired resample; K6 (T=8, P=2^20) with the noise on and off;
   K3 (K=15, P=2^20) with matched and unmatched slots; K6b (T=8,
   P=2^20) with the noise on and off; K1 (K=15, P=2^20). Gathers must
   be bit-equal; float outputs within rtol 1e-5, atol 1e-5 (the kernels
   sum over k in another order than the twins, and the device libm
   rounds sin/cos/log differently from torch's), K3 within the JAX
   package's golden tolerances of the refinement (xv rtol 1e-4, atol
   1e-5; Pv rtol 1e-3, atol 1e-6), as its chain over K observations
   compounds rounding; headings (and K1's bearings) are compared
   wrapped, as one ulp at +-pi flips a wrapped value by 2 pi. Times
   each kernel and its twin with CUDA events.
4. FastSLAM 1 end to end through Runner + compute_metrics; the launch
   counters are reset before each run and read after it:
   (a) eager, data/dense200, P = 100, 2000 ticks, seeds 3, 4, 5: K2 and
       G1, and not K4 or G2;
   (b) the same at P = 131072: K4 and G2, and not K2 or G1;
   (c) config #5's filter, FastSlam1Deferred at P = 2^20 with capacity
       192, 256 ticks, seeds 3, 4, 5: K6 once per superstep, K5 and G2
       at least once per run, one host sync per superstep;
   (d) FastSlam1Deferred on dense200 at P = 131072, 2000 ticks, seeds 3,
       4, 5: K5 and K6, and not K2 or G1;
   then FastSLAM 2 through Runner with -method FASTSLAM2:
   (e) dense200 (heading known), P = 100, 2000 ticks, seeds 3, 4, 5:
       K3, K2 and G1, and not K4, K6b, G2, K5 or K6; two host syncs per
       superstep;
   (f) the JAX package's fastslam2_1m world (heading unknown,
       synthetic_map(35, 17, radius=100)), P = 2^20, 1024 ticks, seeds
       3, 4, 5: K6b once per superstep, K3, K4 and G2, and not K2, G1,
       K5 or K6; one host sync per superstep.
   No slice may launch K1, which lies on no path. Each 3-seed RMS ATE
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

The last line is the JSON result; the two lines before it are the
kernel table (JSON) and the card's name and power limit.
"""

from __future__ import annotations

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
ATE_MARGIN = 2.0

MAP, INI = "data/dense200.mat", "data/dense200.ini"
TICKS, SEEDS = 2000, (3, 4, 5)
P_SMALL, P_LARGE = 100, 131072
K_OBS, CAPACITY = 15, 200
# Config #5's filter stage on one card, as the JAX package's
# bench_config5 runs it: 10k landmarks, capacity 192, at most 96
# observations, 2^20 particles, 32 supersteps.
C5_LANDMARKS, C5_CAPACITY, C5_MAX_OBS = 10_000, 192, 96
C5_P, C5_TICKS = 2 ** 20, 256
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
    plain; the smaller of each pair."""
    p1 = cuda_ms(plain)
    k1 = cuda_ms(kernel)
    k2 = cuda_ms(kernel)
    p2 = cuda_ms(plain)
    return min(k1, k2), min(p1, p2)


def max_abs_err(got, want) -> float:
    return max(float((g.double() - w.double()).abs().max())
               for g, w in zip(got, want))


def check_kernels(dev) -> dict:
    """Phase 3: every kernel against its twin at main-path shapes."""
    import numpy as np
    import torch

    from slam_tpu_torch.ops import resampling as rs
    from slam_tpu_torch.ops.kernels import gather as kg
    from slam_tpu_torch.ops.kernels import kernels as kk

    rng = np.random.default_rng(0)
    g = torch.Generator(device=dev).manual_seed(0)
    f32 = dict(dtype=torch.float32, device=dev)
    results = {}

    def t(a, dtype=torch.float32):
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

    # K2: gathered planes of K observations at P particles.
    P, K = P_SMALL, K_OBS
    xv = t(rng.normal(size=(3, P)) * [[0.3], [0.3], [0.05]])
    rngk = rng.uniform(3.0, 25.0, K)
    brg = rng.uniform(-1.4, 1.4, K)
    lmx = t(rngk[:, None] * np.cos(brg)[:, None]
            + rng.normal(size=(K, P)) * 0.3)
    lmy = t(rngk[:, None] * np.sin(brg)[:, None]
            + rng.normal(size=(K, P)) * 0.3)
    A = rng.normal(size=(K, P)) * 0.2
    p00, p01, p11 = t(A * A + 0.02), t(0.3 * A * A), t(A * A + 0.03)
    z = t(np.column_stack([rngk + rng.normal(size=K) * 0.1,
                           brg + rng.normal(size=K) * 0.017]))
    matched = t(np.arange(K) % 5 != 4, torch.bool)
    args = (xv, lmx, lmy, p00, p01, p11, z, matched, R)
    got, want = kk.observe(*args), kk.observe_plain(*args)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **TOL)
    ms, plain_ms = timed_pair(lambda: kk.observe(*args),
                              lambda: kk.observe_plain(*args))
    results["K2"] = dict(max_abs_err=max_abs_err(got, want), ms=ms,
                         plain_ms=plain_ms, shape=f"K={K} P={P}")

    # K4 and G2 at the shapes of the FS1 slice (b) and of the FS2 slice
    # (f); the first of each is the one timed in the kernel table.
    fs2_K, fs2_L = fs2_shapes()
    results["K4"] = check_k4(dev, rng, g, P_LARGE, CAPACITY, K_OBS,
                             n_map=CAPACITY, live=120, n_match=10, n_new=4)
    results["K4 fs2-1m"] = check_k4(dev, rng, g, FS2_P, fs2_L, fs2_K,
                                    n_map=35, live=20, n_match=5, n_new=3)

    # G1 / G2: the resample gather's three row sets, 10 + 5L rows.
    for name, P, L in (("G1", P_SMALL, CAPACITY), ("G2", P_LARGE, CAPACITY),
                       ("G2 fs2-1m", FS2_P, fs2_L)):
        arrays = [torch.randn((c, P), generator=g, **f32) * 37
                  for c in (10, 2 * L, 3 * L)]
        logw = torch.randn(P, generator=g, **f32) * 2.0
        U = rs.uniform_from_generator(P, g, dev)
        if name == "G1":
            sel = rs.stratified_indices(logw, U)
            kernel, plain = kg.sorted_gather_multi, \
                kg.sorted_gather_multi_plain
        else:
            sel = rs.offspring_bounds(
                rs.cumulative_weights(rs.normalize_log_weights(logw)), P, U)
            kernel, plain = kg.bounds_gather_multi, \
                kg.bounds_gather_multi_plain
        got, want = kernel(arrays, sel), plain(arrays, sel)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            if not torch.equal(a, b):
                raise AssertionError(f"{name}: gather is not bit-equal")
        ms, plain_ms = timed_pair(lambda: kernel(arrays, sel),
                                  lambda: plain(arrays, sel))
        results[name] = dict(max_abs_err=max_abs_err(got, want), ms=ms,
                             plain_ms=plain_ms,
                             shape=f"rows={sum(a.shape[0] for a in arrays)}"
                                   f" P={P}")
        del got, want, arrays
    results["K5"] = check_k5(dev, rng, g)
    results["K6"] = check_k6(dev, g)
    results["K3"] = check_k3(dev, rng, g)
    results["K6b"] = check_k6b(dev, g)
    results["K1"] = check_k1(dev, rng, g)
    return results


def check_k4(dev, rng, g, P, L, K, *, n_map, live, n_match, n_new) -> dict:
    """K4 at K observations, L slots, P particles: ``live`` landmarks
    mapped, ``n_match`` of them observed, ``n_new`` new ones and one
    masked observation of a live landmark."""
    import numpy as np
    import torch

    from slam_tpu_torch.models.particles import init_particles
    from slam_tpu_torch.models.rbpf import associate_known, new_slots
    from slam_tpu_torch.ops.kernels import kernels as kk

    check(n_match + n_new + 1 == K and live + n_new <= min(n_map, L),
          "K4 input: inconsistent sizes")
    f32 = dict(dtype=torch.float32, device=dev)

    def t(a, dtype=torch.float32):
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

    state = init_particles(P, L, n_map, device=dev)
    truth = rng.uniform(-30.0, 30.0, size=(n_map, 2))
    table = np.full(n_map, -1, np.int32)
    table[:live] = rng.permutation(live)
    lm = np.zeros((2, L, P), np.float32)
    lm[:, table[:live]] = truth[:live].T[:, :, None]
    state.lm.copy_(t(lm) + 0.2 * torch.randn((2, L, P), generator=g,
                                             **f32))
    del lm
    state.lm_P[0, :live] = 0.05
    state.lm_P[1, :live] = 0.01
    state.lm_P[2, :live] = 0.04
    state.xv.copy_(0.1 * torch.randn((3, P), generator=g, **f32))
    state = state._replace(n=t(live, torch.int32),
                           da_table=t(table, torch.int32))
    ids_np = np.concatenate([rng.choice(live, n_match, replace=False),
                             np.arange(live, live + n_new), [7]]
                            ).astype(np.int32)
    d = truth[ids_np]
    z = t(np.column_stack([np.hypot(d[:, 0], d[:, 1]),
                           np.arctan2(d[:, 1], d[:, 0])]))
    ids = t(ids_np, torch.int32)
    zmask = t(np.arange(K) < K - 1, torch.bool)
    assoc, is_new = associate_known(state, ids, zmask)
    matched = assoc >= 0
    slot = torch.where(matched, assoc, 0).to(torch.int32)
    slot_new, ok = new_slots(state, is_new)
    check(int(matched.sum()) == n_match and int(ok.sum()) == n_new,
          f"K4 input: expected {n_match} matched and {n_new} new "
          "observations")

    def fresh():
        return (state.xv, state.logw.clone(), state.lm.clone(),
                state.lm_P.clone(), z, slot, matched, slot_new, ok, R)
    a_k, a_p = fresh(), fresh()
    kk.fused_update(*a_k)
    kk.fused_update_plain(*a_p)
    torch.cuda.synchronize()
    for a, b in zip(a_k[1:4], a_p[1:4]):
        torch.testing.assert_close(a, b, **TOL)
    err = max_abs_err(a_k[1:4], a_p[1:4])
    del a_k, a_p
    b_k, b_p = fresh(), fresh()
    ms, plain_ms = timed_pair(lambda: kk.fused_update(*b_k),
                              lambda: kk.fused_update_plain(*b_p))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                shape=f"K={K} L={L} P={P}")


def check_k5(dev, rng, g) -> dict:
    """K5 at config #5's shapes: 150 live landmarks of 192 slots, 70
    matched observations, 20 new ones, 6 masked (K = 96), and the
    offspring bounds of a fired resample."""
    import numpy as np
    import torch

    from slam_tpu_torch.models.particles import init_particles
    from slam_tpu_torch.models.rbpf import associate_known, new_slots
    from slam_tpu_torch.ops import resampling as rs
    from slam_tpu_torch.ops.kernels import kernels as kk

    P, L, K, n_map, live = C5_P, C5_CAPACITY, C5_MAX_OBS, 400, 150
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
    ids_np = np.concatenate([rng.choice(live, 70, replace=False),
                             np.arange(live, live + 20),
                             rng.choice(live, 6, replace=False)]
                            ).astype(np.int32)
    d = truth[ids_np]
    z = t(np.column_stack([np.hypot(d[:, 0], d[:, 1]),
                           np.arctan2(d[:, 1], d[:, 0])]))
    ids = t(ids_np, torch.int32)
    zmask = t(np.arange(K) < 90, torch.bool)
    assoc, is_new = associate_known(state, ids, zmask)
    matched = assoc >= 0
    slot = torch.where(matched, assoc, 0).to(torch.int32)
    slot_new, ok = new_slots(state, is_new)
    check(int(matched.sum()) == 70 and int(ok.sum()) == 20,
          "K5 input: expected 70 matched and 20 new observations")
    logw = torch.randn(P, generator=g, **f32)
    S = rs.offspring_bounds(
        rs.cumulative_weights(rs.normalize_log_weights(logw)), P,
        rs.uniform_from_generator(P, g, dev))
    check(not torch.equal(S, torch.arange(1, P + 1, device=dev,
                                          dtype=torch.int32)),
          "K5 input: the bounds are the identity")

    def args(lw):
        return (state.xv, lw, state.lm, state.lm_P, S, z, slot, matched,
                slot_new, ok, R)
    lw_k, lw_p = logw.clone(), logw.clone()
    got = (lw_k, *kk.resample_update(*args(lw_k)))
    want = (lw_p, *kk.resample_update_plain(*args(lw_p)))
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **TOL)
    err = max_abs_err(got, want)
    del got, want
    lw_k, lw_p = logw.clone(), logw.clone()
    ms, plain_ms = timed_pair(lambda: kk.resample_update(*args(lw_k)),
                              lambda: kk.resample_update_plain(
                                  *args(lw_p)))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                shape=f"K={K} L={L} P={P}")


def check_k6(dev, g) -> dict:
    """K6 over T = 8 ticks at P = 2^20, draw for draw against its twin,
    with the noise on (the main path's arm, timed) and off."""
    import torch

    from slam_tpu_torch.geometry import wrap_angle
    from slam_tpu_torch.ops.kernels import predict as kp

    P, T = C5_P, T_PREDICT
    f32 = dict(dtype=torch.float32, device=dev)
    xv = torch.randn((3, P), generator=g, **f32)
    ctl = torch.stack([3.0 + 0.3 * torch.randn(T, generator=g, **f32),
                       0.1 * torch.randn(T, generator=g, **f32)], dim=1)
    seed = torch.randint(-2 ** 31, 2 ** 31, (2,), dtype=torch.int32,
                         generator=g, device=dev)
    err = 0.0
    for noise in (False, True):
        kw = dict(wheelbase=4.0, dt=0.025, add_noise=noise)
        got = kp.fs1_predict_multi(xv.clone(), seed, ctl, Q, **kw)
        want = kp.fs1_predict_multi_plain(xv.clone(), seed, ctl, Q, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got[:2], want[:2], **TOL)
        dth = wrap_angle(got[2] - want[2])
        torch.testing.assert_close(dth, torch.zeros_like(dth), **TOL)
        err = max(err, max_abs_err([got[:2], dth],
                                   [want[:2], torch.zeros_like(dth)]))
    a, b = xv.clone(), xv.clone()
    ms, plain_ms = timed_pair(
        lambda: kp.fs1_predict_multi(a, seed, ctl, Q, **kw),
        lambda: kp.fs1_predict_multi_plain(b, seed, ctl, Q, **kw))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                shape=f"T={T} P={P}")


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
    ms, plain_ms = timed_pair(lambda: kk.fs2_refine(*args),
                              lambda: kk.fs2_refine_plain(*args))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                shape=f"K={K} P={P}")


def check_k6b(dev, g) -> dict:
    """K6b over T = 8 ticks at P = 2^20, draw for draw against its twin,
    with the noise on and off (the main path's arm, as
    SWITCH_PREDICT_NOISE defaults to 0, timed)."""
    import torch

    from slam_tpu_torch.ops.kernels import predict as kp

    P, T = FS2_P, T_PREDICT
    f32 = dict(dtype=torch.float32, device=dev)
    xv = torch.randn((3, P), generator=g, **f32)
    Pv = torch.zeros((6, P), **f32)
    Pv[0], Pv[3], Pv[5] = 0.02, 0.02, 0.01
    ctl = torch.stack([3.0 + 0.3 * torch.randn(T, generator=g, **f32),
                       0.1 * torch.randn(T, generator=g, **f32)], dim=1)
    seed = torch.randint(-2 ** 31, 2 ** 31, (2,), dtype=torch.int32,
                         generator=g, device=dev)
    err = 0.0
    for noise in (True, False):
        kw = dict(wheelbase=4.0, dt=0.025, add_noise=noise)
        got = kp.fs2_predict_multi(xv.clone(), Pv.clone(), seed, ctl, Q,
                                   **kw)
        want = kp.fs2_predict_multi_plain(xv.clone(), Pv.clone(), seed, ctl,
                                          Q, **kw)
        torch.cuda.synchronize()
        err = max(err, compare_poses(got[0], want[0], TOL))
        torch.testing.assert_close(got[1], want[1], **TOL)
        err = max(err, max_abs_err([got[1]], [want[1]]))
    a, b = (xv.clone(), Pv.clone()), (xv.clone(), Pv.clone())
    ms, plain_ms = timed_pair(
        lambda: kp.fs2_predict_multi(*a, seed, ctl, Q, **kw),
        lambda: kp.fs2_predict_multi_plain(*b, seed, ctl, Q, **kw))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                shape=f"T={T} P={P} noise off")


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
    ms, plain_ms = timed_pair(lambda: kk.jacobians(xv, *planes, R), plain)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                shape=f"K={K} P={P}")


def dense200():
    from slam_tpu_torch.config import SlamConfig
    from slam_tpu_torch.maps import read_map_file
    return SlamConfig.from_ini(INI), read_map_file(MAP)


def config5():
    from slam_tpu_torch.runtime.config5 import config5_setup
    return config5_setup(C5_LANDMARKS, capacity=C5_CAPACITY,
                         max_obs=C5_MAX_OBS)


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
    "deferred-per-tick" (FastSlam1Deferred with the per-tick predict)."""
    from slam_tpu_torch.models import FastSlam1Deferred
    from slam_tpu_torch.runtime import Runner
    if kind in ("eager", "fs2"):
        method = "FASTSLAM2" if kind == "fs2" else "FASTSLAM1"
        runner = Runner(cfg, slam_map, method, n_particles=P, device=dev)
    else:
        est = FastSlam1Deferred(cfg, slam_map.n_landmarks, device=dev,
                                fused_predict=kind == "deferred")
        runner = Runner(cfg, slam_map, "FASTSLAM1", n_particles=P,
                        estimator=est)
    result = runner.run(seed=seed, n_ticks=ticks)
    final = (runner.est.finalize(result.final_state)
             if hasattr(runner.est, "finalize") else result.final_state)
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
    bound = ATE_MARGIN * anchor
    check(rms < bound, f"{name}: RMS ATE {rms} >= {bound}")
    summary = dict(P=P, ate_rmse_3seed=rms, ates=ates, steps_per_s=rates,
                   host_syncs_per_superstep=syncs, launches=total,
                   ate_bound=bound,
                   peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    print(f"slice {name}: {json.dumps(summary)}", flush=True)
    return summary


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

    kernel_stats = check_kernels(dev)
    for name, st in kernel_stats.items():
        print(f"kernel {name} ({st['shape']}): {st['ms']:.4f} ms, plain "
              f"{st['plain_ms']:.4f} ms, max_abs_err {st['max_abs_err']:.3g}"
              f" [{card}]", flush=True)
    torch.cuda.empty_cache()

    small = run_slice(dev, "eager-small", dense200(), "eager", P_SMALL,
                      TICKS, JAX_ANCHOR_ATE_M, on=("K2", "G1"),
                      off=("K4", "K5", "K6", "G2", "K3", "K6b", "K1"))
    large = run_slice(dev, "eager-large", dense200(), "eager", P_LARGE,
                      TICKS, JAX_ANCHOR_ATE_M, on=("K4", "G2"),
                      off=("K2", "K5", "K6", "G1", "K3", "K6b", "K1"))
    c5 = run_slice(dev, "config5", config5(), "deferred", C5_P, C5_TICKS,
                   JAX_CONFIG5_ATE_M, on=("K5", "K6", "G2"),
                   off=("K2", "G1", "K3", "K6b", "K1"),
                   per_superstep=("K6",))
    check(all(s == 1 for s in c5["host_syncs_per_superstep"]),
          f"config5: host syncs per superstep {c5['host_syncs_per_superstep']}")
    deferred = run_slice(dev, "deferred-large", dense200(), "deferred",
                         P_LARGE, TICKS, JAX_ANCHOR_ATE_M, on=("K5", "K6"),
                         off=("K2", "G1", "K3", "K6b", "K1"))
    fs2_small = run_slice(dev, "fs2-small", dense200(), "fs2", P_SMALL,
                          TICKS, JAX_FS2_ANCHOR_ATE_M, on=("K3", "K2", "G1"),
                          off=("K4", "K6b", "G2", "K5", "K6", "K1"))
    check(all(s == 2 for s in fs2_small["host_syncs_per_superstep"]),
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

    # Main-path launches of each kernel: the sum of the counts of the
    # phase-4 runs. K1 lies on no path (the JAX package calls it only
    # from tests); every slice checks that it stayed at 0. The error is
    # the largest over a kernel's checks (K4 and G2 at two shapes each);
    # the times are those of its first check.
    slices = (small, large, c5, deferred, fs2_small, fs2_1m)
    launches = {k: sum(s["launches"][k] for s in slices)
                for k in KERNELS}
    errs = {k: max(st["max_abs_err"] for n, st in kernel_stats.items()
                   if n.split()[0] == k) for k in KERNELS}
    table = [dict(name=name, route="cuda", source=KERNELS[name][0],
                  replaces=KERNELS[name][1], launches=launches[name],
                  max_abs_err=errs[name],
                  ms=kernel_stats[name]["ms"],
                  plain_ms=kernel_stats[name]["plain_ms"])
             for name in ("K1", "K2", "K3", "K4", "K5", "K6", "K6b", "G1",
                          "G2")]
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": table}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
