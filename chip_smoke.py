#!/usr/bin/env python3
"""Smoke test of slam_tpu_torch, the PyTorch / CUDA port, on one NVIDIA
GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. Device: a CUDA card is required; prints its name and power limit
   (nvidia-smi) and turns TF32 off.
2. Build: compiles the CUDA kernels from slam_tpu_torch/csrc.
3. Kernels against their plain PyTorch twins on the card, at the shapes
   the main path gives them: K2 (K=15, P=100), K4 (K=15, L=200,
   P=2^17), G1 (P=100) and G2 (P=2^17), both over the 10 + 5L rows of
   the resample gather. Gathers must be bit-equal; float outputs within
   rtol 1e-5, atol 1e-5 (the kernels sum over k in another order than
   the twins, and the device libm rounds sin/cos/log differently from
   torch's). Times both with CUDA events.
4. FastSLAM 1 end to end through Runner + compute_metrics, as the CLI
   runs it, on data/dense200 for 2000 ticks and seeds 3, 4, 5:
   (a) P = 100 must run through K2 and G1, (b) P = 131072 through K4 and
   G2, as the launch counters show; in both the 3-seed RMS ATE must be
   finite and below twice the JAX package's (JAX_ANCHOR_ATE_M).
5. Replay: the same seed at P = 131072 twice gives bit-identical
   estimates (no reduction or scan on the path rounds by timing).

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
ATE_MARGIN = 2.0

MAP, INI = "data/dense200.mat", "data/dense200.ini"
TICKS, SEEDS = 2000, (3, 4, 5)
P_SMALL, P_LARGE = 100, 131072
K_OBS, CAPACITY = 15, 200
TOL = dict(rtol=1e-5, atol=1e-5)
R = [[0.01, 0.0], [0.0, 0.0003]]

KERNELS = {
    "K2": ("slam_tpu_torch/csrc/observe.cu",
           "slam_tpu/ops/pallas/kernels.py:151"),
    "K4": ("slam_tpu_torch/csrc/fused_update.cu",
           "slam_tpu/ops/pallas/kernels.py:409"),
    "G1": ("slam_tpu_torch/csrc/gather.cu",
           "slam_tpu/ops/pallas/gather.py:128"),
    "G2": ("slam_tpu_torch/csrc/gather.cu",
           "slam_tpu/ops/pallas/gather.py:371"),
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

    from slam_tpu_torch.models.particles import init_particles
    from slam_tpu_torch.models.rbpf import associate_known, new_slots
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

    # K4: a state with 120 live landmarks; 10 matched, 4 new, 1 masked.
    P, L, n_map = P_LARGE, CAPACITY, CAPACITY
    state = init_particles(P, L, n_map, device=dev)
    truth = rng.uniform(-30.0, 30.0, size=(n_map, 2))
    live = 120
    table = np.full(n_map, -1, np.int32)
    table[:live] = rng.permutation(live)
    lm = np.zeros((2, L, P), np.float32)
    lm[:, table[:live]] = truth[:live].T[:, :, None]
    state.lm.copy_(t(lm) + 0.2 * torch.randn((2, L, P), generator=g,
                                             **f32))
    state.lm_P[0, :live] = 0.05
    state.lm_P[1, :live] = 0.01
    state.lm_P[2, :live] = 0.04
    state.xv.copy_(0.1 * torch.randn((3, P), generator=g, **f32))
    state = state._replace(n=t(live, torch.int32),
                           da_table=t(table, torch.int32))
    ids_np = np.concatenate([rng.choice(live, 10, replace=False),
                             [150, 151, 152, 153], [7]]).astype(np.int32)
    d = truth[ids_np]
    z = t(np.column_stack([np.hypot(d[:, 0], d[:, 1]),
                           np.arctan2(d[:, 1], d[:, 0])]))
    ids = t(ids_np, torch.int32)
    zmask = t(np.arange(K) < K - 1, torch.bool)
    assoc, is_new = associate_known(state, ids, zmask)
    matched = assoc >= 0
    slot = torch.where(matched, assoc, 0).to(torch.int32)
    slot_new, ok = new_slots(state, is_new)
    check(int(matched.sum()) == 10 and int(ok.sum()) == 4,
          "K4 input: expected 10 matched and 4 new observations")

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
    b_k, b_p = fresh(), fresh()
    ms, plain_ms = timed_pair(lambda: kk.fused_update(*b_k),
                              lambda: kk.fused_update_plain(*b_p))
    results["K4"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         shape=f"K={K} L={L} P={P}")
    del a_k, a_p, b_k, b_p, state

    # G1 / G2: the resample gather's three row sets, 10 + 5L rows.
    for name, P in (("G1", P_SMALL), ("G2", P_LARGE)):
        arrays = [torch.randn((c, P), generator=g, **f32) * 37
                  for c in (10, 2 * CAPACITY, 3 * CAPACITY)]
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
    return results


def run_slice(dev, P: int, on: tuple, off: tuple) -> tuple[dict, dict]:
    """Phase 4: three seeds of FastSLAM 1 at P particles through the
    CLI's path; checks the kernels launched and the ATE bound."""
    import numpy as np
    import torch

    from slam_tpu_torch.config import SlamConfig
    from slam_tpu_torch.maps import read_map_file
    from slam_tpu_torch.ops import kernels
    from slam_tpu_torch.runtime import Runner, compute_metrics

    cfg = SlamConfig.from_ini(INI)
    slam_map = read_map_file(MAP)
    ates, rates, syncs = [], [], []
    kernels.reset_launch_counts()
    for seed in SEEDS:
        runner = Runner(cfg, slam_map, "FASTSLAM1", n_particles=P,
                        device=dev)
        result = runner.run(seed=seed, n_ticks=TICKS)
        m = compute_metrics(result)
        T = TICKS // cfg.steps_per_observe
        check(result.est_pose.shape == (T, 3),
              f"est_pose shape {result.est_pose.shape}")
        check(np.isfinite(result.est_pose).all(), "non-finite pose")
        fs = result.final_state
        check(fs.lm.shape == (2, runner.est.capacity, P),
              f"landmark planes {tuple(fs.lm.shape)}")
        check(bool(torch.isfinite(fs.logw).all()), "non-finite weights")
        check(int(fs.n) > 0, "no landmark was mapped")
        check(math.isfinite(m.ate_rmse), "non-finite ATE")
        ates.append(m.ate_rmse)
        rates.append(m.steps_per_second)
        syncs.append(m.host_syncs_per_superstep)
        print(f"  P={P} seed={seed}: {m.summary()}", flush=True)
    counts = kernels.launch_counts()
    for k in on:
        check(counts[k] > 0, f"P={P}: {k} was never launched {counts}")
    for k in off:
        check(counts[k] == 0, f"P={P}: {k} should not run {counts}")
    rms = float(np.sqrt(np.mean(np.square(ates))))
    bound = ATE_MARGIN * JAX_ANCHOR_ATE_M
    check(rms < bound, f"P={P}: RMS ATE {rms} >= {bound}")
    summary = dict(P=P, ate_rmse_3seed=rms, ates=ates,
                   steps_per_s=rates, host_syncs_per_superstep=syncs,
                   launches=counts, ate_bound=bound)
    print(f"slice P={P}: {json.dumps(summary)}", flush=True)
    return summary, counts


def check_replay(dev) -> None:
    """Phase 5: a seed replays bit for bit on the card."""
    import numpy as np

    from slam_tpu_torch.config import SlamConfig
    from slam_tpu_torch.maps import read_map_file
    from slam_tpu_torch.runtime import Runner

    cfg = SlamConfig.from_ini(INI)
    slam_map = read_map_file(MAP)
    poses = [Runner(cfg, slam_map, "FASTSLAM1", n_particles=P_LARGE,
                    device=dev).run(seed=SEEDS[0], n_ticks=400).est_pose
             for _ in range(2)]
    if not np.array_equal(poses[0], poses[1]):
        raise AssertionError("replay: the same seed gave other estimates")
    print(f"replay P={P_LARGE} seed={SEEDS[0]}: bit-identical", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this smoke test needs an NVIDIA GPU")
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

    _, counts_a = run_slice(dev, P_SMALL, on=("K2", "G1"), off=("K4", "G2"))
    _, counts_b = run_slice(dev, P_LARGE, on=("K4", "G2"), off=("K2", "G1"))
    launches = {"K2": counts_a["K2"], "G1": counts_a["G1"],
                "K4": counts_b["K4"], "G2": counts_b["G2"]}
    check_replay(dev)

    table = [dict(name=name, route="cuda", source=KERNELS[name][0],
                  replaces=KERNELS[name][1], launches=launches[name],
                  max_abs_err=kernel_stats[name]["max_abs_err"],
                  ms=kernel_stats[name]["ms"],
                  plain_ms=kernel_stats[name]["plain_ms"])
             for name in ("K2", "K4", "G1", "G2")]
    print(json.dumps({"kernels": table}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
