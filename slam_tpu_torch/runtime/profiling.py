"""Device time on the card, from ``torch.profiler``: per call of a
function, and per superstep of a run.

``kernel_times(prof)`` sums a profile's kernels by name;
``device_ms(fn)`` is the mean device time of one call of ``fn`` (the
kernels it ran, summed). ``main`` profiles the run loop of one slice,
seed 3:

    python -m slam_tpu_torch.runtime.profiling [--slice SLICE] [--out DIR]

- ``config5`` (the default): BASELINE config #5's filter,
  ``FastSlam1Deferred`` at 2^20 particles, capacity 192, at most 96
  observations;
- ``eager-small``: FastSLAM 1 on data/dense200 at P = 100 (K2, G1);
- ``fs2-small``: FastSLAM 2 on data/dense200 at P = 100 (K3, K2, G1);
- ``ekf-webmap``: EKF1 (the dense ``EkfSlam``) on the world of the JAX
  package's ``ekf1_webmap`` line, heading unknown;
- ``ekf-10k``: the landmark-block ``ShardedEkfSlam`` on one card at 10k
  landmarks (``config5_setup(10_000, capacity=10_000, max_obs=96)``),
  the JAX package's ``ekf_10k`` line;
- ``ba-10k``: bundle adjustment alone, ``solve_ba_device`` (30
  iterations) on ``make_ba_problem(256, 10_000)``, the JAX package's
  ``ba_10k`` line.

A run goes ``--warm`` supersteps (dense200's vehicle first sees a
landmark at superstep 137, so those slices warm up for 150; the
webmap's at superstep 63, so 80), then
measures a window of ``--supersteps`` more, between two device syncs.
One run takes the window under the profiler: per superstep the device
time, the device events (kernels and copies) and the time of each
kernel. Two more runs take it without: the loop wall per superstep (and
the device busy share against it), the host syncs and the kernel
launches per superstep. ``config5`` then runs its filter for 32
supersteps and profiles config #5's BA stage on that run
(``problem_from_run``, ``solve_ba_sharded``, 12 iterations), as
``ba-10k`` profiles its solve (``profile_ba``): per LM trial the device
events, the device time, the host reads and the wall, and the shares of
a trial's device time that the Schur product W All^-1 W' and the
Cholesky factorization of the reduced system take (each timed alone at
the solve's first point). The last line is one JSON object; ``--out
DIR`` also writes the per-kernel table there. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


def kernel_times(prof) -> dict:
    """{kernel name: (device microseconds, calls)} over a finished
    profile's device events."""
    out = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        out[evt.key] = (float(us), int(evt.count))
    return out


def device_ms(fn, iters: int = 10):
    """Mean device milliseconds per call of ``fn``: every kernel it ran,
    summed, after two warm-up calls; None if the profiler saw no device
    time."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(t for t, _ in kernel_times(prof).values())
    return us / iters / 1e3 if us > 0 else None


def events_ms(fn, iters: int = 20) -> float:
    """Mean milliseconds per call of ``fn`` by CUDA events around
    ``iters`` back-to-back calls, after two warm-up calls."""
    for _ in range(2):
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


SLICES = ("config5", "eager-small", "fs2-small", "ekf-webmap", "ekf-10k",
          "ba-10k")
# (warm-up supersteps, measured supersteps) by default, per slice that
# runs the filter loop.
WINDOWS = {"config5": (16, 16), "eager-small": (150, 40),
           "fs2-small": (150, 40), "ekf-webmap": (80, 40),
           "ekf-10k": (16, 16)}
# Landmarks (and capacity) of the ekf-10k slice; keyframes and landmarks
# of the ba-10k problem.
EKF10K_LANDMARKS = 10_000
BA10K_SHAPE = (256, 10_000)
# Config #5's supersteps and BA iterations (the JAX package's
# run_config5 defaults), and ba_10k's iterations.
CONFIG5_SUPERSTEPS, CONFIG5_BA_ITERS, BA10K_ITERS = 32, 12, 30
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                    os.pardir, "data")


def slice_runner(name: str, device):
    """The Runner of a slice on ``device``."""
    from slam_tpu_torch.runtime.loop import Runner

    if name == "config5":
        from slam_tpu_torch.models import FastSlam1Deferred
        from slam_tpu_torch.runtime.config5 import config5_setup
        cfg, slam_map = config5_setup(10_000, capacity=192, max_obs=96)
        return Runner(cfg, slam_map, "FASTSLAM1", n_particles=2 ** 20,
                      estimator=FastSlam1Deferred(
                          cfg, slam_map.n_landmarks, device=device))
    if name == "ekf-10k":
        from slam_tpu_torch.parallel.ekf import ShardedEkfSlam
        from slam_tpu_torch.runtime.config5 import config5_setup
        cfg, slam_map = config5_setup(EKF10K_LANDMARKS,
                                      capacity=EKF10K_LANDMARKS, max_obs=96)
        return Runner(cfg, slam_map, "EKF1", estimator=ShardedEkfSlam(
            cfg, slam_map.n_landmarks, device=device))
    from slam_tpu_torch.config import SlamConfig
    from slam_tpu_torch.maps import read_map_file, synthetic_map
    if name == "ekf-webmap":
        return Runner(SlamConfig(SWITCH_HEADING_KNOWN=0),
                      synthetic_map(35, 17, radius=100.0), "EKF1",
                      device=device)
    cfg = SlamConfig.from_ini(os.path.join(DATA, "dense200.ini"))
    slam_map = read_map_file(os.path.join(DATA, "dense200.mat"))
    method = {"eager-small": "FASTSLAM1", "fs2-small": "FASTSLAM2"}[name]
    return Runner(cfg, slam_map, method, n_particles=100, device=device)


class _Windowed:
    """An estimator with another ``update``; every other attribute is
    the estimator's."""

    def __init__(self, est, update):
        self._est, self.update = est, update

    def __getattr__(self, name):
        return getattr(self._est, name)


def window_run(runner, seed: int, warm: int, n: int, prof=None) -> dict:
    """One run of ``warm + n`` supersteps whose last ``n`` are measured,
    from the end of update ``warm`` to the end of update ``warm + n``,
    each end a device sync: per superstep the host wall (ms), the host
    syncs and the kernel launches. ``prof``, a ``torch.profiler.profile``,
    is started and stopped at the two ends."""
    from slam_tpu_torch.models import rbpf
    from slam_tpu_torch.ops import kernels

    est = runner.est
    marks = []

    def mark():
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), rbpf.host_bool.count,
                      kernels.launch_counts()))

    def windowed(*args, **kw):
        out = est.update(*args, **kw)
        windowed.calls += 1
        if windowed.calls == warm:
            mark()
            if prof is not None:
                prof.start()
        elif windowed.calls == warm + n:
            mark()
            if prof is not None:
                prof.stop()
        return out
    windowed.calls = 0
    runner.est = _Windowed(est, windowed)
    try:
        runner.run(seed=seed,
                   n_ticks=(warm + n) * runner.config.steps_per_observe)
    finally:
        runner.est = est
    (t0, s0, l0), (t1, s1, l1) = marks
    return dict(wall_ms=(t1 - t0) / n * 1e3, host_syncs=(s1 - s0) / n,
                launches={k: (l1[k] - l0[k]) / n for k in l0
                          if l1[k] > l0[k]})


def profile_slice(name: str, warm: int, n: int, seed: int = 3,
                  top: int = 12) -> dict:
    """``profile_runner`` of a slice's runner on the card, and for
    config #5 its BA stage's ``profile_ba``; for ba-10k, ``profile_ba``
    alone."""
    from slam_tpu_torch.posegraph import (
        problem_from_run,
        solve_ba_device,
        solve_ba_sharded,
    )

    dev = torch.device("cuda", 0)
    if name == "ba-10k":
        from slam_tpu_torch.posegraph.synthetic import make_ba_problem
        prob = make_ba_problem(*BA10K_SHAPE, device=dev)[0]
        return dict(slice=name, ba=profile_ba(prob, solve_ba_device,
                                              BA10K_ITERS, top),
                    kernels=[], card=torch.cuda.get_device_name(0))
    runner = slice_runner(name, dev)
    out = dict(slice=name, **profile_runner(runner, warm, n, seed, top))
    if name == "config5":
        result = runner.run(seed=seed, n_ticks=CONFIG5_SUPERSTEPS
                            * runner.config.steps_per_observe)
        prob = problem_from_run(result, runner.config, device=dev)
        del result
        out["ba"] = profile_ba(prob, solve_ba_sharded, CONFIG5_BA_ITERS, top)
    return out


def ba_products(prob):
    """(W [3T, 2L], W All^-1, the reduced system S [3T, 3T]) of the first
    trial of a solve of ``prob`` (damping 1e-3): the operands of the
    Schur product and of the Cholesky factorization."""
    from slam_tpu_torch.models.ekf import full_f32
    from slam_tpu_torch.posegraph import ba

    poses, landmarks, static, plan, lam = ba._start(prob, 1e-3)
    with full_f32():
        App, W, All, _, _ = ba._gn_normal_blocks(
            poses, landmarks, *static[:6], static[6], prob.L, plan)
        WA = ba._times_blocks(W, ba._inv_2x2_blocks(ba._damped(All, lam)))
        S = App + lam * ba._eye(App.shape[0], App) - WA @ W.T
    return W, WA, S


def profile_ba(prob, solve, iters: int, top: int = 12) -> dict:
    """One solve of ``prob`` by ``solve`` (``solve_ba``,
    ``solve_ba_device`` or ``solve_ba_sharded``) under the profiler,
    after a warm-up solve; per LM trial its device events, device time
    and host reads, and the wall of an unprofiled solve (host clock,
    ended by a sync); the device times of the Schur product and of the
    Cholesky factorization alone, and their shares of a trial's device
    time (by CUDA events where the profiler sees no device time, as it
    sometimes does not for a bare cuBLAS product late in a long
    process); the peak device memory of the solve."""
    from slam_tpu_torch.models.ekf import full_f32
    from slam_tpu_torch.ops.kalman import cholesky_lower

    solve(prob, iters=iters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, _, info = solve(prob, iters=iters, return_info=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        solve(prob, iters=iters)
        torch.cuda.synchronize()
    n = info["n_steps"]
    per = {key: (us / n / 1e3, calls / n)
           for key, (us, calls) in kernel_times(prof).items()}
    device_trial = sum(v[0] for v in per.values())
    W, WA, S = ba_products(prob)
    parts = {}
    with full_f32():
        for name, fn in (("schur", lambda: WA @ W.T),
                         ("cholesky", lambda: cholesky_lower(S.mT))):
            ms = device_ms(fn)
            parts[f"{name}_ms"], parts[f"{name}_timed_by"] = (
                (ms, "device") if ms is not None else (events_ms(fn),
                                                       "events"))
            parts[f"{name}_share"] = (parts[f"{name}_ms"] / device_trial
                                      if device_trial else None)
    ranked = sorted(per.items(), key=lambda kv: -kv[1][0])
    return dict(
        T=prob.T, L=prob.L, iters=iters, n_steps=n,
        host_reads=info["host_reads"],
        host_reads_per_trial=info["host_reads"] / n,
        device_ms_per_trial=device_trial,
        events_per_trial=sum(v[1] for v in per.values()),
        wall_ms_per_trial=wall / n * 1e3,
        device_busy_share=device_trial * n / (wall * 1e3), **parts,
        peak_gib=peak,
        kernels=[dict(name=k, ms_per_trial=v[0], calls_per_trial=v[1])
                 for k, v in ranked[:top]])


def profile_runner(runner, warm: int, n: int, seed: int = 3,
                   top: int = 12) -> dict:
    """Per-superstep device time, device events and kernel table of a
    run over a window of ``n`` supersteps after ``warm``, and the loop
    wall, host syncs and launches per superstep of two unprofiled runs
    of the same window; the peak device memory of those two."""
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    window_run(runner, seed, warm, n, prof)
    per = {key: (us / n / 1e3, calls / n, us / 1e3 / max(calls, 1))
           for key, (us, calls) in kernel_times(prof).items()}
    torch.cuda.reset_peak_memory_stats()
    runs = [window_run(runner, seed, warm, n) for _ in range(2)]
    walls = [r["wall_ms"] for r in runs]
    device_time = sum(v[0] for v in per.values())
    ranked = sorted(per.items(), key=lambda kv: -kv[1][0])
    return dict(
        warm=warm, supersteps=n, seed=seed,
        device_ms_per_superstep=device_time,
        events_per_superstep=sum(v[1] for v in per.values()),
        loop_wall_ms_per_superstep=walls,
        steps_per_second=[runner.config.steps_per_observe / w * 1e3
                          for w in walls],
        device_busy_share=[device_time / w for w in walls],
        host_syncs_per_superstep=runs[0]["host_syncs"],
        launches_per_superstep=runs[0]["launches"],
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        kernels=[dict(name=k, ms_per_superstep=v[0],
                      calls_per_superstep=v[1], ms_per_call=v[2])
                 for k, v in ranked[:top]],
        card=torch.cuda.get_device_name(0))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--slice", choices=SLICES, default="config5")
    ap.add_argument("--warm", type=int, default=None,
                    help="warm-up supersteps (default: per slice)")
    ap.add_argument("--supersteps", type=int, default=None,
                    help="measured supersteps (default: per slice)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profiling needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    warm, n = WINDOWS.get(args.slice, (0, 0))
    t0 = time.perf_counter()
    res = profile_slice(args.slice, args.warm or warm, args.supersteps or n)
    res["seconds"] = time.perf_counter() - t0
    for k in res["kernels"]:
        print(f"{k['ms_per_superstep']:.4f} ms/superstep "
              f"{k['calls_per_superstep']:.3f} calls "
              f"{k['ms_per_call']:.4f} ms/call  {k['name'][:90]}",
              flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, f"profile-{args.slice}.json"),
                  "w") as fh:
            json.dump(res, fh, indent=1)
    if "ba" in res:
        for k in res["ba"]["kernels"]:
            print(f"BA {k['ms_per_trial']:.4f} ms/trial "
                  f"{k['calls_per_trial']:.3f} calls  {k['name'][:90]}",
                  flush=True)
    print(json.dumps({k: v for k, v in res.items() if k != "kernels"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
