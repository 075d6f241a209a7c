"""Device time on the card, from ``torch.profiler``: per call of a
function, and per superstep of a run.

``kernel_times(prof)`` sums a profile's kernels by name;
``device_ms(fn)`` is the mean device time of one call of ``fn`` (the
kernels it ran, summed). ``main`` profiles the run loop of BASELINE
config #5's filter (``FastSlam1Deferred`` at 2^20 particles, capacity
192, at most 96 observations, seed 3):

    python -m slam_tpu_torch.runtime.profiling [--out DIR]

It runs the loop once to warm up, then profiles a run of ``--short``
and one of ``--long`` supersteps, and reports per superstep the
difference of the two over the extra supersteps (set-up and the final
copies cancel): device time, device events (kernels and copies) and
the time of each kernel; then the loop wall of two unprofiled runs of
``--long`` supersteps and the device busy share. The last line is one
JSON object; ``--out DIR`` also writes the per-kernel table there.
Needs a CUDA card.
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


def profile_config5(short: int, long: int, seed: int = 3,
                    top: int = 12) -> dict:
    """Per-superstep device time, device events and kernel table of
    config #5's deferred filter, as the difference of a ``long`` and a
    ``short`` profiled run."""
    from slam_tpu_torch.models import FastSlam1Deferred
    from slam_tpu_torch.runtime.config5 import config5_setup
    from slam_tpu_torch.runtime.loop import Runner

    device = torch.device("cuda", 0)
    cfg, slam_map = config5_setup(10_000, capacity=192, max_obs=96)
    runner = Runner(cfg, slam_map, "FASTSLAM1", n_particles=2 ** 20,
                    estimator=FastSlam1Deferred(cfg, slam_map.n_landmarks,
                                                device=device))
    period = cfg.steps_per_observe
    runner.run(seed=seed, n_ticks=short * period)   # warm-up
    tables = []
    for n in (short, long):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            runner.run(seed=seed, n_ticks=n * period)
            torch.cuda.synchronize()
        tables.append(kernel_times(prof))
    extra = long - short
    per = {}
    for key in set(tables[0]) | set(tables[1]):
        t1, c1 = tables[1].get(key, (0.0, 0))
        t0, c0 = tables[0].get(key, (0.0, 0))
        per[key] = ((t1 - t0) / extra / 1e3, (c1 - c0) / extra,
                    t1 / 1e3 / max(c1, 1))
    walls = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        result = runner.run(seed=seed, n_ticks=long * period)
        walls.append(result.wall_seconds / long * 1e3)
        del result
    device_time = sum(v[0] for v in per.values())
    ranked = sorted(per.items(), key=lambda kv: -kv[1][0])
    return dict(
        slice="config5-deferred", supersteps=(short, long), seed=seed,
        device_ms_per_superstep=device_time,
        events_per_superstep=sum(v[1] for v in per.values()),
        loop_wall_ms_per_superstep=walls,
        device_busy_share=[device_time / w for w in walls],
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        kernels=[dict(name=k, ms_per_superstep=v[0],
                      calls_per_superstep=v[1], ms_per_call=v[2])
                 for k, v in ranked[:top]],
        card=torch.cuda.get_device_name(0))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--short", type=int, default=16)
    ap.add_argument("--long", type=int, default=32)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profiling needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    res = profile_config5(args.short, args.long)
    res["seconds"] = time.perf_counter() - t0
    for k in res["kernels"]:
        print(f"{k['ms_per_superstep']:.4f} ms/superstep "
              f"{k['calls_per_superstep']:.3f} calls "
              f"{k['ms_per_call']:.4f} ms/call  {k['name'][:90]}",
              flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "profile.json"), "w") as fh:
            json.dump(res, fh, indent=1)
    print(json.dumps({k: v for k, v in res.items() if k != "kernels"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
