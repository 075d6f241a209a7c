"""The port's benchmark: the repository's ``bench.py`` lines, run on one
card through the port's own entry points.

    python -m slam_tpu_torch.bench [--out PATH]

It builds the CUDA kernels and reports the build's seconds, then holds
every kernel against its plain twin (``ops.kernels.selfcheck.run``; a
mismatch ends the run) before it times anything. Then it runs bench.py's
lines in bench.py's order (bench.py:446-520), under bench.py's names,
fields, seeds, ticks and best-of timing, each function here the
counterpart of the one there and callable on its own:

==========================  ==============================================
line                        bench.py source
==========================  ==============================================
fastslam1_webmap (primary)  bench_run (:109-152, :450)
ekf1_webmap                 bench_run (:475), seeds 3-8
fastslam2_webmap            bench_run (:476)
fastslam2_ring40_1024       bench_map_run (:201-244) for fastslam2_loop2_1024
fastslam1_dense200_131072   bench_map_run for fastslam1_loop902_131072
fastslam2_webmap_131072     bench_map_run (:486-487)
fastslam1_1m, fastslam2_1m  bench_particle_throughput (:155-198)
ekf_10k                     bench_ekf_10k (:247-272)
ba_10k                      bench_ba_10k (:347-400)
config5_composed, _cap256,  bench_config5 (:403-430), at :494-507's shapes
config5_full-10k
==========================  ==============================================

Everything named "webmap" runs on bench.py's fallback world
(``load_workload``): the reference's maps are not in this repository.
For the same reason bench.py's loop2 and loop902 lines run on
``data/ring40`` and ``data/dense200``, under names that say so.

Output, as bench.py's: the first line on stdout is the primary JSON
(``{"metric", "value", "unit", "vs_baseline"}``), logs go to stderr.
``vs_baseline`` is null: ``ref_baseline.json`` holds the reference C++
backend measured on another host. Each line carries bench.py's keys
(``ref_ate`` null: the reference's ATEs are on the absent maps), unrounded,
and ``host_syncs`` (the device-to-host reads of its first run's loop;
BA: of its first timed solve), ``compile_s`` (the kernel build before a
run's loop, or BA's first solve) and the kernels it launched. Where a JAX
anchor was measured on the line's world, ticks and seeds
(``runtime.anchors``), the line carries ``ate_limit``, ``ATE_MARGIN``
times the anchor (config #5: ``ate_filter_limit`` and
``ate_refined_limit``; ``ba_10k``: ``err_vs_jax`` and its limit). A
value not below its limit goes into ``ate_warn``; the primary JSON is
then printed again with it, as bench.py does (:513-516), and the run
exits 1. The lines, with the card's name and power limit, go to
``--out`` (default ``bench_lines_torch.json`` in the working directory;
never ``bench_lines.json``, which bench.py owns), rewritten after every
line with ``"complete": false`` until the last.

Where the port differs from bench.py:

- No fallback hides a failure. bench.py catches the 1M line's failure
  (:187-189), config #5's (:417-419) and every secondary line's
  (:508-509) and still exits 0; here an exception ends the run with a
  traceback and a non-zero exit.
- With no device named the run is on the card, and without one it raises
  (``device.default_device``); it never runs on the CPU unless a caller
  passes ``device="cpu"``, and then it has no kernel gate (every wrapper
  runs its twin there) and no card line.
- bench.py's ``rng_impl="rbg"`` (:176, :416) is the TPU's hardware
  generator: the port draws from its Philox streams and torch's
  generators instead.
- bench.py's "the backend is a TPU" (:168-169, :217-219) reads here as
  "the device is CUDA": there, and at a multiple of 512 particles,
  FastSLAM 1 runs ``FastSlam1Deferred``.
- bench.py's persistent XLA cache (:54-64) has no counterpart: the
  kernels' build directory (``ops.kernels.build``) plays its part.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from slam_tpu_torch.config import SlamConfig
from slam_tpu_torch.device import card_line, default_device
from slam_tpu_torch.maps import read_map_file, synthetic_map
from slam_tpu_torch.models import FastSlam1Deferred, rbpf
from slam_tpu_torch.ops import kernels
from slam_tpu_torch.ops.kernels import build, selfcheck
from slam_tpu_torch.parallel.ekf import ShardedEkfSlam
from slam_tpu_torch.posegraph import solve_ba_device
from slam_tpu_torch.posegraph.synthetic import make_ba_problem
from slam_tpu_torch.runtime import Runner, compute_metrics
from slam_tpu_torch.runtime import anchors as A
from slam_tpu_torch.runtime.config5 import config5_setup, run_config5

DATA = Path(__file__).resolve().parents[1] / "data"
PRIMARY_METRIC = "slam_steps_per_sec_chip_webmap_fastslam1_100p"
DEFAULT_OUT = "bench_lines_torch.json"
EKF_WEBMAP_SEEDS = (3, 4, 5, 6, 7, 8)
BA10K = (256, 10_000, 30)

# The JAX anchor of each ATE line, by the configuration it was measured
# at: (method, world, particles, ticks, seeds). A call at another
# configuration (a test's small one) has no anchor and no limit.
ATE_ANCHORS = {
    ("FASTSLAM1", "webmap", 100, 4000, (3, 4, 5)):
        A.JAX_FS1_WEBMAP_MEAN_ATE_M,
    ("EKF1", "webmap", None, 2000, EKF_WEBMAP_SEEDS):
        A.JAX_EKF_WEBMAP_MEAN_ATE_M,
    ("FASTSLAM2", "webmap", 100, 2000, (3, 4, 5)):
        A.JAX_FS2_WEBMAP_MEAN_ATE_M,
    ("FASTSLAM2", "ring40", 1024, 2000, (3, 4, 5)):
        A.JAX_FS2_RING40_MEAN_ATE_M,
    ("FASTSLAM1", "dense200", 2 ** 17, 800, (3, 4, 5)):
        A.JAX_FS1_DENSE200_131072_MEAN_ATE_M,
    ("FASTSLAM2", "webmap", 2 ** 17, 800, (3, 4, 5)):
        A.JAX_FS2_WEBMAP_131072_MEAN_ATE_M,
    ("EKF1", "ekf10k", None, 640, (3,)): A.JAX_EKF_10K_SEED3_ATE_M,
}
# bench.py's three config #5 shapes (particles, capacity, supersteps),
# held to the JAX package's config #5 anchors, which were taken at 1024
# particles and 32 supersteps (RMS over seeds 3-5): no JAX anchor exists
# at these widths.
CONFIG5_SHAPES = ((2 ** 20, 192, 32), (2 ** 20, 256, 16),
                  (32_768, 10_000, 16))


def _log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _limit(anchor):
    return None if anchor is None else A.ATE_MARGIN * anchor


def _launched() -> dict:
    return {k: n for k, n in kernels.launch_counts().items() if n}


def load_workload():
    """bench.py's load_workload without the reference data
    (bench.py:96-106): the heading unknown, a synthetic webmap-like
    map."""
    return SlamConfig(SWITCH_HEADING_KNOWN=0), synthetic_map(35, 17,
                                                             radius=100.0)


def load_map(mapname: str):
    """(config, map): the fallback world for "webmap", else
    ``data/<mapname>.{ini,mat}``."""
    if mapname == "webmap":
        return load_workload()
    return (SlamConfig.from_ini(str(DATA / f"{mapname}.ini")),
            read_map_file(str(DATA / f"{mapname}.mat")))


def _deferred_or_none(method, cfg, slam_map, n_particles, device):
    """bench.py's rule (:168-169, :217-219) with "the backend is a TPU"
    read as "the device is CUDA": FastSLAM 1 at a multiple of 512
    particles runs ``FastSlam1Deferred``; otherwise the method's own
    estimator (None)."""
    if (method == "FASTSLAM1" and FastSlam1Deferred.fits(n_particles)
            and device.type == "cuda"):
        return FastSlam1Deferred(cfg, slam_map.n_landmarks, device=device)
    return None


def _seed_runs(runner, n_ticks: int, seeds) -> dict:
    """One run per seed: the ATEs, the best wall and the first run's
    build seconds and host syncs."""
    ates, walls, first = [], [], None
    for seed in seeds:
        result = runner.run(seed=seed, n_ticks=n_ticks)
        ates.append(compute_metrics(result).ate_rmse)
        walls.append(result.wall_seconds)
        if first is None:
            first = dict(compile_s=result.compile_seconds,
                         host_syncs=result.host_syncs,
                         ticks=result.n_ticks)
        del result
    return dict(first, ates=ates, wall=min(walls))


def bench_run(method: str, n_particles, n_ticks: int = 4000,
              seeds=(3, 4, 5), device=None) -> dict:
    """A webmap line (bench.py:109-152): ATE averaged over ``seeds``,
    steps/s from the best wall over them and one 4x-long run on the
    first seed. {"<method>_webmap": line}."""
    device = default_device(device)
    cfg, slam_map = load_workload()
    kernels.reset_launch_counts()
    runner = Runner(cfg, slam_map, method, n_particles=n_particles,
                    device=device)
    r = _seed_runs(runner, n_ticks, seeds)
    steps_per_sec = r["ticks"] / max(r["wall"], 1e-9)
    t_res = runner.run(seed=seeds[0], n_ticks=4 * n_ticks)
    steps_per_sec = max(steps_per_sec,
                        t_res.n_ticks / max(t_res.wall_seconds, 1e-9))
    ate = sum(r["ates"]) / len(r["ates"])
    limit = _limit(ATE_ANCHORS.get((method, "webmap", n_particles, n_ticks,
                                    tuple(seeds))))
    _log(f"{method} p={n_particles or 'none'}: {steps_per_sec:,.0f} steps/s "
         f"ATE({len(seeds)}-seed) {ate:.3f} m (limit {limit}) ["
         + " ".join(f"{a:.2f}" for a in r["ates"]) + f"] build "
         f"{r['compile_s']:.2f}s best wall {r['wall']:.2f}s")
    return {f"{method.lower()}_webmap": dict(
        steps_per_sec=steps_per_sec, ate=ate, n_seeds=len(seeds),
        ref_ate=None, compile_s=r["compile_s"], ate_limit=limit,
        host_syncs=r["host_syncs"], launches=_launched())}


def bench_particle_throughput(n_particles: int = 1 << 20,
                              n_supersteps: int = 16,
                              method: str = "FASTSLAM1",
                              device=None) -> dict:
    """Particles per second at 2^20 on the fallback world
    (bench.py:155-198): the best of three runs of seed 3.
    {"<method>_1m": line}."""
    device = default_device(device)
    cfg, slam_map = load_workload()
    kernels.reset_launch_counts()
    runner = Runner(cfg, slam_map, method, n_particles=n_particles,
                    estimator=_deferred_or_none(method, cfg, slam_map,
                                                n_particles, device),
                    device=device)
    n_ticks = n_supersteps * cfg.steps_per_observe
    rates, first = [], None
    for _ in range(3):
        result = runner.run(seed=3, n_ticks=n_ticks)
        rates.append(result.n_ticks / max(result.wall_seconds, 1e-9))
        first = first or (result.compile_seconds, result.host_syncs)
        del result
    ticks_per_sec = max(rates)
    pps = ticks_per_sec * n_particles
    _log(f"{method} p={n_particles:,}: {ticks_per_sec:,.1f} ticks/s "
         f"=> {pps:,.3g} particle-steps/s "
         f"(runs: {', '.join(f'{r:,.0f}' for r in rates)})")
    return {f"{method.lower()}_1m": dict(
        ticks_per_sec=ticks_per_sec, particle_steps_per_sec=pps,
        n_particles=n_particles, compile_s=first[0], host_syncs=first[1],
        launches=_launched())}


def bench_map_run(method: str, mapname: str, n_particles: int,
                  n_ticks: int = 2000, seeds=(3, 4, 5), device=None) -> dict:
    """A map line (bench.py:201-244): steps/s from the best wall over
    ``seeds``, ATE averaged over them. ``mapname``: "webmap" (the
    fallback world) or a map of ``data/``. {"<method>_<map>_<P>":
    line}."""
    device = default_device(device)
    cfg, slam_map = load_map(mapname)
    kernels.reset_launch_counts()
    runner = Runner(cfg, slam_map, method, n_particles=n_particles,
                    estimator=_deferred_or_none(method, cfg, slam_map,
                                                n_particles, device),
                    device=device)
    r = _seed_runs(runner, n_ticks, seeds)
    steps_per_sec = r["ticks"] / max(r["wall"], 1e-9)
    ate = sum(r["ates"]) / len(r["ates"])
    limit = _limit(ATE_ANCHORS.get((method, mapname, n_particles, n_ticks,
                                    tuple(seeds))))
    _log(f"{method} {mapname} p={n_particles}: {steps_per_sec:,.0f} "
         f"steps/s ATE({len(seeds)}-seed) {ate:.3f} m (limit {limit}) ["
         + " ".join(f"{a:.3f}" for a in r["ates"]) + "]")
    return {f"{method.lower()}_{mapname}_{n_particles}": dict(
        steps_per_sec=steps_per_sec, ate=ate, n_seeds=len(seeds),
        ref_ate=None, n_particles=n_particles, compile_s=r["compile_s"],
        ate_limit=limit, host_syncs=r["host_syncs"], launches=_launched())}


def bench_ekf_10k(n_landmarks: int = 10_000, n_ticks: int = 640,
                  device=None) -> dict:
    """The landmark-block EKF at 10k landmarks (bench.py:247-272), seed
    3: ``ShardedEkfSlam`` with no mesh (bit-equal to a one-rank mesh).
    {"ekf_10k": line}."""
    device = default_device(device)
    cfg, slam_map = config5_setup(n_landmarks, capacity=n_landmarks,
                                  max_obs=96)
    est = ShardedEkfSlam(cfg, slam_map.n_landmarks, device=device)
    kernels.reset_launch_counts()
    result = Runner(cfg, slam_map, "EKF1", estimator=est).run(
        seed=3, n_ticks=n_ticks)
    m = compute_metrics(result)
    limit = _limit(ATE_ANCHORS.get(("EKF1", "ekf10k", None, n_ticks, (3,)))
                   if n_landmarks == 10_000 else None)
    _log(f"EKF sharded L={n_landmarks:,}: {m.steps_per_second:,.0f} "
         f"steps/s ATE {m.ate_rmse:.3f} m (limit {limit}) build "
         f"{result.compile_seconds:.2f}s")
    return {"ekf_10k": dict(
        steps_per_sec=m.steps_per_second, ate=m.ate_rmse,
        compile_s=result.compile_seconds, ate_limit=limit,
        host_syncs=result.host_syncs, launches=_launched())}


def bench_ba_10k(n_keyframes: int = 256, n_landmarks: int = 10_000,
                 iters: int = 30, device=None) -> dict:
    """Pose-graph BA over a 10k-landmark synthetic map
    (bench.py:347-400): a warm solve of one iteration, then ms per LM
    trial from the best of two solves, the mean pose error against the
    dead-reckoned start and against the MAP floor (the same solve
    started at the truth), and bench.py's two checks, which raise.
    {"ba_10k": line}."""
    device = default_device(device)
    prob, poses, poses0, lms = make_ba_problem(n_keyframes, n_landmarks,
                                               device=device)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    solve_ba_device(prob, iters=1, tol=0.0)
    _sync(device)
    t1 = time.perf_counter()
    dt, reads = float("inf"), None
    for _ in range(2):
        ts = time.perf_counter()
        p, _, info = solve_ba_device(prob, iters=iters, return_info=True)
        _sync(device)
        dt = min(dt, (time.perf_counter() - ts) / max(info["n_steps"], 1))
        reads = reads or info["host_reads"]

    def mean_err(q):
        return float(np.linalg.norm(q[:, :2].cpu().numpy() - poses[:, :2],
                                    axis=1).mean())
    init_err = float(np.linalg.norm(poses0[:, :2] - poses[:, :2],
                                    axis=1).mean())
    err = mean_err(p)
    prob_t = dataclasses.replace(
        prob, poses0=torch.tensor(poses, device=device),
        landmarks0=torch.tensor(lms, device=device))
    floor = mean_err(solve_ba_device(prob_t, iters=iters)[0])
    line = dict(ms_per_lm_step=dt * 1e3, err_init=init_err, err=err,
                map_floor=floor, n_steps=int(info["n_steps"]),
                compile_s=t1 - t0, host_syncs=reads, launches=_launched())
    if (n_keyframes, n_landmarks, iters) == BA10K:
        line.update(err_vs_jax=abs(err / A.JAX_BA10K_ERR_M - 1.0),
                    err_vs_jax_limit=A.BA_ERR_MARGIN)
    _log(f"BA {n_landmarks:,}-landmark x {n_keyframes} keyframes: "
         f"{dt * 1e3:.2f} ms/LM-trial wall ({info['n_steps']} trials, "
         f"first solve {t1 - t0:.1f}s), mean pose err {init_err:.3f} -> "
         f"{err:.3f} m (MAP floor {floor:.3f} m)")
    if not err < 0.2 * init_err:
        raise AssertionError(f"ba_10k: error {err} >= 0.2 x {init_err}")
    if not err < max(1.25 * floor, 0.05):
        raise AssertionError(f"ba_10k: error {err} against the MAP floor "
                             f"{floor}")
    return {"ba_10k": line}


def bench_config5(n_particles: int = 1 << 20, capacity: int = 192,
                  n_supersteps: int = 32, tag: str = "config5 composed",
                  device=None) -> dict:
    """BASELINE config #5 composed (bench.py:403-430): ``run_config5``
    on one device (``mesh_shape=(1, 1)``, no process group), seed 3.
    {"config5_<tag>": line}."""
    device = default_device(device)
    kernels.reset_launch_counts()
    syncs = rbpf.host_bool.count
    r = run_config5(n_particles=n_particles, mesh_shape=(1, 1),
                    capacity=capacity, n_supersteps=n_supersteps,
                    device=device)
    syncs = rbpf.host_bool.count - syncs
    bench_shape = (n_particles, capacity, n_supersteps) in CONFIG5_SHAPES
    _log(f"{tag} (FS1 p={n_particles:,} cap={capacity} on a 10k-landmark "
         f"map -> BA): {r.steps_per_second:,.1f} ticks/s "
         f"({r.particle_steps_per_second:,.3g} particle-steps/s), ATE "
         f"filter {r.ate_filter:.4f} m -> refined {r.ate_refined:.4f} m, "
         f"{r.n_landmarks_observed} landmarks instantiated, BA "
         f"{r.ba_seconds:.2f}s/{r.ba_iters} iters")
    return {tag.replace(" ", "_"): dict(
        ticks_per_sec=r.steps_per_second,
        particle_steps_per_sec=r.particle_steps_per_second,
        ate_filter=r.ate_filter, ate_refined=r.ate_refined,
        n_particles=n_particles, capacity=capacity,
        compile_s=r.filter_compile_seconds, host_syncs=syncs,
        ate_filter_limit=_limit(A.JAX_CONFIG5_ATE_M if bench_shape else None),
        ate_refined_limit=_limit(A.JAX_CONFIG5_REFINED_ATE_M if bench_shape
                                 else None),
        launches=_launched())}


def warm_up(device) -> float:
    """Build (or find) and load the kernels' library: the port's
    counterpart of bench.py's warm_up_device (:433-443), which absorbs
    device init; seconds."""
    t0 = time.perf_counter()
    if device.type == "cuda":
        build.load_library()
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    _log(f"kernel build + device init {seconds:.2f}s")
    return seconds


def primary_json(lines: dict) -> dict:
    """bench.py's primary JSON (:460-469) from the fastslam1_webmap
    line; ``vs_baseline`` null (no baseline measured on this host)."""
    return {"metric": PRIMARY_METRIC,
            "value": round(lines["fastslam1_webmap"]["steps_per_sec"], 1),
            "unit": "steps/s", "vs_baseline": None}


def accuracy_warnings(lines: dict) -> list:
    """Every value of a line that is not below its ``<key>_limit``."""
    return [dict(line=name, key=key[:-len("_limit")],
                 value=line[key[:-len("_limit")]], limit=limit)
            for name, line in lines.items()
            for key, limit in line.items()
            if key.endswith("_limit") and limit is not None
            and not line[key[:-len("_limit")]] < limit]


def main(argv=None, device=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m slam_tpu_torch.bench",
        description="bench.py's lines on the port, on the card.")
    parser.add_argument("--out", default=DEFAULT_OUT,
                        help=f"where the lines go (default {DEFAULT_OUT})")
    args = parser.parse_args(argv)
    out = Path(args.out)
    if out.name == "bench_lines.json":
        parser.error("bench_lines.json is bench.py's; pick another --out")
    t0 = time.perf_counter()
    device = default_device(device)
    card = card_line() if device.type == "cuda" else "cpu"
    _log(f"card: {card}; torch {torch.__version__} on {device}")
    record = dict(card=card, device=str(device), complete=False,
                  build_s=warm_up(device), gate=None, lines={})

    def write() -> None:
        out.write_text(json.dumps(record, indent=1, sort_keys=True))

    if device.type == "cuda":
        t1 = time.perf_counter()
        record["gate"] = selfcheck.run(device)
        _log(f"kernel gate: {len(record['gate'])} checks of the 9 kernels "
             f"against their twins held in {time.perf_counter() - t1:.1f}s "
             f"{json.dumps(record['gate'])}")
    else:
        _log("no kernel gate on the CPU: every wrapper runs its twin")

    def emit(line: dict) -> dict:
        record["lines"].update(line)
        write()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        return line

    primary = primary_json(emit(bench_run("FASTSLAM1", 100, device=device)))
    print(json.dumps(primary), flush=True)

    emit(bench_run("EKF1", None, n_ticks=2000, seeds=EKF_WEBMAP_SEEDS,
                   device=device))
    emit(bench_run("FASTSLAM2", 100, n_ticks=2000, device=device))
    emit(bench_map_run("FASTSLAM2", "ring40", 1024, device=device))
    emit(bench_map_run("FASTSLAM1", "dense200", 1 << 17, n_ticks=800,
                       device=device))
    emit(bench_map_run("FASTSLAM2", "webmap", 1 << 17, n_ticks=800,
                       device=device))
    emit(bench_particle_throughput(device=device))
    emit(bench_particle_throughput(method="FASTSLAM2", n_supersteps=8,
                                   device=device))
    emit(bench_ekf_10k(device=device))
    emit(bench_ba_10k(device=device))
    for (P, capacity, n_supersteps), tag in zip(
            CONFIG5_SHAPES, ("config5 composed", "config5 cap256",
                             "config5 full-10k")):
        emit(bench_config5(P, capacity, n_supersteps, tag=tag,
                           device=device))

    warnings = accuracy_warnings(record["lines"])
    if warnings:
        primary["ate_warn"] = warnings
        _log(f"ATE WARNINGS (not below the limit): {warnings}")
        print(json.dumps(primary), flush=True)
    record.update(complete=True, ate_warn=warnings,
                  seconds=time.perf_counter() - t0)
    write()
    _log(f"total bench time {record['seconds']:.1f}s")
    return 1 if warnings else 0


if __name__ == "__main__":
    sys.exit(main())
