"""Driver: back-to-back ``Runner.run`` of a FastSLAM 2 configuration.

A unit is one whole run of ``supersteps_per_run`` supersteps from its
own seed: the estimator's state made anew (an empty map), the superstep
loop, the traces copied to the host, each end behind a device sync
(``Runner.run``, as the command line's ``-method FASTSLAM2`` runs it).
The estimator is ``FastSlam2``; the world a map file of the repository
(``benchmark.map_file``). The traffic gives the run length, the copies
(``capture``: ``runs`` of the first ``within`` runs, between
``per_run[0]`` and ``per_run[1]`` supersteps each, drawn from the seed,
and superstep 0 of the first copied run, the filter's start) and the
profiled sub-window (``trace``: run index, first superstep,
supersteps). ``Fs2Recorder`` makes the copies; ``benchmark.fs2_checks``
judges them.

The traced run's record also counts, from its traces, the supersteps of
the sub-window (``window_supersteps``) and the observations K3 refined
there (``window_matched``: those of a landmark already in the map,
which the shared id table matches), which ``k3_roofline`` reads.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import fs2_checks
from benchmark.filter_cell import TRACE_KEYS, FilterCell
from benchmark.fs2_recorder import Fs2Recorder
from benchmark.recorder import particle_dict
from benchmark.map_file import file_world

WARM_SEED = 12345


def matched_counts(obs_ids, obs_mask, capacity: int) -> list:
    """Per superstep of a run from an empty map, how many of its
    observations the id table matches: ids seen on an earlier superstep
    that got a slot (new ids take slots in order while any is free)."""
    mapped, out = set(), []
    for ids, mask in zip(obs_ids, obs_mask):
        now = [int(i) for i in ids[mask]]
        out.append(sum(i in mapped for i in now))
        for i in now:
            if i not in mapped and len(mapped) < capacity:
                mapped.add(i)
    return out


class Cell:
    # What the FastSLAM 1 drivers' cells do the same way: the sub-window's
    # arming, ATE, the program's config, the sync.
    arm = FilterCell.arm
    counters = FilterCell.counters
    program_config = FilterCell.program_config
    sync = FilterCell.sync

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, device
        self.slam = dict(config["slam"])
        self.world = {**config["world"], **traffic.get("world", {})}
        self.landmarks, self.waypoints = file_world(self.world)
        self.P = config["n_particles"]
        self.period = round(self.slam["DT_OBSERVE"]
                            / self.slam["DT_CONTROLS"])
        self.n_min = (self.slam["NEFFECTIVE"] * self.P
                      / self.slam["NPARTICLES"])
        cap = traffic["capture"]
        rng = np.random.default_rng([seed, 1])
        runs = rng.choice(cap["within"], size=min(cap["runs"],
                                                  cap["within"]),
                          replace=False)
        n_steps = traffic["supersteps_per_run"]
        lo, hi = cap["per_run"]
        self.plan = {int(i): sorted(int(s) for s in rng.choice(
            np.arange(1, n_steps), size=int(rng.integers(lo, hi + 1)),
            replace=False)) for i in runs}
        # The first run copied also copies its start, superstep 0.
        self.plan[int(min(runs))].insert(0, 0)
        self.runs, self.captures = [], []
        self.prof, self.window_times = None, []

    def setup(self) -> None:
        from slam_tpu_torch.maps import SlamMap
        from slam_tpu_torch.models import FastSlam2
        from slam_tpu_torch.runtime.loop import Runner

        if self.config["estimator"] != "FastSlam2":
            raise ValueError(f"estimator {self.config['estimator']!r}: "
                             "this driver runs FastSlam2")
        cfg = self.program_config()
        slam_map = SlamMap(landmarks=self.landmarks,
                           waypoints=self.waypoints)
        est = FastSlam2(cfg, slam_map.n_landmarks, device=self.device)
        self.capacity = est.capacity
        self.recorder = Fs2Recorder(est)
        self.runner = Runner(cfg, slam_map, "FASTSLAM2",
                             n_particles=self.P, estimator=self.recorder)
        # One whole run warms every shape the window runs, the copies
        # included. It copies as many supersteps as the window's plan, so
        # the device memory the window's copies hold is in the allocator's
        # cache before the window, where a copy into fresh memory now and
        # then stalls its superstep by ~0.2 s (the plan makes 7 to 13).
        n_steps = self.traffic["supersteps_per_run"]
        n_copies = sum(len(steps) for steps in self.plan.values())
        self.recorder.arm(capture={*range(n_copies), 1, n_steps - 1})
        self.runner.run(seed=WARM_SEED, n_ticks=self.n_ticks)
        self.recorder.arm()
        self.sync()

    @property
    def n_ticks(self) -> int:
        return self.traffic["supersteps_per_run"] * self.period

    def unit(self, i: int, seed: int) -> dict:
        self.arm(self.recorder, i)
        t0 = time.perf_counter()
        result = self.runner.run(seed=seed, n_ticks=self.n_ticks)
        self.sync()
        wall = time.perf_counter() - t0
        rec = self.recorder
        self.runs.append({k: getattr(result, k) for k in TRACE_KEYS})
        for step, r in sorted(rec.records.items()):
            self.captures.append((i, step, dict(
                xv0=r["xv0"], Pv0=r["Pv0"], obs=r["obs"], mid=r["mid"],
                ticks=torch.stack(r["controls"]),
                pre=particle_dict(r["pre"]), post=particle_dict(r["post"]))))
        rec.records = {}
        out = {"wall_s": wall, "ticks": result.n_ticks,
               "supersteps": result.n_ticks // self.period}
        if rec.window_times and len(rec.window_times) == 2:
            self.window_times = rec.window_times
            _, start, n = self.traffic["trace"]
            counts = matched_counts(result.obs_ids, result.obs_mask,
                                    self.capacity)
            out.update(window_supersteps=n,
                       window_matched=sum(counts[start:start + n]))
        return out

    def release(self) -> None:
        self.runner = self.recorder = None

    def check(self, control: bool = False) -> dict:
        return fs2_checks.fs2_numbers(
            self.runs, self.captures, self.slam, self.landmarks,
            self.waypoints, self.slam["max_observations"], self.n_min,
            self.seed, control=control)
