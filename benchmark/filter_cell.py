"""What the filter drivers share: the configuration as the program and
the reference read it, the plan of copied supersteps and of the profiled
sub-window, the traces kept from each run, and the check.

A configuration file gives the filter's settings under ``slam`` (the
fields of ``slam_tpu_torch.config.SlamConfig`` that the run uses, angles
in radians), the world under ``world`` (``benchmark.world.make_world``)
and the estimator, particle count and capacity; a traffic file may
override ``world`` entries and sets the run length, the copies
(``capture``: ``runs`` of the first ``within`` runs, ``per_run``
supersteps each, drawn from the seed) and the profiled sub-window
(``trace``: run index, first superstep, supersteps). The first run
copied also copies superstep 0, whose state before the update is the
filter's start.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import checks
from benchmark.recorder import particle_dict
from benchmark.world import make_world

TRACE_KEYS = ("true_pose", "est_pose", "active", "obs_z", "obs_mask",
              "obs_ids", "odom")


class FilterCell:
    """Base of the filter drivers; a driver adds ``setup`` and ``unit``."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, device
        self.slam = dict(config["slam"])
        self.world = {**config["world"], **traffic.get("world", {})}
        self.landmarks, self.waypoints = make_world(self.world)
        self.P = config["n_particles"]
        self.period = round(self.slam["DT_OBSERVE"]
                            / self.slam["DT_CONTROLS"])
        self.n_min = (self.slam["NEFFECTIVE"] * self.P
                      / self.slam["NPARTICLES"])
        self.deferred = config["estimator"] == "FastSlam1Deferred"
        cap = traffic["capture"]
        rng = np.random.default_rng([seed, 1])
        runs = rng.choice(cap["within"], size=min(cap["runs"],
                                                  cap["within"]),
                          replace=False)
        n_steps = traffic["supersteps_per_run"]
        self.plan = {int(i): sorted(int(s) for s in rng.choice(
            np.arange(1, n_steps), size=cap["per_run"], replace=False))
            for i in runs}
        # The first run copied also copies its start, superstep 0.
        self.plan[int(min(runs))].insert(0, 0)
        self.runs, self.captures = [], []
        self.prof, self.window_times = None, []

    def arm(self, recorder, i: int) -> None:
        """Arm ``recorder`` for run ``i`` of the window."""
        window = None
        if self.prof is not None and i == self.traffic["trace"][0]:
            window = tuple(self.traffic["trace"][1:])
        recorder.arm(self.plan.get(i, ()), window, self.prof)

    def keep(self, i: int, result, recorder) -> None:
        """Keep run ``i``'s traces and the recorder's copies."""
        self.runs.append({k: getattr(result, k) for k in TRACE_KEYS})
        for step, rec in sorted(recorder.records.items()):
            self.captures.append((i, step, dict(
                xv0=rec["xv0"], controls=rec["controls"], obs=rec["obs"],
                pre=particle_dict(rec["pre"]),
                post=particle_dict(rec["post"]))))
        recorder.records = {}
        if recorder.window_times and len(recorder.window_times) == 2:
            self.window_times = recorder.window_times

    def counters(self) -> dict:
        return {"ate_m": [float(np.sqrt(np.mean(np.sum(
            (r["true_pose"][r["active"], :2]
             - r["est_pose"][r["active"], :2]) ** 2, 1))))
            for r in self.runs]}

    def ba_solves(self):
        return None

    def check(self, control: bool = False) -> dict:
        return checks.filter_numbers(
            self.runs, self.captures, self.slam, self.landmarks,
            self.waypoints, self.slam["max_observations"], self.n_min,
            self.deferred, self.seed, control=control,
            ba=self.ba_solves())

    def program_config(self):
        """The program's ``SlamConfig`` of this configuration."""
        from slam_tpu_torch.config import SlamConfig
        return SlamConfig(**self.slam)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
