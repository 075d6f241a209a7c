"""Driver: back-to-back ``Runner.run`` of one FastSLAM 1 configuration.

A unit is one whole run of ``ticks_per_run`` control ticks from its own
seed: the estimator's state made anew, the superstep loop, the traces
copied to the host, each end behind a device sync (``Runner.run``). The
estimator is ``FastSlam1`` (the eager filter) or ``FastSlam1Deferred``
(the deferred resample), as the configuration names it.
"""

from __future__ import annotations

import time

from benchmark.filter_cell import FilterCell
from benchmark.recorder import Recorder

WARM_SEED = 12345


class Cell(FilterCell):

    def setup(self) -> None:
        from slam_tpu_torch.maps import SlamMap
        from slam_tpu_torch.models import FastSlam1, FastSlam1Deferred
        from slam_tpu_torch.runtime.loop import Runner

        cls = {"FastSlam1": FastSlam1,
               "FastSlam1Deferred": FastSlam1Deferred}[
                   self.config["estimator"]]
        cfg = self.program_config()
        slam_map = SlamMap(landmarks=self.landmarks,
                           waypoints=self.waypoints)
        self.recorder = Recorder(cls(cfg, slam_map.n_landmarks,
                                     device=self.device))
        self.runner = Runner(cfg, slam_map, "FASTSLAM1",
                             n_particles=self.P, estimator=self.recorder)
        # One whole run warms every shape the window runs, the copies
        # included.
        self.recorder.arm(capture=(1,))
        self.runner.run(seed=WARM_SEED, n_ticks=self.period * self.traffic.get(
            "warm_supersteps", self.traffic["supersteps_per_run"]))
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
        self.keep(i, result, self.recorder)
        return {"wall_s": wall, "ticks": result.n_ticks,
                "supersteps": result.n_ticks // self.period}

    def release(self) -> None:
        self.runner = self.recorder = None
