"""Driver: runs of the deferred FastSLAM 1 filter, ``FastSlam1Deferred``,
from a mapped start, every particle holding a slot for every landmark.

Set-up drives the program's own filter from the start the program makes
(``Runner._init``: the simulator at waypoint 0, an empty map) for
``start_supersteps`` supersteps, with noise drawn from the seed: the map
the deployment holds (its live count, ``start_n``, is printed on
standard error). A unit is ``supersteps_per_run`` supersteps from that
start, with noise from the unit's seed: the simulator's truth and the
filter's state (its pending bounds ``S`` and ``pending`` included)
copied from the start, since K4 writes the landmark planes in place;
then ``Runner._chunk`` (the superstep loop of ``Runner.run``), the
traces copied to the host, ended by a device sync. The configuration
gives the filter's settings under ``slam`` and the world under
``world`` (``benchmark.world.make_world``); the traffic gives the drive,
the run length, the copies (``capture``: ``runs`` of the first
``within`` runs, ``per_run`` supersteps each, drawn from the seed, and
superstep 0 of the first copied run) and the profiled sub-window
(``trace``: run index, first superstep, supersteps).

``LiveRecorder`` copies the live slot rows of the copied supersteps;
``benchmark.fs1_mapped_checks`` judges them. The traced run's record
holds the start's live count (``live_rows``), which ``k5_live_roofline``
reads.
"""

from __future__ import annotations

import sys
import time

from benchmark import fs1_mapped_checks
from benchmark.drivers.ekf_loop import cloned, drive_seed
from benchmark.filter_cell import TRACE_KEYS, FilterCell
from benchmark.fs1_recorder import LiveRecorder, live_dict
from benchmark.recorder import clone_state

WARM_SEED = 12345


class Cell(FilterCell):

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        super().__init__(config, traffic, seed, device)
        self.live = []
        self.start_live = None

    def setup(self) -> None:
        from slam_tpu_torch.maps import SlamMap
        from slam_tpu_torch.models import FastSlam1Deferred
        from slam_tpu_torch.runtime.loop import Runner

        if self.config["estimator"] != "FastSlam1Deferred":
            raise ValueError(f"estimator {self.config['estimator']!r}: "
                             "this driver runs FastSlam1Deferred")
        cfg = self.program_config()
        slam_map = SlamMap(landmarks=self.landmarks,
                           waypoints=self.waypoints)
        self.recorder = LiveRecorder(
            FastSlam1Deferred(cfg, slam_map.n_landmarks,
                              device=self.device),
            self.slam["max_observations"])
        self.runner = Runner(cfg, slam_map, "FASTSLAM1",
                             n_particles=self.P, estimator=self.recorder)
        sim_state, est_state, gen, _ = self.runner._init(
            drive_seed(self.seed))
        self.superstep = self.runner._superstep_for(est_state)
        sim_state, est_state, _ = self.runner._chunk(
            self.superstep, sim_state, est_state, gen,
            self.traffic["start_supersteps"])
        self.start = (sim_state.vehicle, sim_state.tick, est_state)
        self.start_n = int(est_state.ps.n)
        print(f"benchmark: the drive left {self.start_n} of "
              f"{est_state.ps.capacity} slots live", file=sys.stderr)
        # One run from the start warms every path the window takes. It
        # copies as many supersteps as the window's plan, so the device
        # memory the window's copies hold is in the allocator's cache.
        n_copies = sum(len(steps) for steps in self.plan.values())
        self.recorder.arm(capture=set(range(n_copies)))
        self._run(WARM_SEED)
        self.recorder.arm()
        self.sync()

    @property
    def start_tick(self) -> int:
        return self.traffic["start_supersteps"] * self.period

    def fresh_start(self, seed: int):
        """(simulator state, filter state, filter generator) of a unit:
        copies of the mapped start, the noise streams from ``seed`` (as
        ``Runner._init`` seeds them)."""
        from slam_tpu_torch.sim.simulator import SimState

        vehicle, tick, est_state = self.start
        sim = self.runner.sim
        sim_state = SimState(vehicle=cloned(vehicle),
                             generator=sim.make_generator(seed), tick=tick)
        return (sim_state, clone_state(est_state),
                sim.make_generator(seed + 1))

    def _run(self, seed: int):
        """One run from the mapped start: (its result, its wall)."""
        from slam_tpu_torch.runtime.loop import run_result, to_host

        sim_state, est_state, gen = self.fresh_start(seed)
        n_steps = self.traffic["supersteps_per_run"]
        self.sync()
        t0 = time.perf_counter()
        _, est_state, traces = self.runner._chunk(
            self.superstep, sim_state, est_state, gen, n_steps)
        traces = to_host(traces)
        self.sync()
        wall = time.perf_counter() - t0
        return run_result(traces, est_state, n_steps * self.period, wall,
                          0.0, 0), wall

    def unit(self, i: int, seed: int) -> dict:
        rec = self.recorder
        self.arm(rec, i)
        result, wall = self._run(seed)
        self.runs.append({k: getattr(result, k) for k in TRACE_KEYS})
        self.live.append(int(result.final_state.ps.n))
        for step, r in sorted(rec.records.items()):
            self.captures.append((i, step, r))
        rec.records = {}
        out = {"wall_s": wall, "ticks": result.n_ticks,
               "supersteps": result.n_ticks // self.period}
        if rec.window_times and len(rec.window_times) == 2:
            self.window_times = rec.window_times
            out["live_rows"] = self.start_n
        return out

    def counters(self) -> dict:
        """ATE of each run, and the live slots of the start and after
        each run of the window, printed."""
        return dict(FilterCell.counters(self), start_n=self.start_n,
                    n_live=self.live)

    def release(self) -> None:
        # The check reads the start's live rows only.
        self.start_live = live_dict(self.start[2], self.start_n)
        self.start = self.runner = self.recorder = None

    def check(self, control: bool = False) -> dict:
        return fs1_mapped_checks.fs1_mapped_numbers(
            self.runs, self.captures, self.slam, self.landmarks,
            self.waypoints, self.slam["max_observations"], self.n_min,
            self.seed, self.start_live, self.start_tick, control=control)
