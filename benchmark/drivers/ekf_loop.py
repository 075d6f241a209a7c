"""Driver: runs of the landmark-block EKF, ``ShardedEkfSlam`` with no
mesh (one card holds the whole joint state), from a mapped start.

Set-up drives the program's own filter from the start the program makes
(``Runner._init``: the simulator at waypoint 0, the filter empty) for
``start_supersteps`` supersteps, with noise drawn from the seed: the
map the deployment holds. A unit is ``supersteps_per_run`` supersteps
from that start, with noise from the unit's seed: the simulator's truth
and the filter's state copied from the start (the filter's in-place
pass over Pmm would otherwise write into it), then ``Runner._chunk``
(the superstep loop of ``Runner.run``, no host read), the traces copied
to the host, ended by a device sync. The configuration gives the
filter's settings under ``slam``, the world under ``world``
(``benchmark.world.make_world``) and the width of the deferred heading
terms (``n_defer``, held against the program's own); the traffic gives
the drive, the run length, the copies (``capture``: ``runs`` of the
first ``within`` runs, ``per_run`` supersteps each, drawn from the
seed, and superstep 0 of the first copied run) and the profiled
sub-window (``trace``: run index, first superstep, supersteps).

``EkfRecorder`` stands in for the estimator and copies, at a copied
superstep, the state before its first predict, each tick's (v, g, phi),
the observations, the association the program decided (read by standing
in for ``gated_nearest`` in ``slam_tpu_torch.parallel.ekf`` during that
update only) and the state after the update. Every counter of the
program it reads (``pmm_passes``) is read with a default: a program
without it reports no such metric.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import ekf_checks
from benchmark.filter_cell import TRACE_KEYS, FilterCell
from benchmark.world import make_world

STATE_KEYS = ("x", "P00", "P0m", "Pmm", "hk", "hk_n", "n", "da_table")


def pmm_passes():
    """The program's count of full passes over Pmm, or None where the
    program does not count them."""
    from slam_tpu_torch.parallel import ekf
    counter = getattr(ekf, "pmm_passes", None)
    return None if counter is None else counter.count


def copy_state(state, clone: bool = True) -> dict:
    """A ``ShardedEKFState`` under the names the check reads (``table``
    for ``da_table``): a device copy, or with ``clone`` false its own
    tensors."""
    out = {k: getattr(state, k) for k in STATE_KEYS}
    if clone:
        out = {k: v.clone() if isinstance(v, torch.Tensor) else v
               for k, v in out.items()}
    out["table"] = out.pop("da_table")
    return out


def cloned(state):
    """A NamedTuple of the program's with each tensor in it copied."""
    return type(state)(*(v.clone() if isinstance(v, torch.Tensor) else v
                         for v in state))


def drive_seed(seed: int) -> int:
    """The seed of the set-up's drive from the run's ``seed`` (another
    stream than the units', ``benchmark.run.unit_seed``)."""
    state = np.random.SeedSequence([seed, 2]).generate_state(1)[0]
    return int(state) % (2 ** 31 - 2) + 1


class EkfRecorder:
    """The estimator ``est``, recording at the supersteps of ``capture``
    and opening the profiler over ``window`` (see the module's
    docstring); every other attribute is ``est``'s."""

    def __init__(self, est):
        self._est = est
        self.arm()

    def __getattr__(self, name):
        return getattr(self._est, name)

    def arm(self, capture=(), window=None, prof=None) -> None:
        self.step = 0
        self.capture = set(capture)
        self.records = {}
        self.window, self.prof, self.window_times = window, prof, None
        self.window_passes = None

    def predict(self, state, generator, vn, gn, phi):
        if self.step in self.capture:
            rec = self.records.setdefault(self.step, {"ticks": []})
            if "pre" not in rec:
                rec["pre"] = copy_state(state)
            rec["ticks"].append(torch.stack([vn, gn, phi]).reshape(3))
        return self._est.predict(state, generator, vn, gn, phi)

    def update(self, state, generator, z, ids, zmask):
        rec = self.records.get(self.step)
        if rec is None:
            out = self._est.update(state, generator, z, ids, zmask)
        else:
            rec["obs"] = (z.clone(), ids.clone(), zmask.clone())
            rec["ticks"] = torch.stack(rec["ticks"])
            out, rec["assoc"] = self._decided(state, generator, z, ids,
                                              zmask)
            rec["post"] = copy_state(out)
        self.step += 1
        if self.window is not None:
            start, n = self.window
            if self.step in (start, start + n):
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                now, passes = time.perf_counter(), pmm_passes()
                if self.step == start:
                    self.window_times, self.window_passes = [now], passes
                    self.prof.start()
                else:
                    self.prof.stop()
                    self.window_times.append(now)
                    if passes is not None:
                        self.window_passes = passes - self.window_passes
        return out

    def _decided(self, state, generator, z, ids, zmask):
        """The update, with the (assoc, is_new) that the program's gated
        nearest neighbour returned (None if it did not run)."""
        from slam_tpu_torch.parallel import ekf
        inner, got = ekf.gated_nearest, []

        def spy(*args, **kw):
            out = inner(*args, **kw)
            got.append(tuple(t.clone() for t in out))
            return out
        ekf.gated_nearest = spy
        try:
            out = self._est.update(state, generator, z, ids, zmask)
        finally:
            ekf.gated_nearest = inner
        return out, (got[0] if got else None)


class Cell:

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, device
        self.slam = dict(config["slam"])
        self.world = {**config["world"], **traffic.get("world", {})}
        self.landmarks, self.waypoints = make_world(self.world)
        self.period = round(self.slam["DT_OBSERVE"]
                            / self.slam["DT_CONTROLS"])
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
        self.runs, self.captures, self.live = [], [], []
        self.prof, self.window_times = None, []

    def setup(self) -> None:
        from slam_tpu_torch.config import SlamConfig
        from slam_tpu_torch.maps import SlamMap
        from slam_tpu_torch.parallel.ekf import ShardedEkfSlam
        from slam_tpu_torch.runtime.loop import Runner

        if self.config["estimator"] != "ShardedEkfSlam":
            raise ValueError(f"estimator {self.config['estimator']!r}: "
                             "this driver runs ShardedEkfSlam")
        cfg = SlamConfig(**self.slam)
        slam_map = SlamMap(landmarks=self.landmarks,
                           waypoints=self.waypoints)
        self.recorder = EkfRecorder(ShardedEkfSlam(
            cfg, slam_map.n_landmarks, device=self.device))
        self.runner = Runner(cfg, slam_map, "EKF1", estimator=self.recorder)
        sim_state, est_state, gen, _ = self.runner._init(
            drive_seed(self.seed))
        if est_state.hk.shape[1] != self.config["n_defer"]:
            raise ValueError(f"the program defers {est_state.hk.shape[1]} "
                             f"heading terms, the configuration "
                             f"{self.config['n_defer']}")
        self.init_misses = ekf_checks.start_misses(
            copy_state(est_state, clone=False))
        self.superstep = self.runner._superstep_for(est_state)
        # The drive maps the start and warms every shape the window runs,
        # the copies and the association's read included.
        self.recorder.arm(capture=(1,))
        sim_state, est_state, _ = self.runner._chunk(
            self.superstep, sim_state, est_state, gen,
            self.traffic["start_supersteps"])
        self.recorder.arm()
        self.start = (sim_state.vehicle, sim_state.tick, est_state)
        self.start_n = int(est_state.n)
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
        return sim_state, cloned(est_state), sim.make_generator(seed + 1)

    def unit(self, i: int, seed: int) -> dict:
        from slam_tpu_torch.runtime.loop import run_result, to_host

        window = None
        if self.prof is not None and i == self.traffic["trace"][0]:
            window = tuple(self.traffic["trace"][1:])
        self.recorder.arm(self.plan.get(i, ()), window, self.prof)
        sim_state, est_state, gen = self.fresh_start(seed)
        n_steps = self.traffic["supersteps_per_run"]
        self.sync()
        passes0 = pmm_passes()
        t0 = time.perf_counter()
        _, est_state, traces = self.runner._chunk(
            self.superstep, sim_state, est_state, gen, n_steps)
        traces = to_host(traces)
        self.sync()
        wall = time.perf_counter() - t0
        result = run_result(traces, est_state, n_steps * self.period, wall,
                            0.0, 0)
        rec = self.recorder
        self.runs.append({k: getattr(result, k) for k in TRACE_KEYS})
        self.live.append(int(est_state.n))
        for step, r in sorted(rec.records.items()):
            self.captures.append((i, step, r))
        out = {"wall_s": wall, "ticks": result.n_ticks,
               "supersteps": n_steps}
        if passes0 is not None:
            out["pmm_passes"] = pmm_passes() - passes0
        if rec.window_times and len(rec.window_times) == 2:
            self.window_times = rec.window_times
            if rec.window_passes is not None:
                out["window_pmm_passes"] = rec.window_passes
        rec.records = {}
        return out

    def counters(self) -> dict:
        """ATE of each run, and the live landmarks of the start and after
        each run, printed."""
        return dict(FilterCell.counters(self), start_n=self.start_n,
                    n_live=self.live)

    def release(self) -> None:
        self.runner = self.recorder = None

    def check(self, control: bool = False) -> dict:
        return ekf_checks.ekf_numbers(
            self.runs, self.captures, self.slam, self.landmarks,
            self.waypoints, self.slam["max_observations"], self.seed,
            copy_state(self.start[2], clone=False), self.start_tick,
            self.init_misses, control=control)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
