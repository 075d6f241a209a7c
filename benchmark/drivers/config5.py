"""Driver: back-to-back ``run_config5``, BASELINE config #5 composed on
one card: the filter (``FastSlam1Deferred``), ``problem_from_run`` and
``solve_ba_sharded``.

A unit is one call from its own seed; its wall includes the filter run,
the problem and the BA solve, ended by a device sync: the time to a
refined map. To judge what the call produced, the driver stands in
for three names of ``slam_tpu_torch.runtime.config5`` while it runs:
``Runner`` (a subclass that drives a ``Recorder`` and keeps the run's
traces) and ``solve_ba_sharded`` (which keeps the refined poses,
landmarks and the solver's last cost); the program's code runs
unchanged underneath.
"""

from __future__ import annotations

import time

from benchmark.filter_cell import FilterCell
from benchmark.recorder import Recorder
from benchmark.reference import ba as rba

WARM_SEED = 12345


class Cell(FilterCell):

    def setup(self) -> None:
        from slam_tpu_torch.runtime import config5 as c5

        cell = self
        base_runner, base_solve = c5.Runner, c5.solve_ba_sharded

        class RecordingRunner(base_runner):
            def __init__(self, *args, estimator=None, **kw):
                cell.recorder = Recorder(estimator)
                cell.arm(cell.recorder, cell.current)
                super().__init__(*args, estimator=cell.recorder, **kw)

            def run(self, *args, **kw):
                result = super().run(*args, **kw)
                cell.result = result._replace(final_state=None)
                return result

        def recording_solve(prob, mesh=None, **kw):
            out = base_solve(prob, mesh, **kw)
            poses, lms, info = out
            cell.solve = (poses.clone(), lms.clone(), info["costs"])
            return out

        self.restore = (c5, base_runner, base_solve)
        c5.Runner, c5.solve_ba_sharded = RecordingRunner, recording_solve
        self.kw = dict(n_particles=self.P,
                       n_landmarks=self.world["n_landmarks"],
                       capacity=self.slam["max_landmarks"],
                       n_supersteps=self.traffic["supersteps_per_run"],
                       ba_iters=self.config["ba"]["iters"])
        self.current = None
        # A whole composed run warms the filter, BA and the copies: the
        # first call in a process runs slower than the next.
        self.plan[None] = [1]
        self.run_config5 = c5.run_config5
        self.run_config5(seed=WARM_SEED, device=self.device, **self.kw)
        del self.plan[None]
        self.sync()
        self.recorder.records = {}
        self.ba = []

    def unit(self, i: int, seed: int) -> dict:
        self.current = i
        t0 = time.perf_counter()
        res = self.run_config5(seed=seed, device=self.device, **self.kw)
        self.sync()
        wall = time.perf_counter() - t0
        self.keep(i, self.result, self.recorder)
        self.ba.append(self.solve)
        self.result = self.solve = None
        ticks = self.kw["n_supersteps"] * self.period
        return {"wall_s": wall, "ticks": ticks,
                "supersteps": self.kw["n_supersteps"],
                "ba_s": res.ba_seconds}

    def ba_solves(self):
        out = []
        for run, (poses, lms, costs) in zip(self.runs, self.ba):
            prob = rba.problem_from_run(
                run["est_pose"], run["active"], run["obs_z"],
                run["obs_mask"], run["obs_ids"], run["odom"], self.slam)
            out.append((prob, poses, lms, costs,
                        self.kw["ba_iters"]))
        return out

    def release(self) -> None:
        c5, c5.Runner, c5.solve_ba_sharded = self.restore
        self.recorder = None
