"""Driver: bundle adjustment at map scale, ``solve_ba_sharded(prob,
None, iters)`` on one card, round-robin over the problems that the
traffic names (``problem_seeds`` of ``benchmark.world.make_ba_problem``),
made in set-up, in an order drawn from the seed: every seed gives the
same work.

A unit is one solve, ended by a device sync. Every answer is kept; the
check judges one answer of each problem, drawn from the seed.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import checks
from benchmark.world import make_ba_problem

FIELDS = ("poses0", "landmarks0", "odom", "odom_info", "z", "lm_idx",
          "mask", "R")


class Cell:

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.shape = dict(config["ba_map"])
        self.iters = self.shape.pop("iters")
        self.traffic, self.seed, self.device = traffic, seed, device
        self.prof, self.window_times = None, []
        # The same problems for every seed, in an order of the seed's.
        rng = np.random.default_rng([seed, 2])
        self.problem_seeds = [int(s) for s in rng.permutation(
            traffic["problem_seeds"])]
        self.sample_rng = rng
        self.answers, self.infos = [], []

    def setup(self) -> None:
        from slam_tpu_torch.posegraph import BAProblem, solve_ba_sharded

        self.solve = solve_ba_sharded
        self.problems_np = [make_ba_problem(seed=s, **self.shape)
                            for s in self.problem_seeds]
        self.problems = [BAProblem.from_numpy(
            self.device, **{k: p[k] for k in FIELDS})
            for p in self.problems_np]
        for prob in self.problems:
            self.solve(prob, None, iters=self.iters)
        self.sync()

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def unit(self, i: int, seed: int) -> dict:
        start, n = self.traffic["trace"]
        traced = self.prof is not None and start <= i < start + n
        if self.prof is not None and i == start:
            self.sync()
            self.window_times = [time.perf_counter()]
            self.prof.start()
        k = i % len(self.problems)
        t0 = time.perf_counter()
        poses, lms, info = self.solve(self.problems[k], None,
                                      iters=self.iters, return_info=True)
        self.sync()
        wall = time.perf_counter() - t0
        if self.prof is not None and i == start + n - 1:
            self.prof.stop()
            self.window_times.append(time.perf_counter())
        self.answers.append((k, poses, lms, info["costs"]))
        self.infos.append(info)
        return {"wall_s": wall, "solves": 1, "n_steps": info["n_steps"],
                "host_reads": info["host_reads"], "traced": traced}

    def counters(self) -> dict:
        return {}

    def release(self) -> None:
        self.problems = None

    def check(self, control: bool = False) -> dict:
        """The BA numbers of one answer of each problem, drawn from the
        seed among that problem's solves in the window."""
        by_problem = {}
        for answer in self.answers:
            by_problem.setdefault(answer[0], []).append(answer)
        solves = []
        for k, answers in sorted(by_problem.items()):
            _, poses, lms, costs = answers[
                self.sample_rng.integers(len(answers))]
            solves.append((self.problems_np[k], poses, lms, costs,
                           self.iters))
        return checks.ba_numbers(solves, control)
