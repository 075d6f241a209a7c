"""The benchmark's own CPU tests: the repository's root on the path, and
the cells resized to run here in seconds."""

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# Several test workers share the machine's cores.
torch.set_num_threads(2)

CELLS = ("webmap-fs1-p100.loop", "config5-1m.dense", "config5-1m.ba10k",
         "config5-1m.blind")


def tiny(config: dict, workload: dict) -> None:
    """A cell cut to a CPU test's size: short runs and sub-windows, few
    particles and slots, a small BA problem; the traffic's shape kept."""
    t = workload["traffic"]
    if "supersteps_per_run" in t:
        t["supersteps_per_run"] = min(t["supersteps_per_run"], 32)
        t["warm_supersteps"] = 8
        t["trace"] = [0, 4, 4]
        t["capture"] = {"runs": 2, "within": 2, "per_run": 2}
    if config["n_particles"] > 512:
        config["n_particles"] = 512
        config["slam"]["max_landmarks"] = 64
    if "problem_seeds" in t:
        config["ba_map"].update(n_keyframes=64, n_landmarks=2000, K=16)
        t["problem_seeds"] = t["problem_seeds"][:2]
        t["trace"] = [0, 2]


@pytest.fixture
def run_cell(capsys):
    """Run a cell on the CPU through ``benchmark.run.main``: (exit code,
    the result line as a dict, standard error)."""
    from benchmark import run

    def go(name, seed=2 ** 31 + 11, trace=0, control=False, adjust=tiny):
        rc = run.main(["--workload", name, "--seed", str(seed),
                       "--seconds", "0.5", "--trace", str(trace)],
                      device="cpu", adjust=adjust, control=control)
        out = capsys.readouterr()
        lines = out.out.strip().splitlines()
        return rc, (json.loads(lines[-1]) if lines else None), out.err
    return go
