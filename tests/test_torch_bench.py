"""The port's entry points beside the JAX package's scripts:
``slam_tpu_torch.bench`` (the counterpart of the repository's
``bench.py``), the kernel gate ``ops.kernels.selfcheck`` and
``slam_tpu_torch.quickstart`` (of ``examples/quickstart.py``).

- Each bench function at a small size on the CPU gives its line
  bench.py's keys (transcribed from its ``_line`` calls) and the port's
  own, under bench.py's line name.
- The ``ba_10k`` line at ``make_ba_problem(64, 500)`` against bench.py's
  ``make_ba_problem`` and the JAX package's ``solve_ba_device`` on the
  same sizes: ``err`` and ``map_floor`` at tests/test_torch_ba.py's pose
  tolerance (atol 1e-3), ``err_init`` at rtol 1e-5 (the two problem
  builders' odometry rounds differently in float32, and the dead
  reckoning carries it: 1.2e-6 relative). The trial counts are not
  compared: at this problem's ill-conditioned first steps the two
  packages' LM trial sequences part on the way to the same optimum
  (5 trials against JAX's 12; tests/test_torch_ba.py, SOLVE_CASES).
- ``main``: the primary JSON first on stdout with exactly bench.py's four
  keys; a value over its limit lands in ``ate_warn`` and exits 1; an
  exception in a line is not caught; with no device named and no card it
  raises; ``--out`` never writes bench_lines.json.
- The gate refuses the CPU; its code runs there at small shapes.
- ``python -m slam_tpu_torch.quickstart -device cpu`` with its ticks cut.

Line functions run here at small sizes with their device named; the
lines ``main`` times are stubbed where a test reads only ``main``'s own
logic.
"""

import dataclasses
import json
import math
import runpy
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jbench
from slam_tpu.posegraph import solve_ba_device as jax_solve_ba_device
from slam_tpu_torch import bench
from slam_tpu_torch.ops.kernels import selfcheck
from slam_tpu_torch.runtime.loop import Runner

# bench.py's keys per line (its _line calls at :147, :196, :239, :271,
# :396 and :426).
BENCH_RUN_KEYS = {"steps_per_sec", "ate", "n_seeds", "ref_ate", "compile_s"}
PARTICLE_KEYS = {"ticks_per_sec", "particle_steps_per_sec", "n_particles"}
MAP_RUN_KEYS = {"steps_per_sec", "ate", "n_seeds", "ref_ate", "n_particles"}
EKF10K_KEYS = {"steps_per_sec", "ate"}
BA10K_KEYS = {"ms_per_lm_step", "err_init", "err", "map_floor", "n_steps"}
CONFIG5_KEYS = {"ticks_per_sec", "particle_steps_per_sec", "ate_filter",
                "ate_refined", "n_particles", "capacity"}
# The port's own keys on every line.
PORT_KEYS = {"compile_s", "host_syncs", "launches"}

# (function, small-size arguments, line name, bench.py's keys, the port's
# limit keys)
CASES = [
    (bench.bench_run, dict(method="FASTSLAM1", n_particles=100, n_ticks=24,
                           seeds=(3, 4)),
     "fastslam1_webmap", BENCH_RUN_KEYS, {"ate_limit"}),
    (bench.bench_run, dict(method="EKF1", n_particles=None, n_ticks=24,
                           seeds=(3,)),
     "ekf1_webmap", BENCH_RUN_KEYS, {"ate_limit"}),
    (bench.bench_map_run, dict(method="FASTSLAM2", mapname="ring40",
                               n_particles=64, n_ticks=24, seeds=(3,)),
     "fastslam2_ring40_64", MAP_RUN_KEYS, {"ate_limit"}),
    (bench.bench_map_run, dict(method="FASTSLAM1", mapname="dense200",
                               n_particles=512, n_ticks=24, seeds=(3,)),
     "fastslam1_dense200_512", MAP_RUN_KEYS, {"ate_limit"}),
    (bench.bench_particle_throughput, dict(n_particles=1024, n_supersteps=2),
     "fastslam1_1m", PARTICLE_KEYS, set()),
    (bench.bench_particle_throughput, dict(n_particles=1024, n_supersteps=2,
                                           method="FASTSLAM2"),
     "fastslam2_1m", PARTICLE_KEYS, set()),
    (bench.bench_ekf_10k, dict(n_landmarks=300, n_ticks=24),
     "ekf_10k", EKF10K_KEYS, {"ate_limit"}),
    (bench.bench_config5, dict(n_particles=512, capacity=64, n_supersteps=4,
                               tag="config5 composed"),
     "config5_composed", CONFIG5_KEYS,
     {"ate_filter_limit", "ate_refined_limit"}),
]


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread, beside JAX's pool (a drive took 5x longer
    with torch's default threads; tests/test_torch_ekf.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("fn,kw,name,keys,limits", CASES,
                         ids=[c[2] for c in CASES])
def test_line_has_bench_keys(fn, kw, name, keys, limits):
    """Each line: bench.py's keys and the port's, nothing else; finite
    numbers; a small size has no JAX anchor, so no limit; no kernel
    launched on the CPU."""
    out = fn(**kw, device="cpu")
    assert list(out) == [name]
    line = out[name]
    assert set(line) == keys | PORT_KEYS | limits
    for key, value in line.items():
        if key in limits or key == "ref_ate":
            assert value is None, key
        elif key != "launches":
            assert math.isfinite(value), key
    assert line["launches"] == {}
    json.dumps(line)


def test_ba_line_matches_jax():
    """The ba_10k line at (64, 500) against bench.py's make_ba_problem
    and the JAX package's solve_ba_device, as bench_ba_10k runs them."""
    line = bench.bench_ba_10k(64, 500, device="cpu")["ba_10k"]
    assert set(line) == BA10K_KEYS | PORT_KEYS
    prob, poses, poses0, lms = jbench.make_ba_problem(64, 500)
    err_init = float(np.linalg.norm(poses0[:, :2] - poses[:, :2],
                                    axis=1).mean())
    p, _, info = jax_solve_ba_device(prob, iters=30, return_info=True)
    err = float(jnp.linalg.norm(p[:, :2] - poses[:, :2], axis=1).mean())
    prob_t = dataclasses.replace(prob, poses0=jnp.asarray(poses),
                                 landmarks0=jnp.asarray(lms))
    p_t, _ = jax_solve_ba_device(prob_t, iters=30)
    floor = float(jnp.linalg.norm(p_t[:, :2] - poses[:, :2], axis=1).mean())
    np.testing.assert_allclose(line["err_init"], err_init, rtol=1e-5)
    np.testing.assert_allclose(line["err"], err, rtol=0, atol=1e-3)
    np.testing.assert_allclose(line["map_floor"], floor, rtol=0, atol=1e-3)
    assert line["err"] < 0.2 * line["err_init"]
    assert line["n_steps"] >= 1 and int(info["n_steps"]) >= 1
    # The plan's read and one per trial (solve_ba_device).
    assert line["host_syncs"] == 1 + line["n_steps"]


def test_ba_line_raises_on_a_bad_solve(monkeypatch):
    """bench.py's quality checks (:398-399) raise, as its asserts do."""
    monkeypatch.setattr(bench, "solve_ba_device",
                        lambda prob, iters, **kw: (
                            (prob.poses0, prob.landmarks0, dict(
                                n_steps=1, host_reads=2))
                            if kw.get("return_info")
                            else (prob.poses0, prob.landmarks0)))
    with pytest.raises(AssertionError, match="0.2 x"):
        bench.bench_ba_10k(16, 60, device="cpu")


def _fake_lines(ate=0.5, raise_in=None):
    """Stand-ins for main's line functions: each returns a line of the
    right name at once (``ate`` against a limit of 1.0 on the ATE
    lines); the one named ``raise_in`` raises."""
    def fake(fn_name):
        def line(*args, device=None, **kw):
            assert device is not None and device.type == "cpu"
            if fn_name == raise_in:
                raise RuntimeError(f"{fn_name} failed")
            if fn_name == "bench_run":
                name = f"{args[0].lower()}_webmap"
            elif fn_name == "bench_map_run":
                name = f"{args[0].lower()}_{args[1]}_{args[2]}"
            elif fn_name == "bench_particle_throughput":
                name = f"{kw.get('method', 'FASTSLAM1').lower()}_1m"
            elif fn_name == "bench_config5":
                name = kw["tag"].replace(" ", "_")
            else:
                name = fn_name[len("bench_"):]
            return {name: dict(steps_per_sec=250.0, ate=ate, ate_limit=1.0)}
        return line
    return {n: fake(n) for n in ("bench_run", "bench_map_run",
                                 "bench_particle_throughput",
                                 "bench_ekf_10k", "bench_ba_10k",
                                 "bench_config5")}


LINE_NAMES = ["fastslam1_webmap", "ekf1_webmap", "fastslam2_webmap",
              "fastslam2_ring40_1024", "fastslam1_dense200_131072",
              "fastslam2_webmap_131072", "fastslam1_1m", "fastslam2_1m",
              "ekf_10k", "ba_10k", "config5_composed", "config5_cap256",
              "config5_full-10k"]


def _stub(monkeypatch, **kw):
    for name, fn in _fake_lines(**kw).items():
        monkeypatch.setattr(bench, name, fn)


def test_main_prints_the_primary_json_first(monkeypatch, tmp_path, capsys):
    _stub(monkeypatch)
    out = tmp_path / "lines.json"
    assert bench.main(["--out", str(out)], device="cpu") == 0
    stdout = capsys.readouterr().out.splitlines()
    assert len(stdout) == 1
    primary = json.loads(stdout[0])
    assert list(primary) == ["metric", "value", "unit", "vs_baseline"]
    assert primary == {"metric": bench.PRIMARY_METRIC, "value": 250.0,
                       "unit": "steps/s", "vs_baseline": None}
    record = json.loads(out.read_text())
    assert list(record["lines"]) == sorted(LINE_NAMES) and len(LINE_NAMES) == 13
    assert record["complete"] and record["ate_warn"] == []
    assert record["card"] == "cpu" and record["gate"] is None


def test_main_exits_1_on_an_ate_over_its_limit(monkeypatch, tmp_path,
                                               capsys):
    _stub(monkeypatch, ate=1.5)
    assert bench.main(["--out", str(tmp_path / "l.json")], device="cpu") == 1
    first, again = map(json.loads, capsys.readouterr().out.splitlines())
    assert "ate_warn" not in first
    assert again["ate_warn"][0] == dict(line="fastslam1_webmap", key="ate",
                                        value=1.5, limit=1.0)
    assert len(again["ate_warn"]) == 13
    assert {k: again[k] for k in first} == first


def test_accuracy_warnings_read_every_limit():
    lines = {"a": dict(ate=1.0, ate_limit=2.0),
             "b": dict(ate_filter=0.1, ate_filter_limit=0.05,
                       ate_refined=float("nan"), ate_refined_limit=1.0),
             "c": dict(err_vs_jax=0.06, err_vs_jax_limit=0.05),
             "d": dict(ate=9.0, ate_limit=None)}
    assert [(w["line"], w["key"]) for w in bench.accuracy_warnings(lines)] \
        == [("b", "ate_filter"), ("b", "ate_refined"), ("c", "err_vs_jax")]


@pytest.mark.parametrize("where", ["bench_run", "bench_ekf_10k",
                                   "bench_config5"])
def test_main_does_not_catch_a_line_failure(monkeypatch, tmp_path, where):
    _stub(monkeypatch, raise_in=where)
    out = tmp_path / "l.json"
    with pytest.raises(RuntimeError, match=f"{where} failed"):
        bench.main(["--out", str(out)], device="cpu")
    if out.exists():
        assert not json.loads(out.read_text())["complete"]


def test_no_card_raises(monkeypatch, tmp_path):
    """No device named and no card: main and each line raise through
    device.default_device; nothing runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        bench.main(["--out", str(tmp_path / "l.json")])
    with pytest.raises(RuntimeError, match="is_available"):
        bench.bench_run("FASTSLAM1", 100, n_ticks=8, seeds=(3,))
    assert not (tmp_path / "l.json").exists()


def test_out_refuses_bench_lines_json(tmp_path):
    with pytest.raises(SystemExit):
        bench.main(["--out", str(tmp_path / "bench_lines.json")],
                   device="cpu")
    assert not (tmp_path / "bench_lines.json").exists()


def test_gate_refuses_the_cpu():
    with pytest.raises(ValueError, match="CUDA device"):
        selfcheck.run("cpu")


def test_gate_runs_its_checks_at_small_shapes():
    """On the CPU every wrapper is its twin, so this holds the gate's
    own code (inputs, calls, comparisons), not the kernels."""
    got = selfcheck.check_all("cpu", 16, 1024, 256, selfcheck.WEBMAP,
                              selfcheck.CONFIG5)
    assert set(got) == {"K1", "K2", "K3", "K4", "K5", "K6", "K6b", "G1",
                        "G2", "K4 config5", "K5 config5", "S1", "E1", "F2",
                        "R1"}
    assert all(v["max_abs_err"] == 0.0 for v in got.values())


def test_quickstart_runs_on_the_cpu(monkeypatch, tmp_path, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(Runner, "estimate_run_ticks",
                        lambda self, cap=None: 80)
    monkeypatch.setattr(sys, "argv", ["quickstart", "-device", "cpu"])
    runpy.run_module("slam_tpu_torch.quickstart", run_name="__main__")
    out = capsys.readouterr().out.splitlines()
    assert [line.split()[0] for line in out] == ["EKF1", "FASTSLAM1",
                                                 "FASTSLAM2", "BA"]
    for method in ("ekf1", "fastslam1", "fastslam2"):
        assert (tmp_path / f"quickstart_{method}" / "results.txt").exists()
