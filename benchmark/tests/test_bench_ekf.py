"""The EKF cell, ``ekf10k.dense``, on the CPU: the harness's whole run
(``benchmark.run.main`` with a device named) at a test's size, correct,
with its metrics; the control (the reference in bfloat16 in the
program's place: a CPU has no TF32) failing; a fault planted in the
program failing the check. The plain reference loads nothing of the
program, and its two copies (``benchmark/reference/ekf.py`` and the
repository's ``tests/plain_ekf.py``) agree. The Pmm pass's operations,
bytes and least time by hand, and the readers' arithmetic."""

import importlib.util
import json
import subprocess
import sys

import pytest
import torch
from conftest import ROOT

from benchmark import run

CELL = "ekf10k.dense"
H100 = "NVIDIA H100 80GB HBM3"


def tiny_ekf(config: dict, workload: dict) -> None:
    """The cell cut to a CPU test's size: 64 landmark slots (the world,
    its 10,000 landmarks and the 96 observation slots kept), a start
    mapped by 3 supersteps, runs of 6 supersteps, two of them copied, a
    2-superstep sub-window."""
    config["slam"]["max_landmarks"] = 64
    t = workload["traffic"]
    t["start_supersteps"] = 3
    t["supersteps_per_run"] = 6
    t["capture"] = {"runs": 2, "within": 2, "per_run": 2}
    t["trace"] = [0, 2, 2]
    workload["shapes"]["L"] = 64


@pytest.mark.parametrize("trace", [0, 1])
def test_ekf_cell_runs_end_to_end_on_the_cpu(run_cell, trace):
    rc, result, err = run_cell(CELL, trace=trace, adjust=tiny_ekf)
    assert rc == 0, err[-3000:]
    assert result["correct"], result["compared"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    want = {m["name"] for m in run.metrics_of(CELL, bool(trace))}
    if trace:
        want.discard("ekf_pmm_roofline")        # device traces only
        assert result["metrics"]["pmm_passes_per_superstep"]["value"] == 1.0
        for name in ("host_share.ekf_predict", "host_share.ekf_update"):
            assert 0 < result["metrics"][name]["value"] < 100, name
    assert set(result["metrics"]) == want
    assert "info matched" in err and "ate_m" in err
    line = next(ln for ln in err.splitlines()
                if ln.startswith("benchmark: "))
    info = json.loads(line[line.index("{"):])
    assert 0 < info["start_n"] <= min(info["n_live"])


def test_control_fails(run_cell):
    rc, result, err = run_cell(CELL, control=True, adjust=tiny_ekf)
    assert rc == 0, err[-3000:]
    assert result["correct"], result["compared"]
    assert not result["control_correct"], result["control"]
    for name in ("mean_gap_m", "cov_gap"):
        c = result["control"][name]
        assert c["value"] > c["limit"], (name, c)


def _update_unchanged(mp):
    from slam_tpu_torch.parallel.ekf import ShardedEkfSlam
    mp.setattr(ShardedEkfSlam, "update", lambda self, state, *a: state)


def _heading_skipped(mp):
    from slam_tpu_torch.parallel import ekf
    inner = ekf._predict_local

    def no_heading(state, v, g, Q, wb, dt, phi, sigma, known, shard):
        return inner(state, v, g, Q, wb, dt, phi, sigma, False, shard)
    mp.setattr(ekf, "_predict_local", no_heading)


def _pmm_term_dropped(mp):
    """The deferred heading terms left out of the pass over Pmm."""
    from slam_tpu_torch.parallel import ekf
    inner = ekf._update_local

    def dropped(state, *a):
        return inner(state._replace(hk_n=0), *a)
    mp.setattr(ekf, "_update_local", dropped)


@pytest.mark.parametrize("fault", [_update_unchanged, _heading_skipped,
                                   _pmm_term_dropped])
def test_a_fault_in_the_program_is_not_correct(run_cell, monkeypatch,
                                               fault):
    fault(monkeypatch)
    rc, result, err = run_cell(CELL, adjust=tiny_ekf)
    assert rc == 0, err[-3000:]
    assert not result["correct"], result["compared"]


def test_reference_loads_nothing_of_the_program():
    code = ("import sys, benchmark.reference.ekf; print(' '.join(sorted("
            "{m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    mods = set(out.stdout.split())
    assert not mods & {"jax", "jaxlib", "flax", "slam_tpu",
                       "slam_tpu_torch"}


def test_the_two_copies_of_the_reference_agree():
    from benchmark.reference import ekf as bench_copy
    spec = importlib.util.spec_from_file_location(
        "plain_ekf_copy", ROOT / "tests" / "plain_ekf.py")
    repo_copy = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(repo_copy)
    names = sorted(n for n in vars(bench_copy) if not n.startswith("__"))
    assert names == sorted(n for n in vars(repo_copy)
                           if not n.startswith("__"))
    g = torch.Generator().manual_seed(3)
    cap, K = 12, 6
    x, P, n, table = bench_copy.init(cap, 20)
    x[:3] = torch.tensor([0.5, -0.2, 0.1], dtype=torch.float64)
    x[3:3 + 8] = 10 * torch.randn(8, generator=g, dtype=torch.float64)
    A = torch.randn((11, 11), generator=g, dtype=torch.float64)
    P[:11, :11] = 1e-3 * A @ A.T + 1e-2 * torch.eye(11, dtype=torch.float64)
    n = 4
    table[[3, 7, 9, 11]] = torch.arange(4)
    # Standing still, the heading observed near its 0.1 rad.
    ticks = [(0.0, 0.05 * t, 0.1 + 0.001 * t) for t in range(8)]
    d = x[3:11].reshape(4, 2) - x[:2]
    z = torch.zeros((K, 2), dtype=torch.float64)
    z[:4, 0] = d.norm(dim=1) + 0.02
    z[:4, 1] = torch.atan2(d[:, 1], d[:, 0]) - 0.1
    z[4] = torch.tensor([12.0, 0.3])
    ids = torch.tensor([3, 7, 9, 11, 15, 0])
    mask = torch.tensor([True] * 5 + [False])
    cfg = dict(V=3.0, WHEELBASE=4.0, DT_CONTROLS=0.025, sigmaV=0.3,
               sigmaG=0.05, sigmaR=0.1, sigmaB=0.0175, sigmaT=0.0175,
               GATE_REJECT=4.0, GATE_AUGMENT=25.0, SWITCH_HEADING_KNOWN=1,
               SWITCH_ASSOCIATION_KNOWN=0)
    a = bench_copy.superstep(x, P, n, table, ticks, z, ids, mask, cfg,
                             margin=1e-4)
    b = repo_copy.superstep(x, P, n, table, ticks, z, ids, mask, cfg,
                            margin=1e-4)
    assert a["n"] == b["n"] > n
    for key in ("x", "P", "table", "assoc", "is_new", "tie"):
        assert torch.equal(a[key], b[key]), key
    assert int((a["assoc"] >= 0).sum()) >= 3


def metric(name):
    return run.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py")


def test_pmm_pass_counts_by_hand():
    m = metric("ekf_pmm_roofline")
    # L = 10,000 slots: Pmm [20000, 20000]; W [20000, 2 96 + 8 = 200].
    assert m.pmm_flops(10_000, 96, 8) == 2 * 20_000 ** 2 * 200
    assert m.pmm_flops(10_000, 96, 8) == 160_000_000_000
    assert m.pmm_bytes(10_000) == 2 * 20_000 ** 2 * 4 == 3_200_000_000
    # 160 GFLOP at 67 TFLOP/s: 2.39 ms, above the bytes' 0.96 ms.
    bound = m.pmm_bound_s(10_000, 96, 8, H100)
    assert bound == pytest.approx(160e9 / 67e12)
    assert round(bound * 1e3, 2) == 2.39
    assert round(m.pmm_bytes(10_000) / 3.35e12 * 1e3, 2) == 0.96
    assert m.pmm_bound_s(10_000, 96, 8, "cpu") is None


def test_pmm_roofline_arithmetic():
    m = metric("ekf_pmm_roofline")
    bound = m.pmm_bound_s(10_000, 96, 8, H100)
    name = f"void cutlass_kernel_{m.NAME}_128x128(...)"
    ctx = {"trace": {"ops": {name: (2 * bound * 20, 20)}},
           "units": [{"pmm_passes": 80}, {"pmm_passes": 80,
                                          "window_pmm_passes": 20}],
           "device_kind": H100, "shapes": {"L": 10_000, "K": 96, "T": 8}}
    assert m.read(ctx) == pytest.approx(50.0)
    # Another product of the name in the sub-window: no reading.
    assert m.read(dict(ctx, trace={"ops": {name: (1.0, 21)}})) is None
    # A program that does not count its passes: no reading.
    assert m.read(dict(ctx, units=[{}, {}])) is None
    assert m.read(dict(ctx, trace=None)) is None
    assert m.read(dict(ctx, device_kind="cpu")) is None


def test_pmm_passes_per_superstep_reader():
    read = metric("pmm_passes_per_superstep").read
    units = [{"pmm_passes": 80, "supersteps": 80},
             {"pmm_passes": 85, "supersteps": 80}]
    assert read({"units": units}) == pytest.approx(165 / 160)
    assert read({"units": units + [{"supersteps": 80}]}) is None


MS = 1_000_000
# One superstep of 10 ms: 8 predicts of 0.5 ms; an update of 5 ms with
# its four phases (1, 2, 0.5, 1 ms); the simulator's 0.5 ms.
STORE = [("sim.control", 1, 0, 0, MS // 2)] + [
    ("filter.predict", 2 + t, 0, MS // 2 + t * MS // 2,
     MS + t * MS // 2) for t in range(8)] + [
    ("ekf.associate", 20, 19, 5 * MS, 6 * MS),
    ("ekf.gain", 21, 19, 6 * MS, 8 * MS),
    ("ekf.pmm", 22, 19, 8 * MS, 8 * MS + MS // 2),
    ("ekf.augment", 23, 19, 8 * MS + MS // 2, 9 * MS + MS // 2),
    ("filter.update", 19, 0, 5 * MS, 10 * MS),
    ("superstep", 0, None, 0, 10 * MS)]


def test_host_share_readers_on_a_hand_built_store(monkeypatch):
    from slam_tpu_torch import spans
    predict = metric("host_share.ekf_predict").read
    update = metric("host_share.ekf_update").read
    monkeypatch.setattr(spans, "_records", [])
    assert predict({}) is None and update({}) is None
    monkeypatch.setattr(spans, "_records", list(STORE))
    assert predict({}) == pytest.approx(40.0)
    assert update({}) == pytest.approx(50.0)
