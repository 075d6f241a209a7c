"""Spans inside the port (``slam_tpu_torch.spans``), on the CPU.

Off (no profiler active) a run records nothing in the store and never
enters ``record_function``. Profiler or not, every span times itself:
a run writes one ring row a superstep, each phase's total within its
superstep, marked traced only under a profiler; a traced row's totals
are the sums of its superstep's records (one clock), the clocks leave
the store's records as they were, and the ring wraps. Under a profiler
a run records one ``superstep`` a superstep with its phases beneath it, one
``filter.host_read`` a counted gate read and one ``filter.resample`` a
fired gate, and adds no event to the profiler's trace; BA records one
``ba.trial`` a trial and one ``ba.host_read`` a counted host read; a
span brackets the operators inside it on the trace's clock. Nested
spans of one name sum, on and off; a span name past the ring's columns
is refused. The benchmark's six readers of the store give the
hand-computed numbers of a hand-built store, and None on an empty one;
``step_table`` gives the medians and p95s of a hand-built ring. The
CLI's ``-profile`` writes the store and the ring's rows beside its trace.
"""

import collections
import importlib.util
import json
import os
import statistics
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from slam_tpu_torch import spans
from slam_tpu_torch.config import SlamConfig
from slam_tpu_torch.maps import read_map_file
from slam_tpu_torch.models import FastSlam1Deferred, rbpf
from slam_tpu_torch.runtime.loop import Runner

ROOT = Path(__file__).resolve().parents[1]
DATA = ROOT / "data"
N_STEPS = 16
# ring40's vehicle sees no landmark in its first supersteps at its own
# 25 m: at 200 m it sees ~17 from the start, so the gate fires on most
# supersteps and holds on some.
MAX_RANGE = 200.0


@pytest.fixture(autouse=True)
def empty_store():
    spans.clear()
    yield
    spans.clear()


def ring40_runner(P=16, deferred=False):
    cfg = SlamConfig.from_ini(str(DATA / "ring40.ini")).replace(
        MAX_RANGE=MAX_RANGE)
    slam_map = read_map_file(str(DATA / "ring40.mat"))
    est = (FastSlam1Deferred(cfg, slam_map.n_landmarks, device="cpu")
           if deferred else None)
    return Runner(cfg, slam_map, "FASTSLAM1", n_particles=P, estimator=est,
                  device="cpu")


def run(runner, seed=3):
    return runner.run(seed=seed,
                      n_ticks=N_STEPS * runner.config.steps_per_observe)


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


class _Refused:
    def __init__(self, *args, **kw):
        raise AssertionError("record_function entered")


def test_off_records_nothing_reads_no_clock_enters_no_record_function(
        monkeypatch):
    """Off, a run records nothing in the store and enters no
    ``record_function``. The name predates the clocks: off the profiler
    its spans now read the clock (the ring's rows), which this no longer
    checks."""
    monkeypatch.setattr(torch.profiler, "record_function", _Refused)
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        _Refused)
    result = run(ring40_runner())
    assert result.n_ticks == N_STEPS * 8
    assert spans.records() == []
    assert spans.summary() == {}


def _tree(recs):
    """{id: record}, and the name of each record's parent (None if it
    has no recorded parent)."""
    by_id = {r[1]: r for r in recs}
    parent = {r[1]: by_id[r[2]][0] if r[2] in by_id else None
              for r in recs}
    return by_id, parent


PHASES = {"sim.control": "superstep", "filter.predict": "superstep",
          "sim.observe": "superstep", "filter.update": "superstep",
          "run.record": "superstep", "filter.host_read": "filter.update",
          "filter.resample": "filter.update", "superstep": None,
          "run.init": None, "run.to_host": None}


@pytest.mark.parametrize("P,deferred", [(16, False), (512, True)])
def test_on_records_the_superstep_tree(monkeypatch, P, deferred):
    runner = ring40_runner(P, deferred)
    run(runner)                                   # warm
    fired = []
    gate = rbpf.resample_gate

    def spy(*args, **kw):
        out = gate(*args, **kw)
        fired.append(out[1])
        return out
    monkeypatch.setattr(rbpf, "resample_gate", spy)
    reads0 = rbpf.host_bool.count
    with cpu_profile():
        run(runner)
    reads = rbpf.host_bool.count - reads0
    recs = spans.records()
    by_id, parent = _tree(recs)
    counts = collections.Counter(r[0] for r in recs)
    period = runner.config.steps_per_observe
    assert counts["superstep"] == N_STEPS
    assert counts["sim.control"] == N_STEPS     # one launch a superstep
    assert counts["filter.predict"] == N_STEPS * period
    for name in ("sim.observe", "filter.update", "run.record"):
        assert counts[name] == N_STEPS, name
    assert counts["run.init"] == counts["run.to_host"] == 1
    assert counts["filter.host_read"] == reads == len(fired)
    assert counts["filter.resample"] == sum(fired)
    assert 0 < sum(fired) < len(fired)            # both arms ran
    assert set(counts) <= set(PHASES)
    for r in recs:
        assert parent[r[1]] == PHASES[r[0]], r
        assert r[3] <= r[4]
        if r[2] is not None:
            p = by_id[r[2]]
            assert p[3] <= r[3] and r[4] <= p[4], (r, p)
    assert spans.dropped() == spans.cut() == 0
    summary = spans.summary()
    steps = summary["superstep"]
    beneath = spans.summary(within="superstep")
    assert set(beneath) == set(PHASES) - {"superstep", "run.init",
                                          "run.to_host"}
    inner = sum(v["self_s"] for v in beneath.values())
    assert inner + steps["self_s"] == pytest.approx(steps["total_s"])


def test_spans_add_no_event_to_the_trace(monkeypatch):
    runner = ring40_runner()
    run(runner)                                   # warm

    def events():
        with cpu_profile() as prof:
            run(runner)
        return collections.Counter(e.name for e in prof.events())
    with_spans = events()
    assert len(spans.records()) > 0
    monkeypatch.setattr(spans, "_Span", spans._timer)
    spans.clear()
    without = events()
    assert spans.records() == []
    assert with_spans == without
    assert not set(with_spans) & set(PHASES)


@pytest.mark.parametrize("solver", ["solve_ba", "solve_ba_device",
                                    "solve_ba_sharded"])
def test_ba_spans_count_trials_and_host_reads(solver):
    from slam_tpu_torch import posegraph
    from slam_tpu_torch.posegraph.synthetic import make_ba_problem

    prob = make_ba_problem(24, 60, K=6, seed=1, device="cpu")[0]
    solve = getattr(posegraph, solver)
    kw = {} if solver != "solve_ba_sharded" else {"mesh": None}
    with cpu_profile():
        _, _, info = solve(prob, iters=6, return_info=True, **kw)
    recs = spans.records()
    counts = collections.Counter(r[0] for r in recs)
    assert counts["ba.solve"] == 1
    assert counts["ba.trial"] == info["n_steps"] > 0
    assert counts["ba.host_read"] == info["host_reads"]
    inside = collections.Counter(r[0] for r in spans.beneath(recs,
                                                              "ba.solve"))
    assert inside["ba.trial"] == counts["ba.trial"]
    assert inside["ba.host_read"] == counts["ba.host_read"]
    by_id, parent = _tree(recs)
    trial_reads = [r for r in recs if r[0] == "ba.host_read"
                   and parent[r[1]] == "ba.trial"]
    assert len(trial_reads) == info["n_steps"]


def test_span_brackets_its_operators_on_the_trace_clock():
    a, b = torch.randn(4096), torch.randn(4096)
    with cpu_profile() as prof:
        with spans.span("clock"):
            torch.mul(a, b)
    (_, _, _, t0, t1), = spans.records()
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    mul = [e for e in prof.events() if e.name == "aten::mul"]
    assert len(mul) == 1
    # Both on the trace's clock, in microseconds from its start.
    lo, hi = (t0 - start_ns) / 1e3, (t1 - start_ns) / 1e3
    assert lo - 50 <= mul[0].time_range.start
    assert mul[0].time_range.end <= hi + 50


def test_spans_outliving_the_profiler_are_cut():
    prof = cpu_profile()
    prof.start()
    with spans.span("outer"):
        with spans.span("inner"):
            pass
        prof.stop()
    assert [r[0] for r in spans.records()] == ["inner"]
    assert spans.cut() == 1


def test_store_is_capped(monkeypatch):
    monkeypatch.setattr(spans, "CAPACITY", 3)
    with cpu_profile():
        for _ in range(5):
            with spans.span("s"):
                pass
    assert len(spans.records()) == 3 and spans.dropped() == 2


# --- the clocks: the ring's rows -------------------------------------------

# The phases of a ring40 superstep, each beneath the superstep.
STEP_PHASES = [k for k, v in PHASES.items() if v is not None]


@pytest.mark.parametrize("P,deferred", [(16, False), (512, True)])
def test_ring_holds_one_row_a_superstep(P, deferred):
    run(ring40_runner(P, deferred))
    rows = spans.steps(N_STEPS)
    assert rows is not None and spans.steps(N_STEPS + 1) is None
    assert not rows["traced"].any()
    assert set(STEP_PHASES) <= set(rows)
    step = rows["superstep"]
    assert (step > 0).all()
    for name in STEP_PHASES:
        assert (rows[name] <= step).all(), name
    assert (rows["filter.host_read"] <= rows["filter.update"]).all()
    assert (rows["filter.resample"] <= rows["filter.update"]).all()
    direct = sum(rows[k] for k in STEP_PHASES if PHASES[k] == "superstep")
    assert (direct <= step).all()
    assert (rows["filter.host_read"] > 0).all()   # a gate read a superstep
    # Spans outside a superstep are in no row.
    assert not rows["run.init"].any() and not rows["run.to_host"].any()


def test_rows_are_traced_only_under_a_profiler():
    runner = ring40_runner()
    run(runner)
    with cpu_profile():
        run(runner)
    run(runner)
    assert spans.steps(3 * N_STEPS)["traced"].tolist() == (
        [False] * N_STEPS + [True] * N_STEPS + [False] * N_STEPS)
    # A superstep over which the profiler starts or stops is traced.
    prof = cpu_profile()
    with spans.span("superstep"):
        prof.start()
    with spans.span("superstep"):
        prof.stop()
    with spans.span("superstep"):
        pass
    assert spans.steps(3)["traced"].tolist() == [True, True, False]


def test_traced_rows_sum_their_records():
    runner = ring40_runner()
    run(runner)                                   # warm
    spans.clear()
    with cpu_profile():
        run(runner)
    recs = spans.records()
    rows = spans.steps()
    steps = [r for r in recs if r[0] == "superstep"]
    assert len(steps) == len(rows["superstep"]) == N_STEPS
    assert rows["traced"].all()
    for i, step in enumerate(steps):
        inside = spans.beneath([r for r in recs
                                if step[3] <= r[3] and r[4] <= step[4]],
                               "superstep")
        totals = collections.Counter()
        for r in inside:
            totals[r[0]] += r[4] - r[3]
        assert rows["superstep"][i] == step[4] - step[3]
        for name in set(rows) - {"superstep", "traced"}:
            assert rows[name][i] == totals[name], name


def test_ring_wraps_at_its_capacity(monkeypatch):
    monkeypatch.setattr(spans, "RING", 4)
    monkeypatch.setattr(spans, "_ring",
                        np.zeros((4, spans.COLUMNS), np.int64))
    monkeypatch.setattr(spans, "_traced", np.zeros(4, bool))
    # A clock that ticks once a read: a superstep of k spans "x" lasts
    # 2 k + 1 ticks, and its "x" total is k.
    import itertools
    monkeypatch.setattr(spans, "_clock", itertools.count().__next__)
    for k in range(6):
        with spans.span("superstep"):
            for _ in range(k):
                with spans.span("x"):
                    pass
    assert spans.steps(5) is None
    rows = spans.steps(4)
    assert rows["x"].tolist() == [2, 3, 4, 5]
    assert rows["superstep"].tolist() == [5, 7, 9, 11]
    assert spans.steps()["x"].tolist() == [2, 3, 4, 5]
    assert spans.steps(2)["x"].tolist() == [4, 5]
    spans.clear()
    assert spans.steps(1) is None and spans.steps()["superstep"].size == 0


class _SpanWithoutClocks:
    """``spans._Span`` as it was before the clocks: it records, and
    times nothing into the ring."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.id = next(spans._ids)
        self.parent = spans._open[-1] if spans._open else None
        spans._open.append(self.id)
        self.t0 = spans._clock()

    def __exit__(self, *exc):
        t1 = spans._clock()
        spans._open.pop()
        if not torch.autograd.profiler._is_profiler_enabled:
            spans._counts["cut"] += 1
        elif len(spans._records) < spans.CAPACITY:
            spans._records.append((self.name, self.id, self.parent,
                                   self.t0, t1))
        else:
            spans._counts["dropped"] += 1
        return False


def _shape(recs):
    """The records without their stamps, ids by rank."""
    rank = {r[1]: i for i, r in enumerate(sorted(recs, key=lambda r: r[1]))}
    return [(r[0], rank[r[1]], rank.get(r[2])) for r in recs]


def test_clocks_leave_the_store_as_it_was(monkeypatch):
    runner = ring40_runner(512, deferred=True)
    run(runner)                                   # warm

    def store():
        spans.clear()
        prof = cpu_profile()
        prof.start()
        run(runner)
        with spans.span("superstep"):             # cut: outlives it
            prof.stop()
        return _shape(spans.records()), spans.cut(), spans.dropped()
    with_clocks = store()
    monkeypatch.setattr(spans, "_Span", _SpanWithoutClocks)
    without = store()
    assert with_clocks == without
    assert len(with_clocks[0]) > N_STEPS and with_clocks[1] == 1


# --- the benchmark's readers ------------------------------------------------

def reader(name):
    path = ROOT / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "reader_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


MS = 1_000_000
# Two supersteps (1000 and 2000 ns) with their phases; an orphan phase
# of a superstep the window cut (its parent, 99, is not recorded); a BA
# solve of 10 ms with the plan's read and two trials, and a trial outside
# any solve.
STORE = [
    ("sim.control", 2, 1, 0, 100),
    ("filter.predict", 3, 1, 100, 300),
    ("sim.observe", 4, 1, 300, 350),
    ("filter.host_read", 6, 5, 400, 450),
    ("filter.resample", 7, 5, 500, 700),
    ("filter.update", 5, 1, 350, 900),
    ("run.record", 8, 1, 900, 950),
    ("superstep", 1, None, 0, 1000),
    ("sim.control", 9, 99, 3000, 3500),
    ("sim.control", 11, 10, 1000, 1500),
    ("filter.host_read", 13, 12, 1600, 2000),
    ("filter.update", 12, 10, 1500, 2500),
    ("superstep", 10, None, 1000, 3000),
    ("ba.host_read", 21, 20, 0, 1 * MS),
    ("ba.host_read", 23, 22, 3 * MS, 3.5 * MS),
    ("ba.trial", 22, 20, 1 * MS, 4 * MS),
    ("ba.host_read", 25, 24, 8 * MS, 9 * MS),
    ("ba.trial", 24, 20, 4 * MS, 9 * MS),
    ("ba.solve", 20, None, 0, 10 * MS),
    ("ba.trial", 26, None, 0, 100 * MS),
]
# By hand: sim self 100 + 50 + 500 = 650 ns; estimator self 200 + (550 -
# 50 - 200) + 200 + (1000 - 400) = 1300 ns; host reads 50 + 400 = 450
# ns; of 3000 ns of supersteps. BA: trials of 3 and 5 ms; reads 1 + 0.5
# + 1 ms of 10.
EXPECTED = {"host_share.sim": 100 * 650 / 3000,
            "host_share.estimator": 100 * 1300 / 3000,
            "host_wait_share.filter": 100 * 450 / 3000,
            "resamples_per_superstep": 0.5,
            "ba_trial_ms": statistics.median([3.0, 5.0]),
            "host_wait_share.ba": 100 * 2.5 / 10}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_a_hand_built_store(monkeypatch, name):
    read = reader(name)
    assert read({}) is None
    monkeypatch.setattr(spans, "_records", list(STORE))
    assert read({}) == pytest.approx(EXPECTED[name])


def test_filter_shares_partition_the_supersteps(monkeypatch):
    monkeypatch.setattr(spans, "_records", list(STORE))
    parts = [reader(n)({}) for n in ("host_share.sim",
                                      "host_share.estimator",
                                      "host_wait_share.filter")]
    steps = spans.summary()["superstep"]
    # What is left is the supersteps' own self time and run.record's.
    rest = steps["self_s"] + spans.summary(within="superstep")[
        "run.record"]["self_s"]
    assert sum(parts) == pytest.approx(100 - 100 * rest / steps["total_s"])


# A hand-built ring: three untraced supersteps (1, 2 and 4 ms) and a
# traced one.
RING_ROWS = {"superstep": [1 * MS, 2 * MS, 4 * MS, 9 * MS],
             "sim.control": [MS // 10, MS // 5, 2 * MS // 5, 9 * MS // 10],
             "filter.update": [MS // 2, MS, 2 * MS, 0],
             "filter.host_read": [0, 0, 0, 0]}
RING_TRACED = [False, False, False, True]


def hand_built_ring(monkeypatch, rows=RING_ROWS, traced=RING_TRACED):
    ring = np.zeros((spans.RING, spans.COLUMNS), np.int64)
    for col, values in enumerate(rows.values()):
        ring[:len(values), col] = values
    flags = np.zeros(spans.RING, bool)
    flags[:len(traced)] = traced
    monkeypatch.setattr(spans, "_ring", ring)
    monkeypatch.setattr(spans, "_traced", flags)
    monkeypatch.setattr(spans, "_rows", len(traced))
    monkeypatch.setattr(spans, "_cols", {k: i for i, k in enumerate(rows)})


def test_step_table_on_a_hand_built_ring(monkeypatch):
    from slam_tpu_torch.runtime.profiling import step_table

    hand_built_ring(monkeypatch)
    lines = step_table(spans.steps()).splitlines()
    assert "(4 supersteps, 1 traced)" in lines[0]
    # By hand, over all four rows, by median: the superstep's median 3
    # ms and p95 8.25 (4 + 0.85 x 5, between the third and fourth rows),
    # the update's 0.75 and 1.85, the control's 0.3 and 0.825; the host
    # read, zero in every row, is left out.
    rows = [line.split() for line in lines[1:]]
    assert rows == [["superstep", "3.000", "8.250"],
                    ["filter.update", "0.750", "1.850"],
                    ["sim.control", "0.300", "0.825"]]


@pytest.mark.parametrize("profiled", [False, True])
def test_nested_spans_of_one_name_sum(monkeypatch, profiled):
    import contextlib
    import itertools
    # A clock that ticks once a read; the profiler reads none of it.
    ticks = itertools.count()
    monkeypatch.setattr(spans, "_clock", ticks.__next__)
    with cpu_profile() if profiled else contextlib.nullcontext():
        with spans.span("superstep"):             # reads 0 and 5
            with spans.span("x"):                 # 1 and 4
                with spans.span("x"):             # 2 and 3
                    pass
    rows = spans.steps(1)
    assert rows["superstep"].tolist() == [5]
    assert rows["x"].tolist() == [(3 - 2) + (4 - 1)]
    assert rows["traced"].tolist() == [profiled]
    assert len(spans.records()) == (3 if profiled else 0)


def test_span_names_past_the_columns_are_refused():
    names = [f"n{i}" for i in range(1, spans.COLUMNS)]
    with spans.span("superstep"):
        for name in names:
            with spans.span(name):
                pass
    rows = spans.steps(1)
    assert set(rows) == {"superstep", "traced", *names}
    with pytest.raises(RuntimeError, match="raise spans.COLUMNS"):
        spans.span("one too many")
    with cpu_profile():
        with pytest.raises(RuntimeError, match="raise spans.COLUMNS"):
            spans.span("one too many")
        with spans.span(names[0]):                # a known name still runs
            pass
    spans.clear()                                 # frees the columns
    with spans.span("one too many"):
        pass


def test_cli_profile_writes_the_spans(tmp_path, capsys):
    from slam_tpu_torch.cli import main

    prof_dir = tmp_path / "prof"
    assert main(["-m", str(DATA / "ring40.mat"), "-method", "FASTSLAM1",
                 "-particles", "8", "-ticks", "16", "-device", "cpu",
                 "-profile", str(prof_dir), "-out", str(tmp_path)]) == 0
    with open(prof_dir / "spans.json") as fh:
        out = json.load(fh)
    assert out["fields"] == ["name", "id", "parent", "t0_ns", "t1_ns"]
    names = collections.Counter(r[0] for r in out["records"])
    assert names["superstep"] == 2 and names["run.init"] == 1
    assert out["summary"]["superstep"]["count"] == 2
    assert all(r[3] >= out["trace_start_ns"] for r in out["records"])
    assert len(out["steps"]["superstep"]) == 2
    assert all(out["steps"]["traced"])
    assert out["steps"]["superstep"] == [
        r[4] - r[3] for r in out["records"] if r[0] == "superstep"]
    err = capsys.readouterr().err
    assert "self ms" in err and "superstep" in err
    assert "p95 ms" in err and "(2 supersteps, 2 traced)" in err
    assert sorted(os.listdir(prof_dir))[0] == "spans.json"
