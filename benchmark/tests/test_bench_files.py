"""Every file the benchmark is made of parses and agrees with
BENCHMARK.json, and a cell or a metric added as new files is found with
no edit to any file that is there."""

import json
import re
import shutil

from conftest import CELLS, ROOT

from benchmark import run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert [w["name"] for w in BENCH["workloads"]] == list(CELLS)
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(set(names)) == len(names)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


def test_every_cell_file_agrees_with_benchmark_json():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for entry in BENCH["workloads"]:
        _, workload, config = run.cell_spec(entry["name"])
        for key in ("name", "config", "chips", "why"):
            assert workload[key] == entry[key], (entry["name"], key)
        assert workload["traffic_mix"] == entry["traffic"]
        assert (ROOT / "benchmark" / "drivers"
                / f"{workload['driver']}.py").is_file()
        c = configs[entry["config"]]
        assert (ROOT / c["file"]).is_file()
        assert config["name"] == c["name"]
        assert config["source"] == c["source"]
        assert config["reduced"] == c["reduced"]
        assert workload["limits"], entry["name"]


def test_every_cell_reports_setup_a_rate_and_a_layer():
    for entry in BENCH["workloads"]:
        e2e = {m["name"] for m in run.metrics_of(entry["name"], False)}
        layer = run.metrics_of(entry["name"], True)
        assert "setup_s" in e2e and len(e2e) >= 2
        assert layer and all(m["moves"] in e2e for m in layer)


def test_every_metric_has_a_reader():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        mod = run.load_module(ROOT / "benchmark" / "metrics"
                              / f"{m['name']}.py")
        assert callable(mod.read), m["name"]


def test_a_cell_and_a_metric_added_as_new_files_are_found(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    new = json.loads((ROOT / "benchmark" / "workloads"
                      / "webmap-fs1-p100.loop.json").read_text())
    new.update(name="webmap-fs1-p100.short", traffic_mix="short",
               why="shorter runs")
    new["traffic"]["supersteps_per_run"] = 100
    (tmp_path / "benchmark" / "workloads"
     / "webmap-fs1-p100.short.json").write_text(json.dumps(new))
    (tmp_path / "benchmark" / "metrics" / "runs_per_s.py").write_text(
        "def read(ctx):\n    return len(ctx['units']) / ctx['wall_s']\n")
    bench["workloads"].append({"name": "webmap-fs1-p100.short",
                               "config": "webmap-fs1-p100",
                               "traffic": "short", "chips": 1,
                               "why": "shorter runs"})
    bench["per_layer"].append({
        "name": "runs_per_s", "unit": "runs/s", "better": "higher",
        "source": "host_clock", "layer": "entry", "moves": "ticks_per_s",
        "workloads": ["webmap-fs1-p100.short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    entry, workload, config = run.cell_spec("webmap-fs1-p100.short",
                                            root=tmp_path)
    assert workload["traffic"]["supersteps_per_run"] == 100
    assert config["name"] == "webmap-fs1-p100"
    layer = run.metrics_of("webmap-fs1-p100.short", True, root=tmp_path)
    assert "runs_per_s" in [m["name"] for m in layer]
    got = run.read_metrics([m for m in layer if m["name"] == "runs_per_s"],
                           {"units": [{}, {}], "wall_s": 4.0},
                           root=tmp_path)
    assert got == {"runs_per_s": {"value": 0.5, "unit": "runs/s"}}
