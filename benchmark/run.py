"""Run one cell of the benchmark once, on the card:

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout. Everything is found by name: the cell in
``BENCHMARK.json`` and ``benchmark/workloads/<cell>.json`` (its driver,
traffic and limits), the configuration in ``benchmark/configs/``, the
driver in ``benchmark/drivers/<driver>.py`` and each metric in
``benchmark/metrics/<metric>.py``.

A run: set-up (imports, the kernel library, the inputs from the seed,
a warm-up over every path the window takes; ``setup_s`` counts from the
start of this module to its end), then a closed-loop window of units
(runs or solves), each from its own seed drawn from ``--seed``, until
the first that ends past ``--seconds``; then the metrics, the device's
peak memory, and the check of what the window produced against the
plain reference (``benchmark/checks.py``). With ``--trace 0`` the result
carries the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics, read with a profiler over a short steady sub-window. The last
line of standard output is the result, one JSON object; the numbers
compared, each beside its limit, are the last lines of standard error
and the result's last key.

A driver defines ``Cell(config, traffic, seed, device)`` with
``setup()``, ``unit(i, seed)`` (one unit, ended by a device sync: a dict
with ``wall_s`` and what the cell's metrics count), ``counters()``,
``release()`` (free the program's state) and ``check(control=False)``
(``{name: number}``); it opens the profiler ``prof`` over its traced
sub-window and keeps the sub-window's two host times in
``window_times``. A unit's records reach the metric readers as
``ctx["units"]``.

Exits 2, printing no result, without a CUDA card or with fewer cards
than the cell asks for, and 3 if jax, jaxlib, flax or the JAX package
``slam_tpu`` is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "slam_tpu")
# Caches of the program's tool chains, inside the checkout at fixed paths
# (the program builds its own kernels into slam_tpu_torch/_build/).
CACHE_DIRS = {"TRITON_CACHE_DIR": ".bench_cache/triton",
              "TORCH_EXTENSIONS_DIR": ".bench_cache/torch_extensions"}


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: Path):
    """The module in ``path``, loaded under a name of its own."""
    spec = importlib.util.spec_from_file_location(
        "benchmark_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_spec(name: str, root: Path = ROOT) -> tuple[dict, dict, dict]:
    """(the cell's entry in BENCHMARK.json, its workload file, its
    configuration file)."""
    bench = load_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name),
                 None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    workload = load_json(root / "benchmark" / "workloads" / f"{name}.json")
    config = load_json(root / "benchmark" / "configs"
                       / f"{entry['config']}.json")
    return entry, workload, config


def metrics_of(name: str, trace: bool, root: Path = ROOT) -> list[dict]:
    """The metrics a cell reports: with ``trace`` its per-layer ones,
    else its end-to-end ones."""
    bench = load_json(root / "BENCHMARK.json")
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def unit_seed(seed: int, i: int) -> int:
    """The seed of unit ``i`` of a run from ``seed``."""
    state = np.random.SeedSequence([seed, i]).generate_state(1)[0]
    return int(state) % (2 ** 31 - 2) + 1


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def read_metrics(specs, ctx: dict, root: Path = ROOT) -> dict:
    """{name: {value, unit}} of the metrics ``specs`` whose readers find
    something to read in ``ctx``."""
    out = {}
    for m in specs:
        path = root / "benchmark" / "metrics" / f"{m['name']}.py"
        value = load_module(path).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_window(cell, seconds: float, seed: int) -> tuple[list, float]:
    """Units back to back until the first that ends past ``seconds``:
    (their records, the window's wall)."""
    records = []
    t0 = time.perf_counter()
    while True:
        records.append(cell.unit(len(records),
                                 unit_seed(seed, len(records))))
        if time.perf_counter() - t0 >= seconds:
            return records, time.perf_counter() - t0


def compare(numbers: dict, limits: dict) -> tuple[dict, int]:
    """({name: {value, limit}} in the limits' order, how many are over
    their limit or missing)."""
    compared, bad = {}, 0
    for name, limit in limits.items():
        value = numbers.get(name)
        compared[name] = {"value": value, "limit": limit}
        bad += value is None or not value <= limit
    return compared, bad


def main(argv=None, device=None, adjust=None, control=False) -> int:
    """The run. ``device`` (tests only): run there, a CPU, without the
    look for a card; ``adjust(config, workload)``: resize the cell in
    place first; ``control``: also judge the control (``benchmark.
    control``)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    seed = args.seed % 2 ** 63
    entry, workload, config = cell_spec(args.workload)
    if adjust is not None:
        adjust(config, workload)
    for key, rel in CACHE_DIRS.items():
        os.environ[key] = str(ROOT / rel)

    import torch
    t_import = time.perf_counter() - T_START

    if device is None and (not torch.cuda.is_available() or (
            torch.cuda.device_count() < entry["chips"])):
        print(f"benchmark: {args.workload} needs {entry['chips']} CUDA "
              f"card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    on_card = device is None
    device = torch.device("cuda", 0) if on_card else torch.device(device)
    driver = load_module(HERE / "drivers" / f"{workload['driver']}.py")
    cell = driver.Cell(config, workload["traffic"], seed, device)
    t_setup = time.perf_counter()
    cell.setup()
    t_setup = time.perf_counter() - t_setup
    if args.trace:
        from benchmark import tracing
        with tracing.make_profiler():   # the profiler's own start-up
            torch.zeros(1, device=device).add_(1)
        cell.prof = tracing.make_profiler()
    counters0 = program_counters()
    if on_card:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - T_START

    records, wall = run_window(cell, args.seconds, seed)
    counters = {k: v - counters0[k] for k, v in program_counters().items()}
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    trace = None
    if args.trace and len(cell.window_times) == 2:
        from benchmark import tracing
        t = cell.window_times
        trace = tracing.summarize(cell.prof, t[1] - t[0])
        trace["n"] = workload["traffic"]["trace"][-1]
    ctx = dict(units=records, wall_s=wall, setup_s=setup_s,
               counters=counters, trace=trace,
               shapes=workload.get("shapes", {}),
               device_kind=(torch.cuda.get_device_name(device) if on_card
                            else device.type))
    metrics = read_metrics(metrics_of(args.workload, bool(args.trace)), ctx)
    info = cell.counters()
    cell.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    numbers = cell.check()
    compared, bad = compare(numbers, workload["limits"])
    check_s = time.perf_counter() - t_check
    print(f"benchmark: {len(records)} units in {wall:.3f} s; set-up "
          f"{setup_s:.3f} s (torch imported at {t_import:.3f} s, the "
          f"cell's set-up {t_setup:.3f} s); check {check_s:.3f} s; "
          f"{json.dumps(info)}", file=sys.stderr)
    if control:
        numbers_control = cell.check(control=True)

    found = forbidden_modules()
    if found:
        print(f"benchmark: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    device_info = {"platform": "gpu", "kind": ctx["device_kind"],
                   "count": entry["chips"], "memory_peak_bytes": peak}
    result = {"correct": bad == 0, "attempted": len(records),
              "failed": bad, "metrics": metrics, "device": device_info}
    if trace is not None:
        device_info.update(busy_s=trace["busy_s"],
                           window_s=trace["window_s"])
        result["breakdown"] = {"device_ops": trace["device_ops"],
                               "idle_gaps": trace["idle_gaps"]}
    if control:
        result["control"] = compare(numbers_control, workload["limits"])[0]
        result["control_correct"] = compare(numbers_control,
                                            workload["limits"])[1] == 0
    result["compared"] = compared
    for name, num in numbers.items():
        if name not in compared:
            print(f"info {name} {num}", file=sys.stderr)
    for name, c in compared.items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def program_counters() -> dict:
    """The program's own counters: host syncs of the particle filters'
    gates (``rbpf.host_bool.count``)."""
    from slam_tpu_torch.models import rbpf
    return {"host_bool": rbpf.host_bool.count}


if __name__ == "__main__":
    sys.exit(main())
