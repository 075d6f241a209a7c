"""Command-line shell of the port (counterpart: slam_tpu.cli).

Flag-compatible with the JAX package's CLI: ``-m <map.mat>``, ``-n
<name>``, ``-method EKF1|FASTSLAM1|FASTSLAM2`` (default EKF1; any other
name runs the EKF, as in the JAX package), ``-particles``, ``-ticks``,
``-seed``, ``-out``, any config key as ``-KEY value``, and the run
options ``-plot`` (stream the run to a slam-gui: the native publisher
when its library loads, else the Python one), ``-profile <dir>`` (a
profiler trace of the run, and ``<dir>/spans.json``: the run's spans,
``slam_tpu_torch.spans``, on the trace's clock, and their rows a
superstep; each span name's self time, and its median and p95
milliseconds a superstep, are printed on stderr) and ``-ckpt <path>``
(a checkpointed run that resumes from ``<path>`` when it exists). The
map's ``<map>.ini`` is loaded when it exists. The run takes place on the
card (``cuda``); without one the command fails with the reason on stderr
and a non-zero exit code. ``-device cpu`` is the only way to a CPU run,
``-device cuda:1`` picks another card. The device is printed with the
banner.
"""

from __future__ import annotations

import contextlib
import os
import sys

from slam_tpu_torch.config import SlamConfig, apply_cli_overrides
from slam_tpu_torch.maps import read_map_file

USAGE = """\
slam_tpu_torch backend — landmark SLAM in PyTorch / CUDA
Usage: python -m slam_tpu_torch [options]
    -m <file>        map file (.mat text format)
    -n <name>        simulation name (report directory)
    -mode <mode>     waypoints (interactive not supported headless)
    -method <name>   EKF1 | FASTSLAM1 | FASTSLAM2
    -particles <N>   particle count
    -ticks <N>       max control ticks
    -seed <N>        PRNG seed
    -device <dev>    cuda | cuda:N | cpu (default: cuda; fails without a card)
    -plot            stream ZMQ telemetry to a running slam-gui
    -profile <dir>   write a torch.profiler trace of the run into <dir>,
                     and its spans and superstep rows into
                     <dir>/spans.json
    -ckpt <path>     checkpoint path prefix (a chunked run that resumes)
    -out <dir>       report output directory (default .)
    -KEY <value>     override any config key (e.g. -SWITCH_HEADING_KNOWN 0)
    -h               this help
"""


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "-h" in argv or "--help" in argv:
        print(USAGE)
        return 0
    use_plot = "-plot" in argv
    # A switch without a value must not take the next token as its value.
    flags = apply_cli_overrides([a for a in argv if a != "-plot"])

    map_path = flags.pop("m", None)
    if not map_path:
        print("error: no map file (-m)", file=sys.stderr)
        print(USAGE)
        return 2
    mode = flags.pop("mode", "waypoints")
    if mode != "waypoints":
        print(f"warning: mode {mode!r} not supported; using waypoints",
              file=sys.stderr)
    sim_name = flags.pop("n", "simulation")
    method = flags.pop("method", "EKF1")
    n_particles = flags.pop("particles", None)
    n_ticks = flags.pop("ticks", None)
    seed = int(flags.pop("seed", 0))
    out_dir = flags.pop("out", ".")
    device = flags.pop("device", None)
    profile_dir = flags.pop("profile", None)
    ckpt_path = flags.pop("ckpt", None)

    from slam_tpu_torch.device import default_device
    try:
        device = default_device(device)
    except RuntimeError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2

    ini = os.path.splitext(map_path)[0] + ".ini"
    if os.path.exists(ini):
        config = SlamConfig.from_ini(ini, overrides=flags)
    else:
        config = SlamConfig.from_mapping(flags)
    slam_map = read_map_file(map_path)

    from slam_tpu_torch.runtime import Runner, compute_metrics, write_report
    runner = Runner(config, slam_map, method,
                    n_particles=int(n_particles) if n_particles else None,
                    device=device)
    print(f"slam_tpu_torch {method} on {map_path} "
          f"({slam_map.n_landmarks} landmarks, "
          f"{slam_map.n_waypoints} waypoints) on {runner.device}",
          file=sys.stderr)

    profiler = contextlib.nullcontext()
    if profile_dir:
        from slam_tpu_torch.runtime.profiling import trace
        profiler = trace(profile_dir)
    nt = int(n_ticks) if n_ticks else None
    with profiler as prof:
        if use_plot:
            try:
                from slam_tpu_torch.runtime.native import NativeNetworkPlot
                plot = NativeNetworkPlot()
            except OSError:
                from slam_tpu_torch.runtime.telemetry import NetworkPlot
                plot = NetworkPlot()
            result = runner.run_streaming(seed=seed, plot=plot,
                                          sim_name=sim_name, n_ticks=nt)
            plot.close()
        elif ckpt_path:
            result = runner.run_checkpointed(seed=seed, n_ticks=nt,
                                             ckpt_path=ckpt_path,
                                             resume=True)
        else:
            result = runner.run(seed=seed, n_ticks=nt)
    if prof is not None:
        from slam_tpu_torch import spans
        from slam_tpu_torch.runtime.profiling import span_table, step_table
        print(span_table(spans.summary()), file=sys.stderr)
        print(step_table(spans.steps()), file=sys.stderr)
    metrics = compute_metrics(result)
    print(metrics.summary(), file=sys.stderr)
    path = write_report(result, sim_name, out_dir)
    print(f"report: {path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
