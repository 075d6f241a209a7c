"""Command-line shell of the port (counterpart: slam_tpu.cli).

Flag-compatible with the JAX package's CLI for the ported slice:
``-m <map.mat>``, ``-n <name>``, ``-method FASTSLAM1``, ``-particles``,
``-ticks``, ``-seed``, ``-out``, and any config key as ``-KEY value``.
The map's ``<map>.ini`` is loaded when it exists. ``-device`` picks
``cuda`` or ``cpu``; by default ``cuda`` when a card is present. The
device is printed with the banner.
"""

from __future__ import annotations

import os
import sys

from slam_tpu_torch.config import SlamConfig, apply_cli_overrides
from slam_tpu_torch.maps import read_map_file

USAGE = """\
slam_tpu_torch backend — landmark SLAM in PyTorch / CUDA
Usage: python -m slam_tpu_torch [options]
    -m <file>        map file (.mat text format)
    -n <name>        simulation name (report directory)
    -method <name>   FASTSLAM1 (the other methods are not ported yet)
    -particles <N>   particle count
    -ticks <N>       max control ticks
    -seed <N>        PRNG seed
    -device <dev>    cuda | cpu (default: cuda if available)
    -out <dir>       report output directory (default .)
    -KEY <value>     override any config key (e.g. -SWITCH_HEADING_KNOWN 0)
    -h               this help
"""

# Flags of the JAX CLI whose subsystems are not ported yet (ROADMAP.md).
_NOT_PORTED = ("plot", "profile", "ckpt")


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "-h" in argv or "--help" in argv:
        print(USAGE)
        return 0
    flags = apply_cli_overrides(argv)
    for name in _NOT_PORTED:
        if name in flags or f"-{name}" in argv:
            print(f"error: -{name} is not ported to slam_tpu_torch yet "
                  "(see ROADMAP.md)", file=sys.stderr)
            return 2

    map_path = flags.pop("m", None)
    if not map_path:
        print("error: no map file (-m)", file=sys.stderr)
        print(USAGE)
        return 2
    if flags.pop("mode", "waypoints") != "waypoints":
        print("error: only -mode waypoints is supported", file=sys.stderr)
        return 2
    sim_name = flags.pop("n", "simulation")
    method = flags.pop("method", "FASTSLAM1")
    n_particles = flags.pop("particles", None)
    n_ticks = flags.pop("ticks", None)
    seed = int(flags.pop("seed", 0))
    out_dir = flags.pop("out", ".")
    device = flags.pop("device", None)

    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"

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

    result = runner.run(seed=seed,
                        n_ticks=int(n_ticks) if n_ticks else None)
    metrics = compute_metrics(result)
    print(metrics.summary(), file=sys.stderr)
    path = write_report(result, sim_name, out_dir)
    print(f"report: {path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
