"""The world of a cell that runs a map file of the repository
(``data/<name>.mat``), read here with numpy and not with the program's
loader. The file is in matzipan/slam's text format (its
``readInputFile``):

    # comment
    lm <rows> <cols>
    <cols lines of rows numbers>     # one landmark a line
    wp <rows> <cols>
    <cols lines of rows numbers>     # one waypoint a line

``file_world`` reads a configuration's ``world`` entry: ``file``, the
map's path from the repository's root, and ``origin``, as
``benchmark.world.make_world`` takes it: "centre" leaves the map as the
file has it (the vehicle starts at the file's origin), "waypoint0"
shifts landmarks and waypoints so that waypoint 0, where the vehicle
then starts, is the origin. Imports numpy.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def read_map(path) -> dict:
    """{"lm": [N, 2], "wp": [W, 2]} float32 arrays of a map file."""
    lines = [ln.split() for ln in Path(path).read_text().splitlines()]
    lines = iter(ln for ln in lines if ln and not ln[0].startswith("#"))
    out = {}
    for head in lines:
        if len(head) != 3 or head[0] not in ("lm", "wp"):
            raise ValueError(f"{path}: bad section header {head}")
        rows, cols = int(float(head[1])), int(float(head[2]))
        out[head[0]] = np.array([[float(v) for v in next(lines)[:rows]]
                                 for _ in range(cols)], dtype=np.float32)
    if set(out) != {"lm", "wp"}:
        raise ValueError(f"{path}: needs an lm and a wp section")
    return out


def file_world(world: dict):
    """(landmarks [N, 2], waypoints [W, 2]) float32 of ``world``."""
    m = read_map(ROOT / world["file"])
    lms, wps = m["lm"], m["wp"]
    origin = world.get("origin", "centre")
    if origin == "waypoint0":
        shift = wps[0].copy()
        lms, wps = lms - shift, wps - shift
    elif origin != "centre":
        raise ValueError(f"world origin {origin!r}: centre or waypoint0")
    return lms, wps
