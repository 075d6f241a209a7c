"""Map I/O: landmark and waypoint maps (counterpart: slam_tpu.maps).

The port's own copy of the JAX package's reader and writer (numpy
only), held to give equal arrays by tests/test_torch_config.py. Reads
the reference's text ``.mat`` format (src/backend/core.cpp:855-962):

    # comment
    lm <rows> <cols>
    <cols lines of rows floats>     # one landmark per line
    wp <rows> <cols>
    <cols lines of rows floats>

Maps are row-major numpy arrays: ``landmarks [N, 2]`` and
``waypoints [W, 2]``. ``synthetic_map`` builds the large worlds of the
scaling workloads (BASELINE config #5), which have no reference file.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class SlamMap:
    landmarks: np.ndarray  # [N, 2] float32
    waypoints: np.ndarray  # [W, 2] float32

    @property
    def n_landmarks(self) -> int:
        return int(self.landmarks.shape[0])

    @property
    def n_waypoints(self) -> int:
        return int(self.waypoints.shape[0])

    def extent(self):
        """(xmin, xmax, ymin, ymax) over landmarks and waypoints, padded
        by 5 % (the reference's plot range, slamwrapper.cpp:141-172)."""
        pts = np.concatenate([self.landmarks, self.waypoints], axis=0)
        xmin, ymin = pts.min(axis=0)
        xmax, ymax = pts.max(axis=0)
        dx, dy = xmax - xmin, ymax - ymin
        return (xmin - 0.05 * dx, xmax + 0.05 * dx,
                ymin - 0.05 * dy, ymax + 0.05 * dy)


def read_map_file(path: str) -> SlamMap:
    """Parse a reference-format map file into a SlamMap, as the
    reference's readInputFile does (core.cpp:855-962): ``#`` comment
    lines and blank lines skipped; ``lm``/``wp`` headers give (rows,
    cols); the next ``cols`` data lines each carry ``rows`` floats."""
    sections = {}
    with open(path, "r") as fh:
        lines = [ln.strip() for ln in fh]
    data_lines = iter(ln for ln in lines if ln and not ln.startswith("#"))
    for header in data_lines:
        tokens = header.split()
        if tokens[0] not in ("lm", "wp") or len(tokens) != 3:
            raise ValueError(f"{path}: bad section header: {header!r}")
        rows, cols = int(float(tokens[1])), int(float(tokens[2]))
        data = np.empty((cols, rows), dtype=np.float32)
        for c in range(cols):
            vals = next(data_lines, None)
            if vals is None:
                raise ValueError(f"{path}: unexpected EOF inside section")
            vals = vals.split()
            if len(vals) < rows:
                raise ValueError(f"{path}: short data line in {tokens[0]}")
            data[c] = [float(v) for v in vals[:rows]]
        sections[tokens[0]] = data
    if "lm" not in sections or "wp" not in sections:
        raise ValueError(f"{path}: missing lm or wp section")
    return SlamMap(landmarks=sections["lm"], waypoints=sections["wp"])


def write_map_file(path: str, slam_map: SlamMap) -> None:
    """Write a SlamMap in the reference text format; ``read_map_file``
    reads back the values as written (six decimals)."""
    with open(path, "w") as fh:
        fh.write("#type columns rows\n")
        fh.write(f"lm 2 {slam_map.n_landmarks}\n")
        for x, y in slam_map.landmarks:
            fh.write(f"{x:.6f} {y:.6f}\n")
        fh.write(f"\nwp 2 {slam_map.n_waypoints}\n")
        for x, y in slam_map.waypoints:
            fh.write(f"{x:.6f} {y:.6f}\n")


def synthetic_map(n_landmarks: int, n_waypoints: int = 32,
                  radius: float = 200.0, seed: int = 0) -> SlamMap:
    """A large synthetic world: waypoints on a wobbly loop, landmarks
    scattered in an annulus around its corridor (BASELINE config #5's
    10k-landmark map)."""
    rng = np.random.default_rng(seed)
    theta = np.linspace(0.0, 2 * np.pi, n_waypoints, endpoint=False)
    r_wp = radius * (1.0 + 0.15 * np.sin(3 * theta))
    waypoints = np.stack([r_wp * np.cos(theta), r_wp * np.sin(theta)],
                         axis=1).astype(np.float32)
    ang = rng.uniform(0.0, 2 * np.pi, n_landmarks)
    rad = radius * (1.0 + rng.uniform(-0.4, 0.4, n_landmarks))
    landmarks = np.stack([rad * np.cos(ang), rad * np.sin(ang)],
                         axis=1).astype(np.float32)
    return SlamMap(landmarks=landmarks, waypoints=waypoints)


__all__ = ["SlamMap", "read_map_file", "synthetic_map", "write_map_file"]
