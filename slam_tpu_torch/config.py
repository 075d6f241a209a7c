"""Typed configuration (counterpart: slam_tpu.config).

The port's own copy of the JAX package's ``SlamConfig``: the same
fields, defaults, ``.ini`` dialect and CLI overrides, so both packages
read one ``.ini`` file into configs that agree field for field
(tests/test_torch_config.py holds them to it). A frozen dataclass:

    compiled defaults  <-  ``<map>.ini`` file  <-  explicit overrides (CLI).

The defaults mirror the reference simulator's (src/backend/core.cpp:
974-1028). The ``.ini`` dialect is the reference one: ``name = value``
lines, ``#`` and ``:`` comments (src/backend/utils.cpp:504-565); the
key ``Vtrue`` maps to the field ``V``.

The capacity fields (``max_landmarks``, ``max_observations``) have no
reference counterpart: the particle state has static shapes, so
capacities are part of the config and growth is mask-driven.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Mapping

_PI = math.pi

# .ini key -> dataclass field, for keys whose names differ.
_KEY_ALIASES = {"Vtrue": "V"}


@dataclass(frozen=True)
class SlamConfig:
    # --- control parameters (reference: core.cpp:977-981) ---
    V: float = 3.0  # vehicle speed, m/s
    MAXG: float = 30.0 * _PI / 180.0  # max steering angle, rad
    RATEG: float = 20.0 * _PI / 180.0  # max steering rate, rad/s
    WHEELBASE: float = 4.0  # vehicle wheelbase, m
    DT_CONTROLS: float = 0.025  # control period, s

    # --- control noise (core.cpp:984-985) ---
    sigmaV: float = 0.3  # speed noise, m/s
    sigmaG: float = 3.0 * _PI / 180.0  # steering noise, rad

    # --- observation parameters (core.cpp:989-995) ---
    MAX_RANGE: float = 30.0  # sensor range, m
    DT_OBSERVE: float = 8 * 0.025  # observation period, s
    sigmaR: float = 0.1  # range noise, m
    sigmaB: float = 1.0 * _PI / 180.0  # bearing noise, rad
    sigmaT: float = 1.0 * _PI / 180.0  # IMU heading noise, rad

    # --- data-association gates (core.cpp:999-1000) ---
    GATE_REJECT: float = 4.0
    GATE_AUGMENT: float = 25.0

    # --- waypoints (core.cpp:1007-1008) ---
    AT_WAYPOINT: float = 1.0
    NUMBER_LOOPS: int = 2

    # --- particles (core.cpp:1011-1012) ---
    NPARTICLES: int = 100
    NEFFECTIVE: int = 75

    # --- switches (core.cpp:1015-1028) ---
    SWITCH_CONTROL_NOISE: int = 1
    SWITCH_SENSOR_NOISE: int = 1
    SWITCH_INFLATE_NOISE: int = 0
    SWITCH_PREDICT_NOISE: int = 0
    SWITCH_SAMPLE_PROPOSAL: int = 1
    SWITCH_HEADING_KNOWN: int = 1
    SWITCH_RESAMPLE: int = 1
    SWITCH_PROFILE: int = 1
    SWITCH_SEED_RANDOM: int = 0
    SWITCH_ASSOCIATION_KNOWN: int = 0
    SWITCH_BATCH_UPDATE: int = 1
    SWITCH_USE_IEKF: int = 0

    # --- static capacities (no reference counterpart) ---
    # Maximum number of landmarks a filter map can hold. Padded/masked.
    max_landmarks: int = 0  # 0 => sized from the map at setup time
    # Maximum simultaneously visible observations. Padded/masked.
    max_observations: int = 0  # 0 => sized from the map at setup time
    # Particle pose-estimate variant, the reference's compile-time
    # ESTIMATE_WITH_{MEAN,MEDIAN,WEIGHTS} (ParticleSLAMWrapper.cpp:
    # 56-119) as a runtime switch: "mean" | "median" | "weighted". The
    # heading always comes from the max-weight particle.
    POSE_ESTIMATE: str = "weighted"

    # ------------------------------------------------------------------
    @property
    def steps_per_observe(self) -> int:
        """Control ticks between observations (the reference observes
        when the accumulated dt reaches DT_OBSERVE,
        ekfslamwrapper.cpp:61-66)."""
        return max(1, round(self.DT_OBSERVE / self.DT_CONTROLS))

    @property
    def Q(self):
        """Control-noise covariance diag([sigmaV^2, sigmaG^2])
        (slamwrapper.cpp:25-26), doubled under SWITCH_INFLATE_NOISE."""
        q = [self.sigmaV**2, self.sigmaG**2]
        if self.SWITCH_INFLATE_NOISE:
            q = [2 * v for v in q]
        return q

    @property
    def R(self):
        """Observation-noise covariance diag([sigmaR^2, sigmaB^2])
        (slamwrapper.cpp:28-29), doubled under SWITCH_INFLATE_NOISE."""
        r = [self.sigmaR**2, self.sigmaB**2]
        if self.SWITCH_INFLATE_NOISE:
            r = [2 * v for v in r]
        return r

    @property
    def Qe(self):
        """Estimator control-noise covariance: the uninflated Q, always
        (the reference leaves it at the uninflated Q,
        slamwrapper.cpp:31-37)."""
        return [self.sigmaV**2, self.sigmaG**2]

    @property
    def Re(self):
        """Estimator observation-noise covariance (see Qe)."""
        return [self.sigmaR**2, self.sigmaB**2]

    def replace(self, **kw) -> "SlamConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    @classmethod
    def from_ini(cls, path: str, overrides: Mapping[str, str] | None = None
                 ) -> "SlamConfig":
        """Load a reference-format ``.ini`` file, then apply overrides."""
        values = _parse_ini(path)
        if overrides:
            values.update(overrides)
        return cls.from_mapping(values)

    @classmethod
    def from_mapping(cls, values: Mapping[str, object]) -> "SlamConfig":
        """A config from ``name -> value`` pairs; unknown names are
        ignored, as the reference ignores extra keys."""
        fields = {f.name: f for f in dataclasses.fields(cls)}
        kwargs = {}
        for raw_key, raw_val in values.items():
            key = _KEY_ALIASES.get(raw_key, raw_key)
            field = fields.get(key)
            if field is None:
                continue
            if field.type in ("int", int):
                kwargs[key] = int(float(raw_val))
            else:
                kwargs[key] = float(raw_val)
        return cls(**kwargs)


def _parse_ini(path: str) -> dict:
    """Parse the reference ``.ini`` dialect (utils.cpp:504-565):
    ``name = value``; ``#`` or ``:`` start a comment; blank lines
    skipped."""
    out: dict = {}
    with open(path, "r") as fh:
        for line in fh:
            for comment_char in ("#", ":"):
                idx = line.find(comment_char)
                if idx >= 0:
                    line = line[:idx]
            line = line.strip()
            if not line or "=" not in line:
                continue
            name, _, value = line.partition("=")
            out[name.strip()] = value.strip()
    return out


def apply_cli_overrides(argv: list[str]) -> dict:
    """Turn reference-style CLI flags ``-KEY value`` into an override
    mapping (utils.cpp:1032-1046: any config key can be overridden as a
    flag)."""
    out = {}
    i = 0
    while i < len(argv):
        tok = argv[i]
        if tok.startswith("-") and i + 1 < len(argv):
            out[tok.lstrip("-")] = argv[i + 1]
            i += 2
        else:
            i += 1
    return out


__all__ = ["SlamConfig", "apply_cli_overrides"]
