"""The port's own config and map code against the JAX package's.

``slam_tpu_torch.config`` and ``slam_tpu_torch.maps`` are copies, not
re-exports, of ``slam_tpu.config`` and ``slam_tpu.maps``: each package
builds its own ``SlamConfig`` and ``SlamMap`` from the same ``.ini``,
the same keyword arguments or the same map file, and they must agree
field for field (``dataclasses.asdict``) and array for array, exactly.
"""

import dataclasses
import os

import numpy as np
import pytest

from slam_tpu import config as jconfig
from slam_tpu import maps as jmaps
from slam_tpu_torch import config as tconfig
from slam_tpu_torch import maps as tmaps

DATA = os.path.join(os.path.dirname(__file__), os.pardir, "data")
DERIVED = ("steps_per_observe", "Q", "R", "Qe", "Re")

# Flag sets as a user gives them on the command line.
FLAGS = {
    "particles": ["-NPARTICLES", "4096", "-NEFFECTIVE", "3072"],
    "noise": ["-sigmaV", "0.5", "-sigmaG", "0.07", "-SWITCH_INFLATE_NOISE",
              "1"],
    "heading": ["-SWITCH_HEADING_KNOWN", "0", "-Vtrue", "4.5", "-seed",
                "7", "stray"],
    "capacity": ["-max_landmarks", "192", "-max_observations", "96.0",
                 "-DT_OBSERVE", "0.1"],
}


def _assert_same_config(tcfg, jcfg):
    assert type(tcfg) is tconfig.SlamConfig
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    for name in DERIVED:
        assert getattr(tcfg, name) == getattr(jcfg, name), name


@pytest.mark.parametrize("ini", [None, "dense200.ini", "ring40.ini"])
def test_config_matches_jax(ini):
    if ini is None:
        _assert_same_config(tconfig.SlamConfig(), jconfig.SlamConfig())
    else:
        path = os.path.join(DATA, ini)
        _assert_same_config(tconfig.SlamConfig.from_ini(path),
                            jconfig.SlamConfig.from_ini(path))


@pytest.mark.parametrize("flags", sorted(FLAGS))
@pytest.mark.parametrize("ini", [None, "dense200.ini"])
def test_cli_overrides_match_jax(flags, ini):
    argv = FLAGS[flags]
    over = tconfig.apply_cli_overrides(argv)
    assert over == jconfig.apply_cli_overrides(argv)
    if ini is None:
        got = tconfig.SlamConfig.from_mapping(over)
        want = jconfig.SlamConfig.from_mapping(over)
    else:
        path = os.path.join(DATA, ini)
        got = tconfig.SlamConfig.from_ini(path, overrides=over)
        want = jconfig.SlamConfig.from_ini(path, overrides=over)
    _assert_same_config(got, want)
    kw = dict(SWITCH_CONTROL_NOISE=0, V=1.5)
    _assert_same_config(got.replace(**kw), want.replace(**kw))


def _assert_same_map(tmap, jmap):
    assert type(tmap) is tmaps.SlamMap
    for name in ("landmarks", "waypoints"):
        got, want = getattr(tmap, name), getattr(jmap, name)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert tmap.n_landmarks == jmap.n_landmarks
    assert tmap.n_waypoints == jmap.n_waypoints
    np.testing.assert_array_equal(tmap.extent(), jmap.extent())


@pytest.mark.parametrize("name", ["dense200.mat", "ring40.mat"])
def test_read_map_file_matches_jax(name):
    path = os.path.join(DATA, name)
    _assert_same_map(tmaps.read_map_file(path), jmaps.read_map_file(path))


@pytest.mark.parametrize("args,kw", [
    ((35, 17), dict(radius=100.0)),
    ((10_000,), dict(n_waypoints=17, radius=200.0, seed=5)),
], ids=["fastslam2_1m", "config5"])
def test_synthetic_map_matches_jax(args, kw):
    _assert_same_map(tmaps.synthetic_map(*args, **kw),
                     jmaps.synthetic_map(*args, **kw))


@pytest.mark.parametrize("source", ["ring40.mat", "synthetic"])
def test_map_file_round_trip_is_exact(tmp_path, source):
    """The writer prints six decimals, so a map read from a file (or
    written once) reads back bit for bit; both packages write the same
    bytes."""
    if source == "synthetic":
        first = tmp_path / "first.mat"
        tmaps.write_map_file(str(first), tmaps.synthetic_map(35, 17))
        slam_map = tmaps.read_map_file(str(first))
    else:
        slam_map = tmaps.read_map_file(os.path.join(DATA, source))
    t_path, j_path = tmp_path / "port.mat", tmp_path / "jax.mat"
    tmaps.write_map_file(str(t_path), slam_map)
    jmaps.write_map_file(str(j_path), jmaps.SlamMap(
        landmarks=slam_map.landmarks, waypoints=slam_map.waypoints))
    assert t_path.read_bytes() == j_path.read_bytes()
    again = tmaps.read_map_file(str(t_path))
    np.testing.assert_array_equal(again.landmarks, slam_map.landmarks)
    np.testing.assert_array_equal(again.waypoints, slam_map.waypoints)


@pytest.mark.parametrize("text,match", [
    ("lm 2 1\n1.0 2.0\n", "missing lm or wp"),
    ("lm 2 2\n1.0 2.0\n", "EOF"),
    ("xx 2 1\n1.0 2.0\n", "bad section header"),
    ("lm 2 1\n1.0\nwp 2 1\n0 0\n", "short data line"),
])
def test_read_map_file_refuses_what_jax_refuses(tmp_path, text, match):
    path = tmp_path / "bad.mat"
    path.write_text(text)
    for maps in (tmaps, jmaps):
        with pytest.raises(ValueError, match=match):
            maps.read_map_file(str(path))
