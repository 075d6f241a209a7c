"""The port's streaming run (slam_tpu_torch.runtime.stream,
``Runner.run_streaming``) against the JAX package's, on the CPU, on
data/ring40 (its vehicle first sees a landmark at superstep 37; the runs
go 45 supersteps).

- FASTSLAM1 (P = 64) and EKF1 stream into capture sockets in both
  packages: the same tags in the same order, every message accepted by
  tests/test_telemetry.py's StrictController (the stock GUI's dispatch
  preconditions), one turn per superstep, the setup first, and the
  particle clouds or the ellipses there.
- With the noise off (control, sensor; heading unknown, so the EKF draws
  nothing and both packages see the same inputs) the EKF's decoded
  values (positions, cars, laser lines, ellipses) lie within rtol 1e-4
  (atol 1e-4 m) of JAX's.
- Host reads: one packed telemetry copy per superstep, one more with a
  plot for the clouds or ellipses, beside the gates; the traces equal
  ``Runner.run``'s bit for bit.
- A deferred state gets no clouds, as in the JAX package.
"""

import os
import struct

import numpy as np
import pytest
import test_golden_frames as golden
import test_telemetry
import torch

from slam_tpu import config as jconfig
from slam_tpu import maps as jmaps
from slam_tpu.runtime import Runner as JRunner
from slam_tpu.runtime import telemetry as jtel
from slam_tpu_torch import config as tconfig
from slam_tpu_torch import maps as tmaps
from slam_tpu_torch.models import FastSlam1Deferred
from slam_tpu_torch.runtime import Runner
from slam_tpu_torch.runtime import telemetry as ttel

DATA = os.path.join(os.path.dirname(__file__), os.pardir, "data")
SUPERSTEPS = 45
SETUP = ["setPlotRange", "setSimulationName", "setCarSize", "setCarSize",
         "setLandmarks", "setWaypoints"]
NOISE_OFF = dict(SWITCH_CONTROL_NOISE=0, SWITCH_SENSOR_NOISE=0,
                 SWITCH_HEADING_KNOWN=0)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(**overrides):
    ini, mat = (os.path.join(DATA, f"ring40.{e}") for e in ("ini", "mat"))
    ov = {k: str(v) for k, v in overrides.items()}
    return (jconfig.SlamConfig.from_ini(ini, overrides=ov),
            jmaps.read_map_file(mat),
            tconfig.SlamConfig.from_ini(ini, overrides=ov),
            tmaps.read_map_file(mat))


def stream(method, **overrides):
    """Both packages' streaming runs of ``method``, seed 3:
    {package: (result, [messages])}."""
    jcfg, jmap, cfg, slam_map = configs(**overrides)
    n = SUPERSTEPS * cfg.steps_per_observe
    P = 64 if method != "EKF1" else None
    out = {}
    for name, runner, module in (
            ("jax", JRunner(jcfg, jmap, method, n_particles=P), jtel),
            ("port", Runner(cfg, slam_map, method, n_particles=P,
                            device="cpu"), ttel)):
        sock = golden._CaptureSocket()
        result = runner.run_streaming(seed=3, n_ticks=n, sim_name="ring40",
                                      plot=module.NetworkPlot(socket=sock))
        out[name] = (result, sock.sent)
    return out


@pytest.fixture(scope="module")
def streams():
    return {m: stream(m) for m in ("FASTSLAM1", "EKF1")}


def tags(messages):
    return [m[0].decode() for m in messages]


@pytest.mark.parametrize("method,needs", [
    ("FASTSLAM1", ("setParticles", "setFeatureParticles")),
    ("EKF1", ("covEllipseAdd", "setCovEllipse")),
])
def test_stream_matches_jax_and_the_gui(streams, method, needs):
    (jres, jmsg), (tres, tmsg) = (streams[method][k]
                                  for k in ("jax", "port"))
    assert tags(tmsg) == tags(jmsg)
    ctrl = test_telemetry.StrictController()
    for frames in tmsg:
        ctrl.feed(frames)
    assert ctrl.done and ctrl.n_turns == len(tres.est_pose) == SUPERSTEPS
    assert len(jres.est_pose) == SUPERSTEPS
    assert tags(tmsg)[:len(SETUP)] == SETUP
    for tag in needs:
        assert ctrl.counts.get(tag, 0) > 0, tag
    # The setup messages carry the same map and range, byte for byte.
    assert tmsg[:len(SETUP)] == jmsg[:len(SETUP)]


def test_stream_host_reads(streams):
    """FASTSLAM1: the gate, the telemetry copy and the cloud copy per
    superstep; EKF1: the telemetry and ellipse copies. Without a plot,
    the telemetry copy alone beside the gate; the traces equal run's."""
    for method, per in (("FASTSLAM1", 3), ("EKF1", 2)):
        tres = streams[method]["port"][0]
        assert tres.host_syncs == per * SUPERSTEPS, (method, tres.host_syncs)
    *_, cfg, slam_map = configs()
    n = SUPERSTEPS * cfg.steps_per_observe
    for method, per in (("FASTSLAM1", 2), ("EKF1", 1)):
        P = 64 if method != "EKF1" else None
        headless = Runner(cfg, slam_map, method, n_particles=P,
                          device="cpu").run_streaming(seed=3, n_ticks=n)
        assert headless.host_syncs == per * SUPERSTEPS, method
        ref = Runner(cfg, slam_map, method, n_particles=P,
                     device="cpu").run(seed=3, n_ticks=n)
        for f in ("true_pose", "est_pose", "active", "obs_count",
                  "obs_range_sum", "obs_z", "obs_mask", "obs_ids", "odom"):
            got, want = getattr(headless, f), getattr(ref, f)
            assert got.dtype == want.dtype, f
            np.testing.assert_array_equal(got, want, err_msg=f)
        assert headless.host_syncs == ref.host_syncs + SUPERSTEPS


def values(frames):
    """The numbers of one message, as floats (loopTime: none)."""
    tag, body = frames[0].decode(), frames[1:]
    if tag in ("setLaserLines", "setCovEllipse"):
        mat, rest = golden._decode_matrix(body)
        return list(mat.reshape(-1)) + [struct.unpack(">i", f)[0]
                                        for f in rest]
    if tag in ("setLandmarks", "setWaypoints", "setParticles",
               "setFeatureParticles"):
        xs, ys = golden._decode_xy(body)
        return xs + ys
    if tag in ("loopTime", "setSimulationName"):
        return []
    return list(ttel.decode_message(frames)[1])


def test_ekf_values_match_jax_with_the_noise_off():
    s = stream("EKF1", **NOISE_OFF)
    (jres, jmsg), (tres, tmsg) = s["jax"], s["port"]
    assert tags(tmsg) == tags(jmsg)
    assert "setCovEllipse" in tags(tmsg)
    np.testing.assert_array_equal(tres.obs_ids, jres.obs_ids)
    n_ellipses = 0
    for t, j in zip(tmsg, jmsg):
        got, want = values(t), values(j)
        assert len(got) == len(want), t[0]
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                   err_msg=t[0].decode())
        n_ellipses += t[0] == b"setCovEllipse"
    assert n_ellipses > SUPERSTEPS      # landmarks' ellipses beside the pose's


def test_deferred_state_streams_without_clouds():
    """FastSlam1Deferred's carry is no ParticleState: no clouds, as in
    the JAX package's _emit_state; one telemetry read and the gate per
    superstep."""
    *_, cfg, slam_map = configs()
    est = FastSlam1Deferred(cfg, slam_map.n_landmarks, device="cpu")
    runner = Runner(cfg, slam_map, "FASTSLAM1", n_particles=1024,
                    estimator=est)
    sock = golden._CaptureSocket()
    result = runner.run_streaming(seed=3, n_ticks=4 * cfg.steps_per_observe,
                                  plot=ttel.NetworkPlot(socket=sock))
    got = tags(sock.sent)
    assert "setParticles" not in got and got.count("plot") == 4
    assert result.host_syncs == 2 * 4
