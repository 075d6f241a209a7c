"""The port's telemetry (slam_tpu_torch.runtime.telemetry and .native)
against the JAX package's, on the CPU.

- Every NetworkPlot method sends frames byte-equal to the JAX
  publisher's, through capture sockets.
- The reference encoder's captured messages (tests/data/
  golden_zmq_frames.bin) re-encode byte-identical through the port's
  publisher, as tests/test_golden_frames.py holds the JAX one.
- ``decode_message`` equals the JAX package's on every message.
- A real PAIR round trip (skips without libzmq, as
  tests/test_telemetry.py does).
- The native publisher's frames equal the Python ones, and
  ``load_map_native`` equals ``read_map_file`` on data/dense200 (skip
  without the native library, as tests/test_native.py does).
"""

import os

import numpy as np
import pytest
import test_golden_frames as golden

from slam_tpu.runtime import telemetry as jtel
from slam_tpu_torch.maps import read_map_file
from slam_tpu_torch.runtime import telemetry as ttel

DATA = os.path.join(os.path.dirname(__file__), os.pardir, "data")

MAT = np.arange(12, dtype=np.float32).reshape(4, 3) * 0.37 - 1.5

# (method, arguments): every message of the NetworkPlot API, the edges
# (empty arrays, negative and huge values) included.
CALLS = [
    ("set_landmarks", ([1.0, 2.5, -1e30], [3.0, -4.0, 7.25])),
    ("set_waypoints", ([0.5], [0.25, 9.0])),
    ("set_particles", (list(np.float32([7.1, -8.3])), [8.0, 1e-7])),
    ("set_feature_particles", ([], [])),
    ("set_laser_lines", (MAT,)),
    ("set_laser_lines", (np.zeros((4, 0), np.float32),)),
    ("set_cov_ellipse", (MAT[:2], 3)),
    ("add_true_position", (1.0, np.float32(2.1))),
    ("add_estimated_position", (-1.0, 0.125)),
    ("set_car_size", (2.5, 1)),
    ("set_car_true_position", (1, 2, 3)),
    ("set_car_estimated_position", (4.5, -5.5, np.float32(3.1415927))),
    ("set_plot_range", (-1, 1, -2, 2)),
    ("clear", ()),
    ("set_simulation_name", ("simulation",)),
    ("set_current_iteration", (7,)),
    ("cov_ellipse_add", (5,)),
    ("plot", ()),
    ("end_plot", ()),
    ("loop_time", (4294967295,)),
]


def sent(module, method, args):
    sock = golden._CaptureSocket()
    getattr(module.NetworkPlot(socket=sock), method)(*args)
    return sock.sent


@pytest.mark.parametrize("method,args", CALLS,
                         ids=[f"{m}-{i}" for i, (m, _) in enumerate(CALLS)])
def test_frames_equal_jax(method, args):
    got, want = sent(ttel, method, args), sent(jtel, method, args)
    assert got == want
    for frames in got:
        assert ttel.decode_message(frames) == jtel.decode_message(frames)


def test_golden_frames_reencode_byte_identical():
    if not os.path.exists(golden.FIXTURE):
        pytest.skip("golden fixture absent")
    messages = golden._read_fixture(golden.FIXTURE)
    assert len(messages) >= 500
    sock = golden._CaptureSocket()
    plot = ttel.NetworkPlot(socket=sock)
    for i, frames in enumerate(messages):
        sock.sent.clear()
        golden._reencode(plot, frames[0].decode(), frames[1:])
        assert sock.sent == [frames], (i, frames[0])
        assert ttel.decode_message(frames) == jtel.decode_message(frames)


@pytest.fixture
def libzmq():
    try:
        ttel.LibZmq()
    except OSError:
        pytest.skip("libzmq not available")


@pytest.fixture(scope="module")
def native():
    """The port's native module, once its library loads (it is built on
    first use); skips without it."""
    from slam_tpu_torch.runtime import native
    if not native.native_available():
        pytest.skip("native library not buildable here")
    return native


def test_pair_round_trip(libzmq):
    ep = "tcp://127.0.0.1:45471"
    server = ttel.ZmqPairSocket(ep, bind=True)
    plot = ttel.NetworkPlot(socket=ttel.ZmqPairSocket(ep, bind=False))
    try:
        for method, args in CALLS:
            plot_frames = sent(ttel, method, args)
            getattr(plot, method)(*args)
            for frames in plot_frames:
                assert server.recv_multipart() == frames, method
        assert server.recv_multipart(dontwait=True) is None
    finally:
        plot.close()
        server.close()


def test_native_frames_equal_python(libzmq, native):
    ep = "tcp://127.0.0.1:45472"
    server = ttel.ZmqPairSocket(ep, bind=True)
    plot = native.NativeNetworkPlot(ep)
    try:
        for method, args in CALLS:
            getattr(plot, method)(*args)
            for frames in sent(ttel, method, args):
                assert server.recv_multipart() == frames, method
    finally:
        plot.close()
        server.close()


def test_native_map_loader_matches_python(native):
    path = os.path.join(DATA, "dense200.mat")
    lm, wp = native.load_map_native(path)
    ref = read_map_file(path)
    assert lm.shape == ref.landmarks.shape and wp.shape == ref.waypoints.shape
    np.testing.assert_allclose(lm, ref.landmarks, atol=1e-6)
    np.testing.assert_allclose(wp, ref.waypoints, atol=1e-6)
