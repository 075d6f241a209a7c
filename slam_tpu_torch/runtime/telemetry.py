"""ZMQ telemetry publisher, wire-compatible with the stock slam-gui
(counterpart: slam_tpu.runtime.telemetry, whose frames these are byte
for byte).

The NetworkPlot protocol (src/backend/plotting/NetworkPlot.cpp, receiver
dispatch src/gui/plotting/Controller.cpp:35-227): a ZMQ PAIR socket
connecting to tcp://127.0.0.1:4242 (the GUI binds and starts first),
multipart messages whose first frame is an ASCII tag and every later
scalar its own frame in network byte order (zmqpp's encoding,
libs/zmqpp/message.cpp:233-305: htonl for ints, byte-swapped IEEE 754
for float and double).

No Python ZMQ binding is assumed: frames go through the system libzmq
by ctypes. Without libzmq, construction raises ``OSError`` and callers
run headless. numpy and ctypes only; no torch.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import struct

import numpy as np

ZMQ_PAIR = 0
ZMQ_SNDMORE = 2
ZMQ_DONTWAIT = 1
ZMQ_RCVMORE = 13


class LibZmq:
    """Minimal ctypes binding over libzmq (send/recv path only)."""

    def __init__(self, path: str | None = None):
        name = path or ctypes.util.find_library("zmq") or "libzmq.so.5"
        self.lib = ctypes.CDLL(name, use_errno=True)
        self.lib.zmq_ctx_new.restype = ctypes.c_void_p
        self.lib.zmq_socket.restype = ctypes.c_void_p
        self.lib.zmq_socket.argtypes = [ctypes.c_void_p, ctypes.c_int]
        for fn in ("zmq_connect", "zmq_bind"):
            getattr(self.lib, fn).argtypes = [ctypes.c_void_p,
                                              ctypes.c_char_p]
        self.lib.zmq_send.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.c_size_t, ctypes.c_int]
        self.lib.zmq_recv.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.c_size_t, ctypes.c_int]
        self.lib.zmq_getsockopt.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_size_t)]
        self.lib.zmq_close.argtypes = [ctypes.c_void_p]
        self.lib.zmq_ctx_term.argtypes = [ctypes.c_void_p]


class ZmqPairSocket:
    """A PAIR socket with multipart send/recv (frames as bytes)."""

    def __init__(self, endpoint: str, bind: bool = False,
                 lib: LibZmq | None = None):
        self._zmq = lib or LibZmq()
        self._ctx = self._zmq.lib.zmq_ctx_new()
        self._sock = self._zmq.lib.zmq_socket(self._ctx, ZMQ_PAIR)
        op = self._zmq.lib.zmq_bind if bind else self._zmq.lib.zmq_connect
        rc = op(self._sock, endpoint.encode())
        if rc != 0:
            raise OSError(f"zmq {'bind' if bind else 'connect'} "
                          f"{endpoint} failed (errno "
                          f"{ctypes.get_errno()})")

    def send_multipart(self, frames) -> None:
        for i, frame in enumerate(frames):
            flags = ZMQ_SNDMORE if i < len(frames) - 1 else 0
            rc = self._zmq.lib.zmq_send(self._sock, frame, len(frame),
                                        flags)
            if rc < 0:
                raise OSError("zmq_send failed")

    def recv_multipart(self, max_frame: int = 1 << 20,
                       dontwait: bool = False):
        """Receive one multipart message as a list of byte frames, or
        None when dontwait and nothing pending."""
        frames = []
        buf = ctypes.create_string_buffer(max_frame)
        more = ctypes.c_int(1)
        more_size = ctypes.c_size_t(ctypes.sizeof(more))
        first = True
        while more.value:
            flags = ZMQ_DONTWAIT if (dontwait and first) else 0
            n = self._zmq.lib.zmq_recv(self._sock, buf, max_frame, flags)
            if n < 0:
                if dontwait and first:
                    return None
                raise OSError("zmq_recv failed")
            first = False
            frames.append(buf.raw[:min(n, max_frame)])
            self._zmq.lib.zmq_getsockopt(self._sock, ZMQ_RCVMORE,
                                         ctypes.byref(more),
                                         ctypes.byref(more_size))
        return frames

    def close(self):
        if self._sock:
            self._zmq.lib.zmq_close(self._sock)
            self._sock = None
        if self._ctx:
            self._zmq.lib.zmq_ctx_term(self._ctx)
            self._ctx = None


# -- zmqpp scalar encodings (network byte order) ---------------------------

def _i32(v) -> bytes:
    return struct.pack(">i", int(v))


def _u32(v) -> bytes:
    return struct.pack(">I", int(v))


def _f32(v) -> bytes:
    return struct.pack(">f", float(v))


def _f64(v) -> bytes:
    return struct.pack(">d", float(v))


class NetworkPlot:
    """The reference NetworkPlot API, one message type per method
    (NetworkPlot.cpp; tag table in SURVEY.md §2.6)."""

    def __init__(self, endpoint: str = "tcp://127.0.0.1:4242",
                 socket: ZmqPairSocket | None = None):
        self.socket = socket or ZmqPairSocket(endpoint, bind=False)

    # -- xs/ys array family (sendXYArrays, NetworkPlot.cpp:22-34) ------
    def _send_xy(self, tag: str, xs, ys):
        frames = [tag.encode(), _i32(len(xs))]
        frames += [_f64(x) for x in xs]
        frames.append(_i32(len(ys)))
        frames += [_f64(y) for y in ys]
        self.socket.send_multipart(frames)

    def set_landmarks(self, xs, ys):
        self._send_xy("setLandmarks", xs, ys)

    def set_waypoints(self, xs, ys):
        self._send_xy("setWaypoints", xs, ys)

    def set_particles(self, xs, ys):
        self._send_xy("setParticles", xs, ys)

    def set_feature_particles(self, xs, ys):
        self._send_xy("setFeatureParticles", xs, ys)

    # -- float-matrix family (NetworkPlot.cpp:68-98) --------------------
    def _send_matrix(self, tag: str, mat, extra=()):
        mat = np.asarray(mat, dtype=np.float32)
        frames = [tag.encode(), _u32(mat.shape[0]), _u32(mat.shape[1])]
        frames += [_f32(v) for v in mat.reshape(-1)]
        frames += list(extra)
        self.socket.send_multipart(frames)

    def set_laser_lines(self, lines):
        """``lines``: [4, n] rows (x0; y0; x1; y1) — the reference sends
        makeLaserLines output row-major (core.cpp:330-355)."""
        self._send_matrix("setLaserLines", lines)

    def set_cov_ellipse(self, ellipse, idx: int):
        self._send_matrix("setCovEllipse", ellipse, extra=[_i32(idx)])

    # -- positions / cars ----------------------------------------------
    def add_true_position(self, x, y):
        self.socket.send_multipart([b"addTruePosition", _f64(x), _f64(y)])

    def add_estimated_position(self, x, y):
        self.socket.send_multipart([b"addEstimatedPosition", _f64(x),
                                    _f64(y)])

    def set_car_size(self, s, car_id: int = 0):
        self.socket.send_multipart([b"setCarSize", _f64(s),
                                    _u32(car_id)])

    def set_car_true_position(self, x, y, t):
        self.socket.send_multipart([b"setCarTruePosition", _f64(x),
                                    _f64(y), _f64(t)])

    def set_car_estimated_position(self, x, y, t):
        self.socket.send_multipart([b"setCarEstimatedPosition", _f64(x),
                                    _f64(y), _f64(t)])

    def set_plot_range(self, xmin, xmax, ymin, ymax):
        self.socket.send_multipart([b"setPlotRange", _f64(xmin),
                                    _f64(xmax), _f64(ymin), _f64(ymax)])

    # -- control -------------------------------------------------------
    def clear(self):
        self.socket.send_multipart([b"clear"])

    def set_simulation_name(self, name: str):
        self.socket.send_multipart([b"setSimulationName", name.encode()])

    def set_current_iteration(self, iteration: int):
        # Disabled in the reference due to an untracked ZMQ race
        # (NetworkPlot.cpp:176-186); kept as a no-op for API parity.
        pass

    def cov_ellipse_add(self, n: int):
        self.socket.send_multipart([b"covEllipseAdd", _u32(n)])

    def plot(self):
        self.socket.send_multipart([b"plot"])

    def end_plot(self):
        self.socket.send_multipart([b"endPlot"])

    def loop_time(self, microseconds: int):
        self.socket.send_multipart([b"loopTime", _u32(microseconds)])

    def close(self):
        self.socket.close()


# -- decoding (for tests and a headless gatherer) --------------------------

_TAG_DECODERS = {
    "addTruePosition": (">d", ">d"),
    "addEstimatedPosition": (">d", ">d"),
    "setCarTruePosition": (">d", ">d", ">d"),
    "setCarEstimatedPosition": (">d", ">d", ">d"),
    "setCarSize": (">d", ">I"),
    "setPlotRange": (">d", ">d", ">d", ">d"),
    "loopTime": (">I",),
    "covEllipseAdd": (">I",),
}


def decode_message(frames):
    """Decode one multipart message into (tag, values) for the fixed-
    layout tags; array-family tags return raw frames after the tag."""
    tag = frames[0].decode()
    fmts = _TAG_DECODERS.get(tag)
    if fmts is None:
        return tag, frames[1:]
    return tag, [struct.unpack(f, fr)[0] for f, fr in zip(fmts,
                                                          frames[1:])]
