"""ctypes bindings to the native runtime library (native/libslam_native.so;
counterpart: slam_tpu.runtime.native).

``NativeNetworkPlot`` is the C++ telemetry publisher with the NetworkPlot
wire protocol of ``slam_tpu_torch.runtime.telemetry`` (its frames are
equal to the Python publisher's), and ``load_map_native`` the native map
reader. Callers check ``native_available()`` or catch ``OSError``; the
library is built on first use by tools/build_native.py. Host code only:
neither publisher touches the device.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_LIB_TRIED = False


def _load():
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    path = os.path.join(root, "native", "libslam_native.so")
    if not os.path.exists(path):
        try:
            import sys
            sys.path.insert(0, os.path.join(root, "tools"))
            from build_native import build
            built = build()
            if not built:
                return None
            path = built
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.tele_connect.restype = ctypes.c_void_p
    lib.tele_connect.argtypes = [ctypes.c_char_p]
    lib.tele_close.argtypes = [ctypes.c_void_p]
    lib.tele_send_xy.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.float64), ctypes.c_int,
        np.ctypeslib.ndpointer(np.float64), ctypes.c_int]
    lib.tele_send_matrix.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.float32), ctypes.c_uint32,
        ctypes.c_uint32, ctypes.c_int, ctypes.c_int]
    lib.tele_send_doubles.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.float64), ctypes.c_int]
    lib.tele_send_car_size.argtypes = [ctypes.c_void_p, ctypes.c_double,
                                       ctypes.c_uint32]
    lib.tele_send_u32_msg.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.c_uint32]
    lib.tele_send_string.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_char_p]
    lib.tele_send_bare.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.load_map_file.argtypes = [
        ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.float64), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
        np.ctypeslib.ndpointer(np.float64), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int)]
    _LIB = lib
    return lib


def native_available() -> bool:
    return _load() is not None


class NativeNetworkPlot:
    """C++ telemetry publisher with the NetworkPlot API (drop-in for
    slam_tpu_torch.runtime.telemetry.NetworkPlot)."""

    def __init__(self, endpoint: str = "tcp://127.0.0.1:4242"):
        lib = _load()
        if lib is None:
            raise OSError("libslam_native.so unavailable")
        self._lib = lib
        self._h = lib.tele_connect(endpoint.encode())
        if not self._h:
            raise OSError(f"native telemetry connect failed: {endpoint}")

    def _xy(self, tag, xs, ys):
        xs = np.ascontiguousarray(xs, np.float64)
        ys = np.ascontiguousarray(ys, np.float64)
        self._lib.tele_send_xy(self._h, tag, xs, len(xs), ys, len(ys))

    def set_landmarks(self, xs, ys):
        self._xy(b"setLandmarks", xs, ys)

    def set_waypoints(self, xs, ys):
        self._xy(b"setWaypoints", xs, ys)

    def set_particles(self, xs, ys):
        self._xy(b"setParticles", xs, ys)

    def set_feature_particles(self, xs, ys):
        self._xy(b"setFeatureParticles", xs, ys)

    def set_laser_lines(self, lines):
        m = np.ascontiguousarray(lines, np.float32)
        self._lib.tele_send_matrix(self._h, b"setLaserLines", m,
                                   m.shape[0], m.shape[1], 0, 0)

    def set_cov_ellipse(self, ellipse, idx):
        m = np.ascontiguousarray(ellipse, np.float32)
        self._lib.tele_send_matrix(self._h, b"setCovEllipse", m,
                                   m.shape[0], m.shape[1], int(idx), 1)

    def _doubles(self, tag, *vals):
        v = np.asarray(vals, np.float64)
        self._lib.tele_send_doubles(self._h, tag, v, len(v))

    def add_true_position(self, x, y):
        self._doubles(b"addTruePosition", x, y)

    def add_estimated_position(self, x, y):
        self._doubles(b"addEstimatedPosition", x, y)

    def set_car_size(self, s, car_id=0):
        self._lib.tele_send_car_size(self._h, float(s), int(car_id))

    def set_car_true_position(self, x, y, t):
        self._doubles(b"setCarTruePosition", x, y, t)

    def set_car_estimated_position(self, x, y, t):
        self._doubles(b"setCarEstimatedPosition", x, y, t)

    def set_plot_range(self, xmin, xmax, ymin, ymax):
        self._doubles(b"setPlotRange", xmin, xmax, ymin, ymax)

    def clear(self):
        self._lib.tele_send_bare(self._h, b"clear")

    def set_simulation_name(self, name):
        self._lib.tele_send_string(self._h, b"setSimulationName",
                                   name.encode())

    def set_current_iteration(self, iteration):
        pass  # disabled in the reference (NetworkPlot.cpp:176-186)

    def cov_ellipse_add(self, n):
        self._lib.tele_send_u32_msg(self._h, b"covEllipseAdd", int(n))

    def plot(self):
        self._lib.tele_send_bare(self._h, b"plot")

    def end_plot(self):
        self._lib.tele_send_bare(self._h, b"endPlot")

    def loop_time(self, microseconds):
        self._lib.tele_send_u32_msg(self._h, b"loopTime",
                                    int(microseconds))

    def close(self):
        if self._h:
            self._lib.tele_close(self._h)
            self._h = None


def load_map_native(path: str, capacity: int = 65536):
    """Native map loader; returns (landmarks [N,2], waypoints [W,2]) as
    float32 arrays, matching slam_tpu_torch.maps.read_map_file."""
    lib = _load()
    if lib is None:
        raise OSError("libslam_native.so unavailable")
    lm = np.zeros((capacity, 2), np.float64)
    wp = np.zeros((capacity, 2), np.float64)
    n_lm = ctypes.c_int(0)
    n_wp = ctypes.c_int(0)
    rc = lib.load_map_file(path.encode(), lm, capacity,
                           ctypes.byref(n_lm), wp, capacity,
                           ctypes.byref(n_wp))
    if rc != 0:
        raise ValueError(f"native map load failed ({rc}): {path}")
    return (lm[:n_lm.value].astype(np.float32),
            wp[:n_wp.value].astype(np.float32))
