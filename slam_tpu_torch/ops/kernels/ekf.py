"""E1: the block EKF's predict tick in one launch (``csrc/ekf_predict.cu``).
No TPU kernel stands behind it: the JAX package leaves this predict to
XLA; the port ran each tick as 97 ATen calls, ~77 of them launches.

The tick is ``parallel.ekf._predict_local_plain``, the plain twin, which
the CPU keeps: the bicycle predict of the pose, P00 and the cross rows
P0m, then, with ``heading_known``, the scalar Joseph update by the IMU
heading, whose landmark term goes into ``hk``'s column ``hk_n``. This
wrapper takes CUDA tensors only (``parallel.ekf._predict_local`` sends the
others to the twin) and launches the kernel, with no host read: v, g and
phi are read from their 0-d tensors on the card. The launches are
counted in ``ekf_predict_tick.launches``.

The wrapper's host time is most of a tick's cost, so it checks per call
only what can differ between calls (dtypes, contiguity, devices, and
``hk_n`` against hk's width) and the shapes once per set of shapes.
"""

from __future__ import annotations

import functools

import torch

from slam_tpu_torch.ops.kernels import build
from slam_tpu_torch.ops.kernels.kernels import _require

F32 = torch.float32
NAMES = ("x", "P00", "P0m", "hk", "Q", "v", "g", "phi")


@functools.lru_cache(maxsize=64)
def _check_shapes(shapes: tuple) -> None:
    """Raise unless ``shapes`` (of NAMES, in order) are x [3 + 2L],
    P00 [3, 3], P0m [3, 2L], hk [2L, D], Q [2, 2] and 0-d v, g and phi.
    Cached: a set of shapes that passed once passes again."""
    x, P00, P0m, hk, Q, *scalars = shapes
    ok = (len(x) == 1 and x[0] >= 3 and (x[0] - 3) % 2 == 0
          and P00 == (3, 3) and P0m == (3, x[0] - 3) and len(hk) == 2
          and hk[0] == x[0] - 3 and Q == (2, 2)
          and all(s == () for s in scalars))
    _require(ok, "ekf_predict_tick: shapes "
             f"{dict(zip(NAMES, map(tuple, shapes)))} do not match x "
             "[3 + 2L], P00 [3, 3], P0m [3, 2L], hk [2L, D], Q [2, 2] and "
             "0-d v, g and phi")


def ekf_predict_tick(x, P00, P0m, hk, hk_n: int, v, g, phi, Q, *,
                     wheelbase: float, dt: float, sigma_phi: float,
                     heading_known: bool):
    """E1: one predict tick of the block EKF on the card, as
    ``parallel.ekf._predict_local_plain`` computes it: x [3 + 2L], P00
    [3, 3] and P0m [3, 2L] of the state, its deferred heading columns hk
    [2L, D] with ``hk_n`` used, the controls v and g and the IMU heading
    phi (0-d; phi read only with ``heading_known``), the control noise Q
    [2, 2]; the configuration's numbers as host floats. Writes the tick's
    heading column into ``hk[:, hk_n]`` when ``hk_n < D``. Returns fresh
    (x, P00, P0m, u): u is None but when the heading is observed and hk
    has no free column, and then the column [2L] that the caller folds
    into Pmm."""
    ts = (x, P00, P0m, hk, Q, v, g, phi)
    if not heading_known:
        ts = ts[:-1]
    for name, t in zip(NAMES, ts):
        if not (isinstance(t, torch.Tensor) and t.dtype == F32
                and t.is_contiguous()):
            raise ValueError(f"ekf_predict_tick: {name} must be a "
                             "contiguous float32 tensor")
    D = hk.shape[-1]
    _require(0 <= hk_n <= D,
             f"ekf_predict_tick: hk_n {hk_n} outside [0, {D}]")
    _check_shapes(tuple(t.shape for t in ts) + ((),) * (8 - len(ts)))
    dev = x.device
    if dev.type != "cuda" or not all(t.device == dev for t in ts):
        raise ValueError(
            "ekf_predict_tick: the tensors lie on "
            f"{[str(t.device) for t in ts]}, not on one CUDA device (on "
            "the CPU the plain twin, parallel.ekf._predict_local_plain, "
            "runs the tick)")
    n2 = P0m.shape[1]
    x_out, P00_out, P0m_out = (torch.empty_like(x), torch.empty_like(P00),
                               torch.empty_like(P0m))
    u = None
    if not heading_known:
        u_ptr, stride = None, 0
    elif hk_n < D:
        u_ptr, stride = hk.data_ptr() + 4 * hk_n, D
    else:
        u = torch.empty(n2, dtype=F32, device=dev)
        u_ptr, stride = u.data_ptr(), 1
    err = build.load_library().slam_ekf_predict(
        x.data_ptr(), P00.data_ptr(), P0m.data_ptr(), Q.data_ptr(),
        v.data_ptr(), g.data_ptr(), phi.data_ptr() if heading_known else None,
        wheelbase, dt, sigma_phi, int(heading_known), n2, x_out.data_ptr(),
        P00_out.data_ptr(), P0m_out.data_ptr(), u_ptr, stride,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "slam_ekf_predict")
    ekf_predict_tick.launches += 1
    return x_out, P00_out, P0m_out, u


ekf_predict_tick.launches = 0
