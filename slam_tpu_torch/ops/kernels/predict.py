"""K6 and K6b: all control ticks of a superstep's FastSLAM 1 predict
(K6), or FastSLAM 2 predict with its pose covariance (K6b), in one
launch, with the random draws made inside the kernel (counterparts:
slam_tpu.ops.pallas.kernels.fs1_predict_multi_tpu and
fs2_predict_multi_tpu). F2: one FastSLAM 2 predict tick with the
heading update in one launch, from normals the caller drew
(``fs2_predict_tick``; no TPU kernel stands behind it).

The TPU kernels draw from the TPU's hardware PRNG. The port draws from
Philox4x32-10 (``csrc/philox.cuh``): particle p at tick t takes words 0
and 1 of the block at counter (p, t, 0, 0) under the key given by the
two seed words. ``philox4x32`` below is the same generator in torch, so
the plain twins reproduce the kernels' stream draw for draw.

A CPU tensor goes to the twin, a CUDA tensor to ``csrc/predict.cu``;
nothing falls back. Each wrapper counts its launches in
``<wrapper>.launches``. The kernels keep the twins' operation order and
are bit-equal to them on the card; the two places where they compute a
value another way (``sincosf``, the heading wrap without ``fmodf``) are
held to the twins' way on every float32 by ``fast_math_sweep``.
"""

from __future__ import annotations

import functools
import math

import torch

from slam_tpu_torch.ops import planes as pk
from slam_tpu_torch.ops.kernels import build
from slam_tpu_torch.ops.kernels.kernels import _check_cuda, _require

PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_MASK32 = 0xFFFFFFFF
_INV24 = 2.0 ** -24
_TWO_PI = 2.0 * math.pi


def _mulhilo(a, m: int):
    """(hi, lo) 32-bit words of a * m, for int64 ``a`` in [0, 2^32) and
    a constant m < 2^32. The full product can pass 2^63, so m is split
    into 16-bit limbs: a * m = (a * m_hi) 2^16 + a * m_lo, where each
    partial product stays below 2^48."""
    t = a * (m & 0xFFFF)
    u = a * (m >> 16)
    s = t + ((u & 0xFFFF) << 16)          # < 2^49: the low 48 bits
    return (u >> 16) + (s >> 32), s & _MASK32


def philox4x32(counter, key):
    """Philox4x32-10: the four output words for a counter of four words
    and a key of two, each an int or an int64 tensor holding values in
    [0, 2^32) (tensors broadcast). Returns four int64 tensors (or ints)."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(10):
        if r:
            k0 = (k0 + PHILOX_W[0]) & _MASK32
            k1 = (k1 + PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(c0, PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def seed_key(seed: torch.Tensor):
    """The two int32 seed words as the unsigned key words (0-d int64
    tensors, on the seed's device: no host read)."""
    k = seed.to(torch.int64) & _MASK32
    return k[0], k[1]


def normal_pair(n: int, t: int, seed: torch.Tensor):
    """Two standard normal planes [n] for tick t: Box-Muller on words 0
    and 1 of Philox at counters (p, t, 0, 0), as the TPU kernel's
    ``_sample_vg`` shapes its bits: u1 in (0, 1], never 0 for the log,
    u2 in [0, 1)."""
    p = torch.arange(n, dtype=torch.int64, device=seed.device)
    b0, b1, _, _ = philox4x32((p, t, 0, 0), seed_key(seed))
    u1 = ((b0 >> 8) + 1).to(torch.float32) * _INV24
    u2 = (b1 >> 8).to(torch.float32) * _INV24
    r = torch.sqrt(-2.0 * torch.log(u1))
    return r * torch.cos(_TWO_PI * u2), r * torch.sin(_TWO_PI * u2)


def _tick_controls(controls, t: int, P: int, seed, factor, add_noise):
    """(V [P], G [P]) at tick t: the nominal controls of row t, or with
    ``add_noise`` their sample ~ N((vn, gn), L L') from the Philox
    stream, L = chol(Q) given as ``factor`` (l00, l10, l11)."""
    vn, gn = controls[t, 0], controls[t, 1]
    if not add_noise:
        return vn.expand(P), gn.expand(P)
    l00, l10, l11 = factor
    e0, e1 = normal_pair(P, t, seed)
    return vn + l00 * e0, gn + l10 * e0 + l11 * e1


def fs1_predict_multi_plain(xv, seed, controls, Q, *, wheelbase: float,
                            dt: float, add_noise: bool = True):
    """Plain twin of K6, in place on xv [3, P] like the kernel: for each
    of the T rows (vn, gn) of ``controls`` [T, 2], sample V, G ~ N((vn,
    gn), Q) from the Philox stream (or take them as given when
    ``add_noise`` is False) and take one bicycle step. ``seed``: int32
    [2], the key."""
    # Imported here: models.rbpf imports this package (through
    # models.particles), so a module-level import would be circular.
    from slam_tpu_torch.models.rbpf import (
        control_noise_factor,
        propagate_poses,
    )

    factor = control_noise_factor(Q)
    P = xv.shape[1]
    cur = xv
    for t in range(controls.shape[0]):
        V, G = _tick_controls(controls, t, P, seed, factor, add_noise)
        cur = propagate_poses(cur, V, G, wheelbase, dt)
    xv.copy_(cur)
    return xv


def fs1_predict_multi(xv, seed, controls, Q, *, wheelbase: float,
                      dt: float, add_noise: bool = True):
    """K6 (replaces kernels.py:fs1_predict_multi_tpu): T ticks of the
    noisy FastSLAM 1 motion sample on xv [3, P], in place. ``seed`` is
    an int32 [2] tensor on xv's device, read by the kernel through a
    pointer (no host sync); ``controls`` [T, 2] (vn, gn) per tick;
    ``Q`` a host 2x2 control covariance."""
    if not xv.is_cuda:
        return fs1_predict_multi_plain(xv, seed, controls, Q,
                                       wheelbase=wheelbase, dt=dt,
                                       add_noise=add_noise)
    from slam_tpu_torch.models.rbpf import control_noise_factor

    _check_cuda(dict(xv=xv, seed=seed, controls=controls),
                dict(seed=torch.int32))
    P = xv.shape[1]
    T = controls.shape[0]
    _require(xv.shape == (3, P) and seed.shape == (2,)
             and controls.shape == (T, 2),
             "fs1_predict_multi: shapes do not match xv [3, P], "
             "seed [2], controls [T, 2]")
    lib = build.load_library()
    err = lib.slam_fs1_predict_multi(
        xv.data_ptr(), seed.data_ptr(), controls.data_ptr(),
        *control_noise_factor(Q), float(wheelbase), float(dt),
        int(add_noise), T, P,
        torch.cuda.current_stream(xv.device).cuda_stream)
    build.check(err, "slam_fs1_predict_multi")
    fs1_predict_multi.launches += 1
    return xv


fs1_predict_multi.launches = 0


def fs2_predict_multi_plain(xv, Pv, seed, controls, Q, *, wheelbase: float,
                            dt: float, add_noise: bool = True):
    """Plain twin of K6b, in place on xv [3, P] and Pv [6, P] like the
    kernel: per tick, the controls of ``fs1_predict_multi_plain`` (the
    same Philox draws), then the FastSLAM 2 pose and covariance step
    (``models.fastslam2.propagate_pose_covariance``)."""
    # Imported here, as in fs1_predict_multi_plain.
    from slam_tpu_torch.models.fastslam2 import propagate_pose_covariance
    from slam_tpu_torch.models.rbpf import control_noise_factor

    factor = control_noise_factor(Q)
    P = xv.shape[1]
    cur_xv, cur_Pv = xv, Pv
    for t in range(controls.shape[0]):
        V, G = _tick_controls(controls, t, P, seed, factor, add_noise)
        cur_xv, cur_Pv = propagate_pose_covariance(cur_xv, cur_Pv, V, G, Q,
                                                   wheelbase, dt)
    xv.copy_(cur_xv)
    Pv.copy_(cur_Pv)
    return xv, Pv


def fs2_predict_multi(xv, Pv, seed, controls, Q, *, wheelbase: float,
                      dt: float, add_noise: bool = True):
    """K6b (replaces kernels.py:fs2_predict_multi_tpu): T ticks of the
    FastSLAM 2 predict on xv [3, P] and Pv [6, P], in place. Arguments
    as ``fs1_predict_multi``; the kernel takes (chol Q, Q) as (l00, l10,
    l11, q00, q01, q11), as the TPU kernel's q_row."""
    if not xv.is_cuda:
        return fs2_predict_multi_plain(xv, Pv, seed, controls, Q,
                                       wheelbase=wheelbase, dt=dt,
                                       add_noise=add_noise)
    from slam_tpu_torch.models.rbpf import control_noise_factor

    _check_cuda(dict(xv=xv, Pv=Pv, seed=seed, controls=controls),
                dict(seed=torch.int32))
    P = xv.shape[1]
    T = controls.shape[0]
    _require(xv.shape == (3, P) and Pv.shape == (6, P)
             and seed.shape == (2,) and controls.shape == (T, 2),
             "fs2_predict_multi: shapes do not match xv [3, P], Pv [6, P], "
             "seed [2], controls [T, 2]")
    lib = build.load_library()
    err = lib.slam_fs2_predict_multi(
        xv.data_ptr(), Pv.data_ptr(), seed.data_ptr(), controls.data_ptr(),
        *control_noise_factor(Q), *pk.sym2_host(Q), float(wheelbase),
        float(dt), int(add_noise), T, P,
        torch.cuda.current_stream(xv.device).cuda_stream)
    build.check(err, "slam_fs2_predict_multi")
    fs2_predict_multi.launches += 1
    return xv, Pv


fs2_predict_multi.launches = 0


F2_NAMES = ("xv", "Pv", "eps", "vn", "gn", "phi")


@functools.lru_cache(maxsize=64)
def _check_tick_shapes(shapes: tuple) -> None:
    """Raise unless ``shapes`` (of F2_NAMES, in order) are xv [3, P], Pv
    [6, P], eps [2, P] and 0-d vn, gn and phi. Cached: a set of shapes
    that passed once passes again."""
    xv, Pv, eps, *scalars = shapes
    ok = (len(xv) == 2 and xv[0] == 3 and Pv == (6, xv[1])
          and eps == (2, xv[1]) and all(s == () for s in scalars))
    _require(ok, "fs2_predict_tick: shapes "
             f"{dict(zip(F2_NAMES, map(tuple, shapes)))} do not match xv "
             "[3, P], Pv [6, P], eps [2, P] and 0-d vn, gn and phi")


def fs2_predict_tick(xv, Pv, eps, vn, gn, phi, chol_q, q, *,
                     wheelbase: float, dt: float, r: float,
                     add_noise: bool, heading_known: bool):
    """F2: one FastSLAM 2 predict tick on the card, in place on xv [3, P]
    and Pv [6, P], as ``models.fastslam2.FastSlam2._predict_plain``
    computes it: the controls (vn, gn) + on (l00 e0, l10 e0 + l11 e1)
    from the tick's standard normals eps [2, P], on = 1 with
    ``add_noise`` and 0 without; the pose and covariance step; then with
    ``heading_known`` the heading update against phi, of variance r.
    vn, gn and phi are 0-d float32 tensors (phi read only with the
    heading); ``chol_q`` (l00, l10, l11) of chol(Q) and ``q`` (q00, q01,
    q11) of Q, host floats. The wrapper's host time is most of a tick's
    cost, so it checks per call only what can differ between calls
    (dtypes, contiguity, devices) and the shapes once per set of shapes.
    A CPU tensor is refused: there the twin runs the tick."""
    ts = (xv, Pv, eps, vn, gn, phi)
    if not heading_known:
        ts = ts[:-1]
    for name, t in zip(F2_NAMES, ts):
        if not (isinstance(t, torch.Tensor) and t.dtype == torch.float32
                and t.is_contiguous()):
            raise ValueError(f"fs2_predict_tick: {name} must be a "
                             "contiguous float32 tensor")
    _check_tick_shapes(tuple(t.shape for t in ts) + ((),) * (6 - len(ts)))
    dev = xv.device
    if dev.type != "cuda" or not all(t.device == dev for t in ts):
        raise ValueError(
            "fs2_predict_tick: the tensors lie on "
            f"{[str(t.device) for t in ts]}, not on one CUDA device (off "
            "the card the plain twin, FastSlam2._predict_plain, runs the "
            "tick)")
    err = build.load_library().slam_fs2_predict_tick(
        xv.data_ptr(), Pv.data_ptr(), eps.data_ptr(), vn.data_ptr(),
        gn.data_ptr(), phi.data_ptr() if heading_known else None, *chol_q,
        *q, wheelbase, dt, float(add_noise), r, int(heading_known),
        xv.shape[1], torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "slam_fs2_predict_tick")
    fs2_predict_tick.launches += 1
    return xv, Pv


fs2_predict_tick.launches = 0


def fast_math_sweep(device) -> dict:
    """Holds the two substitutions of ``csrc/predict.cu`` to what they
    replace, on the card, over all 2^32 float32 bit patterns: ``sincosf``
    against ``sinf`` and ``cosf``, and ``planes.cuh:wrap_angle_fast``
    against ``wrap_angle``. Returns the counts of arguments that differ
    (NaN equals NaN) and the least differing bit pattern of each pair,
    ``None`` if there is none. K6 and K6b are bit-equal to their twins
    only while every count is 0."""
    device = torch.device(device)
    _require(device.type == "cuda", "fast_math_sweep runs on a CUDA device")
    none = 2 ** 32
    out = torch.tensor([0, 0, 0, none, none], dtype=torch.int64,
                       device=device)
    lib = build.load_library()
    with torch.cuda.device(device):
        err = lib.slam_predict_fast_math_sweep(
            out.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    build.check(err, "slam_predict_fast_math_sweep")
    sin, cos, wrap, first_trig, first_wrap = out.tolist()
    return dict(sin_mismatches=sin, cos_mismatches=cos,
                wrap_mismatches=wrap,
                first_trig=None if first_trig == none else first_trig,
                first_wrap=None if first_wrap == none else first_wrap)
