"""The kernel gate: each of the twelve CUDA kernels against its plain
PyTorch twin, once, on seeded inputs at the shapes the bench lines give
it (``slam_tpu_torch.bench`` runs ``run`` before it times anything).

    from slam_tpu_torch.ops.kernels import selfcheck
    selfcheck.run("cuda")      # raises on the first mismatch

What each kernel is held to (as ``chip_smoke.py`` phase 3 holds it):

- G1, G2, K6, K6b, F2 and S1 bit-equal to their twins (the gathers
  copy; the predicts and the simulator's ticks keep the twins' operation
  order);
- K5 bit-equal to G2's gather followed by K4 with the empty rows zeroed
  (the same operation order), and within TOL of its twin;
- K3 at the JAX package's golden tolerances of the refinement (xv rtol
  1e-4, atol 1e-5; Pv rtol 1e-3, atol 1e-6): its chain over K
  observations compounds rounding;
- K1, K2 and K4 within TOL, rtol 1e-5 and atol 1e-5: they sum over k in
  another order than the twins, and the device's libm rounds sin, cos
  and log differently from torch's;
- E1 against its twin run in float64: its error on each output at most
  twice the eager float32 code's (the twin on float32), on both arms of
  the heading; the eager code's products go to cuBLAS, which may fuse
  multiply-adds, so no operation order is the kernel's;
- headings (and K1's bearings) compared wrapped: one ulp at +-pi flips a
  wrapped value by 2 pi.

The input builders here (``update_inputs``, ``predict_inputs``,
``gathered_planes``, ``k5_bounds``) are also the ones ``chip_smoke.py``
uses for its timed checks at larger shapes.

On a CPU tensor every wrapper runs its twin, so the gate would compare
each twin with itself: ``run`` refuses a CPU device. ``check_all`` takes
the shapes as arguments; the CPU tests drive it at small ones to hold
the gate's own code.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from slam_tpu_torch.config import SlamConfig
from slam_tpu_torch.geometry import wrap_angle
from slam_tpu_torch.maps import SlamMap, synthetic_map
from slam_tpu_torch.models.ekf import full_f32, noise_matrices
from slam_tpu_torch.models.fastslam2 import FastSlam2
from slam_tpu_torch.models.particles import init_particles
from slam_tpu_torch.models.rbpf import associate_known, new_slots
from slam_tpu_torch.ops import planes as pk
from slam_tpu_torch.ops import resampling as rs
from slam_tpu_torch.ops.kernels import gather as kg
from slam_tpu_torch.ops.kernels import kernels as kk
from slam_tpu_torch.ops.kernels import launch_counts
from slam_tpu_torch.ops.kernels import predict as kp
from slam_tpu_torch.ops.kernels import vehicle as kv
from slam_tpu_torch.parallel import ekf as pe
from slam_tpu_torch.sim.simulator import Simulator

TOL = dict(rtol=1e-5, atol=1e-5)
TOL_REFINE_XV = dict(rtol=1e-4, atol=1e-5)
TOL_REFINE_PV = dict(rtol=1e-3, atol=1e-6)
R = [[0.01, 0.0], [0.0, 0.0003]]
Q = [[0.09, 0.0], [0.0, 0.0025]]
# K5's tile of output columns, as in csrc/resample_update.cu (kTile).
K5_TILE = kk.K5_TILE
T_PREDICT = 8
# S1's drive: supersteps of T_PREDICT ticks on the bench's webmap world.
SIM_SUPERSTEPS = 64
# E1 at ekf10k's shapes: 10,000 slots, 16 deferred heading columns.
EKF10K = dict(L=10_000, D=16)
# E1's error on each output against the float64 twin, over the eager
# float32 code's.
E1_ERR_RATIO = 2.0

# The shapes the bench lines give the kernels: the fallback world's 9
# observations and 40 slots (35 landmarks) at P = 100 (fastslam1_webmap,
# fastslam2_webmap: K2, G1) and at P = 2^20 (fastslam1_1m, fastslam2_1m:
# K4, K5, K6, K6b, K3, G2), and config #5's 96 observations and 192
# slots at P = 2^20 (config5_composed: K4, K5). K1 lies on no path; it
# is checked at the webmap's K. K1 and F2 run at P_K1 = 2^17, the
# FastSLAM 2 cell's count.
WEBMAP = dict(K=9, L=40, n_map=35, live=20, n_match=5, n_new=3)
CONFIG5 = dict(K=96, L=192, n_map=400, live=150, n_match=70, n_new=20)
P_SMALL, P_LARGE, P_K1 = 100, 2 ** 20, 2 ** 17


def check(cond, msg: str) -> None:
    """Fail; unlike ``assert``, kept under ``python -O``."""
    if not cond:
        raise AssertionError(msg)


def max_abs_err(got, want) -> float:
    return max(float((g.double() - w.double()).abs().max())
               for g, w in zip(got, want))


def compare_poses(got, want, tol) -> float:
    """assert_close on x, y and on the wrapped heading difference; the
    largest absolute difference."""
    torch.testing.assert_close(got[:2], want[:2], **tol)
    dth = wrap_angle(got[2] - want[2])
    torch.testing.assert_close(dth, torch.zeros_like(dth), **tol)
    return max_abs_err([got[:2], dth], [want[:2], torch.zeros_like(dth)])


def update_inputs(dev, rng, g, P, L, K, *, n_map, live, n_match, n_new,
                  twice=False, past_capacity=False):
    """A particle state and an observation batch for K2, K4 and K5 at K
    observations, L slots, P particles: ``live`` landmarks mapped,
    ``n_match`` of them observed, ``n_new`` new ones, the rest masked
    observations of live landmarks. ``twice``: the first landmark is
    observed twice, so two k match one slot. ``past_capacity``: the new
    observations whose slots lie past the L slots stay flagged in ``ok``,
    for the kernel to drop. Returns (state, (z, slot, matched, slot_new,
    ok))."""
    check(n_match + n_new <= K and live <= L and live + n_new <= n_map
          and (past_capacity or live + n_new <= L),
          "update input: inconsistent sizes")
    f32 = dict(dtype=torch.float32, device=dev)

    def t(a, dtype=torch.float32):
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

    state = init_particles(P, L, n_map, device=dev)
    truth = rng.uniform(-25.0, 25.0, size=(n_map, 2))
    table = np.full(n_map, -1, np.int32)
    table[:live] = rng.permutation(live)
    lm = torch.zeros((2, L, P), **f32)
    lm[:, table[:live]] = t(truth[:live].T[:, :, None])
    lm += 0.2 * torch.randn((2, L, P), generator=g, **f32)
    state.lm.copy_(lm)
    del lm
    state.lm_P[0, :live] = 0.05
    state.lm_P[1, :live] = 0.01
    state.lm_P[2, :live] = 0.04
    state.xv.copy_(0.1 * torch.randn((3, P), generator=g, **f32))
    state = state._replace(n=t(live, torch.int32),
                           da_table=t(table, torch.int32))
    seen = rng.choice(live, n_match, replace=False)
    if twice:
        seen[1] = seen[0]
    ids_np = np.concatenate([seen, np.arange(live, live + n_new),
                             rng.choice(max(live, 1), K - n_match - n_new)]
                            ).astype(np.int32)
    d = truth[ids_np]
    z = t(np.column_stack([np.hypot(d[:, 0], d[:, 1]),
                           np.arctan2(d[:, 1], d[:, 0])]))
    ids = t(ids_np, torch.int32)
    zmask = t(np.arange(K) < n_match + n_new, torch.bool)
    assoc, is_new = associate_known(state, ids, zmask)
    matched = assoc >= 0
    slot = torch.where(matched, assoc, 0).to(torch.int32)
    slot_new, ok = new_slots(state, is_new)
    if past_capacity:
        ok = is_new
    check(int(matched.sum()) == n_match and int(ok.sum()) == n_new,
          f"update input: expected {n_match} matched and {n_new} new "
          "observations")
    return state, (z, slot, matched, slot_new, ok)


def k5_bounds(dev, rng, g, P, kind):
    """Offspring bounds S [P] for a K5 check: a fired stratified
    resample of random weights, or a chosen ancestor vector."""
    if kind == "fired":
        logw = torch.randn(P, generator=g, device=dev)
        return rs.offspring_bounds(
            rs.cumulative_weights(rs.normalize_log_weights(logw)), P,
            rs.uniform_from_generator(P, g, dev))
    anc = np.arange(P)
    tile = K5_TILE
    if kind == "one ancestor":
        anc[:] = P // 3 + 1
    elif kind == "identity but one tile":
        j0 = 5 * tile
        anc[j0:j0 + tile] = np.sort(rng.integers(j0, j0 + tile, tile))
    elif kind == "wide run":     # tile 0 from every 8th of 8 tiles' columns
        anc[:tile] = 8 * np.arange(tile)
        anc[tile:] = np.sort(rng.integers(8 * tile, P, P - tile))
    else:
        raise ValueError(kind)
    S = np.searchsorted(anc, np.arange(P), side="right")
    return torch.tensor(S, dtype=torch.int32, device=dev)


def predict_inputs(dev, g, P, T, fs2: bool):
    """Poses xv [3, P] (and, ``fs2``, pose covariances Pv [6, P]),
    controls [T, 2] and a key for K6 or K6b."""
    f32 = dict(dtype=torch.float32, device=dev)
    state = [torch.randn((3, P), generator=g, **f32)]
    if fs2:
        Pv = torch.zeros((6, P), **f32)
        Pv[0], Pv[3], Pv[5] = 0.02, 0.02, 0.01
        state.append(Pv)
    ctl = torch.stack([3.0 + 0.3 * torch.randn(T, generator=g, **f32),
                       0.1 * torch.randn(T, generator=g, **f32)], dim=1)
    seed = torch.randint(-2 ** 31, 2 ** 31, (2,), dtype=torch.int32,
                         generator=g, device=dev)
    return state, ctl, seed


def gathered_planes(dev, rng, g, P, K):
    """xv [3, P] near the origin and landmark planes [K, P] gathered for
    K observations at 3 to 25 m, with their (range, bearing) z [K, 2]."""
    f32 = dict(dtype=torch.float32, device=dev)
    xv = torch.randn((3, P), generator=g, **f32) * torch.tensor(
        [[0.3], [0.3], [0.05]], **f32)
    rngk = rng.uniform(3.0, 25.0, K)
    brg = rng.uniform(-1.4, 1.4, K)
    lmx = (torch.tensor(rngk * np.cos(brg), **f32)[:, None]
           + 0.3 * torch.randn((K, P), generator=g, **f32))
    lmy = (torch.tensor(rngk * np.sin(brg), **f32)[:, None]
           + 0.3 * torch.randn((K, P), generator=g, **f32))
    A = 0.2 * torch.randn((K, P), generator=g, **f32)
    planes = [lmx, lmy, A * A + 0.02, 0.3 * A * A, A * A + 0.03]
    z = torch.tensor(np.column_stack([rngk + rng.normal(size=K) * 0.1,
                                      brg + rng.normal(size=K) * 0.017]),
                     **f32)
    return xv, planes, z


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _bit_equal(name, got, want) -> float:
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          f"{name}: not bit-equal to its twin (max abs err "
          f"{max_abs_err(got, want):.3g})")
    return 0.0


def _close(name, got, want, tol) -> float:
    check(all(bool(torch.isfinite(a).all()) for a in got),
          f"{name}: non-finite output")
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **tol, msg=lambda m: f"{name}: {m}")
    return max_abs_err(got, want)


def _update(dev, rng, g, name, P, world) -> dict:
    """K2 (``name`` "K2") or K4 on one state and batch against the twin,
    each on its own copy of the weights and planes."""
    w = dict(world)
    L, K = w.pop("L"), w.pop("K")
    state, batch = update_inputs(dev, rng, g, P, L, K, **w)
    kernel, plain = ((kk.observe, kk.observe_plain) if name == "K2"
                     else (kk.fused_update, kk.fused_update_plain))

    def fresh():
        return (state.xv, state.logw.clone(), state.lm.clone(),
                state.lm_P.clone(), *batch, R)
    a_k, a_p = fresh(), fresh()
    kernel(*a_k)
    plain(*a_p)
    _sync(dev)
    return dict(shape=f"K={K} L={L} P={P}", held="TOL",
                max_abs_err=_close(name, a_k[1:4], a_p[1:4], TOL))


def k5_composed(state, batch, S, logw):
    """K5's function from the other kernels, in its operation order: G2's
    gather by S, K4 in place on logw and the gathered planes, then the
    empty rows zeroed (``kernels.zero_empty_rows``). Returns (lm, lm_P)."""
    _, L, P = state.lm.shape
    lm_g, lmP_g = kg.bounds_gather_multi(
        [state.lm.reshape(2 * L, P), state.lm_P.reshape(3 * L, P)], S)
    lm_g, lmP_g = lm_g.reshape(2, L, P), lmP_g.reshape(3, L, P)
    kk.fused_update(state.xv, logw, lm_g, lmP_g, *batch, R)
    kk.zero_empty_rows(lm_g, lmP_g, state.n, *batch[1:])
    return lm_g, lmP_g


def _resample_update(dev, rng, g, P, world) -> dict:
    """K5 on the bounds of a fired resample: bit-equal to G2 + K4 with the
    empty rows zeroed, within TOL of its twin."""
    w = dict(world)
    L, K = w.pop("L"), w.pop("K")
    state, batch = update_inputs(dev, rng, g, P, L, K, **w)
    logw = torch.randn(P, generator=g, device=dev)
    S = k5_bounds(dev, rng, g, P, "fired")

    def args(lw):
        return (state.xv, lw, state.lm, state.lm_P, S, *batch, R, state.n)
    lw = [logw.clone() for _ in range(3)]
    got = (lw[0], *kk.resample_update(*args(lw[0])))
    composed = (lw[1], *k5_composed(state, batch, S, lw[1]))
    want = (lw[2], *kk.resample_update_plain(*args(lw[2])))
    _sync(dev)
    check(all(torch.equal(a, b) for a, b in zip(got, composed)),
          f"K5 (K={K} L={L} P={P}): not bit-equal to G2 + K4")
    return dict(shape=f"K={K} L={L} P={P}", held="bit-equal to G2 + K4; TOL",
                max_abs_err=_close("K5", got, want, TOL))


def gather_inputs(dev, g, name, P, L):
    """G1's or G2's inputs over the resample gather's three row sets,
    10 + 5L rows of P columns: (arrays, the ancestors of a stratified
    resample for G1 or its offspring bounds for G2, kernel, twin)."""
    f32 = dict(dtype=torch.float32, device=dev)
    arrays = [torch.randn((c, P), generator=g, **f32) * 37
              for c in (10, 2 * L, 3 * L)]
    logw = torch.randn(P, generator=g, **f32) * 2.0
    U = rs.uniform_from_generator(P, g, dev)
    if name == "G1":
        return (arrays, rs.stratified_indices(logw, U),
                kg.sorted_gather_multi, kg.sorted_gather_multi_plain)
    sel = rs.offspring_bounds(
        rs.cumulative_weights(rs.normalize_log_weights(logw)), P, U)
    return arrays, sel, kg.bounds_gather_multi, kg.bounds_gather_multi_plain


def _gather(dev, g, name, P, L) -> dict:
    """G1 (by the stratified ancestors) or G2 (by the offspring bounds)
    over the resample gather's 10 + 5L rows."""
    arrays, sel, kernel, plain = gather_inputs(dev, g, name, P, L)
    got, want = kernel(arrays, sel), plain(arrays, sel)
    _sync(dev)
    return dict(shape=f"rows={10 + 5 * L} P={P}", held="bit-equal",
                max_abs_err=_bit_equal(name, got, want))


def _predict(dev, g, name, P, noise: bool) -> dict:
    """K6 (FastSLAM 1, noise on, as its path forces) or K6b (FastSLAM 2,
    noise off, SWITCH_PREDICT_NOISE's default) over T_PREDICT ticks."""
    fs2 = name == "K6b"
    kernel, plain = ((kp.fs2_predict_multi, kp.fs2_predict_multi_plain)
                     if fs2 else
                     (kp.fs1_predict_multi, kp.fs1_predict_multi_plain))
    state, ctl, seed = predict_inputs(dev, g, P, T_PREDICT, fs2)
    got = [a.clone() for a in state]
    want = [a.clone() for a in state]
    kw = dict(wheelbase=4.0, dt=0.025, add_noise=noise)
    kernel(*got, seed, ctl, Q, **kw)
    plain(*want, seed, ctl, Q, **kw)
    _sync(dev)
    check(not torch.equal(got[0], state[0]), f"{name}: the poses did not move")
    return dict(shape=f"T={T_PREDICT} P={P} noise {'on' if noise else 'off'}",
                held="bit-equal", max_abs_err=_bit_equal(name, got, want))


def sim_drive(dev, g, n_ticks):
    """S1's inputs on the bench lines' world (``bench.load_workload``'s
    webmap stand-in, heading unknown), shifted so that the drive starts
    at waypoint 0 and turns toward the next: (simulator, start vehicle,
    standard normals [n_ticks, 2], the tick constants)."""
    world = synthetic_map(35, 17, radius=100.0)
    shift = world.waypoints[0].copy()
    world = SlamMap(landmarks=world.landmarks - shift,
                    waypoints=world.waypoints - shift)
    sim = Simulator(SlamConfig(SWITCH_HEADING_KNOWN=0), world, device=dev)
    noise = torch.randn((n_ticks, 2), generator=g, device=dev)
    return sim, sim.init(seed=3).vehicle, noise, sim.tick_constants()


def check_sim_control(dev, g, n_supersteps) -> dict:
    """S1 superstep by superstep along a drive, each launch against the
    twin from the same vehicle (the kernel's own state carried on):
    every output bit for bit."""
    sim, vehicle, noise, kw = sim_drive(dev, g, n_supersteps * T_PREDICT)
    for t0 in range(0, noise.shape[0], T_PREDICT):
        rows = noise[t0:t0 + T_PREDICT]
        got = kv.control_multi(vehicle, sim.waypoints, rows, **kw)
        want = kv.control_multi_plain(vehicle, sim.waypoints, rows, **kw)
        _sync(dev)
        _bit_equal(f"S1 (tick {t0})", [*got[0], *got[1:]],
                   [*want[0], *want[1:]])
        vehicle = got[0]
    check(int(vehicle.waypoint) > 0, "S1: the drive passed no waypoint")
    return dict(shape=f"T={T_PREDICT} x {n_supersteps} launches, "
                      f"{sim.waypoints.shape[0]} waypoints",
                held="bit-equal", max_abs_err=0.0)


def ekf_predict_case(dev, g, L, D, hk_n, *, heading=2.9, pmm_rows=0):
    """E1's inputs at L slots: a ``parallel.ekf.ShardedEKFState`` with the
    pose ~400 m from the origin (as ekf10k's mapped start) at ``heading``,
    landmarks up to 400 m off, a random pose block and cross rows at the
    scale of a mapped filter's, ``hk_n`` of hk's D columns used, and
    ``pmm_rows`` rows of Pmm (zeros; only a tick that finds hk full reads
    it); then the tick's 0-d (v, g, phi) on ``dev``, Q, the
    configuration's numbers and the shard (one rank, all rows)."""
    f32 = dict(dtype=torch.float32, device=dev)
    L2 = 2 * L
    x = torch.empty(3 + L2, **f32)
    x[:3] = torch.tensor([380.0, -120.0, heading])
    x[3:] = 400.0 * (2.0 * torch.rand(L2, generator=g, **f32) - 1.0)
    B = 0.1 * torch.randn((3, 3), generator=g, **f32)
    P00 = B @ B.T + 1e-3 * torch.eye(3, **f32)
    hk = torch.zeros((L2, D), **f32)
    hk[:, :hk_n] = 0.01 * torch.randn((L2, hk_n), generator=g, **f32)
    state = pe.ShardedEKFState(
        x=x, P00=P00, P0m=0.01 * torch.randn((3, L2), generator=g, **f32),
        Pmm=torch.zeros((pmm_rows, L2), **f32),
        n=torch.tensor(L, dtype=torch.int32, device=dev),
        da_table=torch.arange(L, dtype=torch.int32, device=dev), hk=hk,
        hk_n=hk_n)
    u = torch.randn(3, generator=g, **f32)
    ticks = (3.0 + 0.3 * u[0], 0.2 * u[1],
             torch.remainder(heading + 0.02 * u[2] + torch.pi, 2 * torch.pi)
             - torch.pi)
    cfg = SlamConfig()
    Q = noise_matrices(cfg, dev)[0]
    kw = dict(wheelbase=cfg.WHEELBASE, dt=cfg.DT_CONTROLS,
              sigma_phi=cfg.sigmaT)
    return state, ticks, Q, kw, pe.Shard(row_lo=0, rows=pmm_rows)


def _ekf_outputs(state) -> dict:
    """The outputs of a tick, float64: pose, the map's means, P00, P0m,
    hk and Pmm."""
    return dict(pose=state.x[:3].double(), map=state.x[3:].double(),
                P00=state.P00.double(), P0m=state.P0m.double(),
                hk=state.hk.double(), Pmm=state.Pmm.double())


def ekf_predict_errors(state, ticks, Q, kw, heading_known, shard) -> dict:
    """One tick from ``state`` by E1 (``parallel.ekf._predict_local``: the
    twin on the CPU), by the eager float32 code (``_predict_local_plain``)
    and by the twin in float64: per output, the largest error of E1 and
    of the eager code against the float64 twin (headings wrapped), and
    E1's largest distance to the eager code. Each run gets its own copy
    of the state (hk and Pmm are written in place)."""
    def fresh(dtype):
        return state._replace(**{f: getattr(state, f).to(dtype, copy=True)
                                 for f in ("x", "P00", "P0m", "Pmm", "hk")})
    args = (kw["wheelbase"], kw["dt"])
    with full_f32():
        got = pe._predict_local(fresh(torch.float32), *ticks[:2], Q, *args,
                                ticks[2], kw["sigma_phi"], heading_known,
                                shard)
        eager = pe._predict_local_plain(
            fresh(torch.float32), *ticks[:2], Q, *args, ticks[2],
            kw["sigma_phi"], heading_known, shard)
        t64 = [t.double() for t in ticks]
        want = pe._predict_local_plain(
            fresh(torch.float64), *t64[:2], Q.double(), *args, t64[2],
            kw["sigma_phi"], heading_known, shard)
    check(got.hk_n == eager.hk_n == want.hk_n, "E1: hk_n differs from "
          f"the twin's: {got.hk_n}, {eager.hk_n}, {want.hk_n}")
    out = {}
    runs = [_ekf_outputs(s) for s in (got, eager, want)]
    for name in runs[0]:
        a, b, w = (r[name] for r in runs)
        if a.numel() == 0:
            continue
        if name == "pose":
            a, b, w = [torch.cat([t[:2], wrap_angle(t[2:] - w[2:])])
                       for t in (a, b, w)]
        check(bool(torch.isfinite(a).all()), f"E1: non-finite {name}")
        out[name] = dict(e1=float((a - w).abs().max()),
                         eager=float((b - w).abs().max()),
                         diff=float((a - b).abs().max()))
    return out


def check_ekf_predict(dev, g, L, D) -> dict:
    """E1 at L slots on both arms of the heading (observed: 15 of the 16
    columns used, so the tick writes the last; not observed: none used)
    against the float64 twin: each output's error at most E1_ERR_RATIO
    times the eager float32 code's."""
    err, cases = 0.0, {}
    for heading_known, hk_n in ((True, D - 1), (False, 0)):
        state, ticks, Q, kw, shard = ekf_predict_case(dev, g, L, D, hk_n)
        gaps = ekf_predict_errors(state, ticks, Q, kw, heading_known, shard)
        _sync(dev)
        for name, e in gaps.items():
            check(e["e1"] <= E1_ERR_RATIO * e["eager"],
                  f"E1 ({'heading' if heading_known else 'no heading'}) "
                  f"{name}: error {e['e1']:.3g} against the float64 twin, "
                  f"over {E1_ERR_RATIO} x the eager code's {e['eager']:.3g}")
            err = max(err, e["diff"])
        cases["heading" if heading_known else "no heading"] = gaps
    return dict(shape=f"L={L}, D={D}", held="2x the eager f32 error",
                max_abs_err=err, errors=cases)


def fs2_tick_case(dev, g, P, *, heading_known=True, noise=False,
                  heading=None, pv_zero=False, wheelbase=None):
    """F2's inputs at P particles: (estimator, state, (vn, gn, phi)). The
    estimator is ``FastSlam2`` at the configuration's defaults with the
    two switches (and the wheelbase) given; the state's poses lie ~1 m
    around (20, -5), their headings uniform over [-pi, pi) or all at
    ``heading``, their pose covariances those of a filter some ticks
    after an observation (zero with ``pv_zero``, as right after one);
    the tick's speed, steer and true heading are 0-d on ``dev`` (with a
    ``heading``, the true heading 0.8 rad from it away from 0: across
    +-pi from a heading near it)."""
    f32 = dict(dtype=torch.float32, device=dev)
    cfg = SlamConfig(SWITCH_HEADING_KNOWN=int(heading_known),
                     SWITCH_PREDICT_NOISE=int(noise))
    if wheelbase is not None:
        cfg = cfg.replace(WHEELBASE=wheelbase)
    est = FastSlam2(cfg, 8, device=dev)
    state = est.init(P)
    xy = torch.tensor([[20.0], [-5.0]], **f32)
    th = (torch.full((1, P), heading, **f32) if heading is not None else
          torch.pi * (2.0 * torch.rand((1, P), generator=g, **f32) - 1.0))
    state.xv.copy_(torch.cat(
        [xy + torch.randn((2, P), generator=g, **f32), th]))
    if not pv_zero:
        A = 0.1 * torch.randn((3, 3, P), generator=g, **f32)
        S = torch.einsum("ikp,jkp->ijp", A, A)
        S[2, 2] += 1e-4
        state.Pv.copy_(torch.stack([S[0, 0], S[0, 1], S[0, 2], S[1, 1],
                                    S[1, 2], S[2, 2]]))
    u = torch.randn(3, generator=g, **f32)
    phi = (torch.tensor(heading + math.copysign(0.8, heading), **f32)
           if heading is not None else u[2])
    ticks = (2.0 + 0.3 * u[0], 0.3 * u[1], wrap_angle(phi))
    return est, state, ticks


def fs2_tick_pair(est, state, ticks, seed: int):
    """One tick from copies of ``state`` by ``est.predict`` (F2 on the
    card, the twin elsewhere) and by the twin (``est._predict_plain``),
    each drawing its control normals from a generator seeded ``seed`` on
    the state's device: ((xv, Pv) of F2, (xv, Pv) of the twin)."""
    out = []
    for tick in (est.predict, est._predict_plain):
        st = state._replace(xv=state.xv.clone(), Pv=state.Pv.clone())
        gen = torch.Generator(device=state.xv.device).manual_seed(seed)
        st = tick(st, gen, *ticks)
        out.append((st.xv, st.Pv))
    return out


def _fs2_tick(dev, g, P) -> dict:
    """F2 on the FastSLAM 2 cell's path (the heading known, the noise off)
    against its twin, bit for bit."""
    est, state, ticks = fs2_tick_case(dev, g, P)
    got, want = fs2_tick_pair(est, state, ticks, seed=P)
    _sync(dev)
    check(not torch.equal(got[0], state.xv), "F2: the poses did not move")
    return dict(shape=f"P={P} heading known, noise off", held="bit-equal",
                max_abs_err=_bit_equal("F2", got, want))


def refine_inputs(dev, rng, g, P, K):
    """K3's arguments at K observations, P particles: every fifth
    observation unmatched, its planes those of a landmark at the
    particle's own position (zero distance), which the kernel must pass
    by untouched; Pv at the scale a superstep of predict accumulates."""
    xv, planes, z = gathered_planes(dev, rng, g, P, K)
    matched = torch.arange(K, device=dev) % 5 != 4
    planes[0][~matched] = xv[0]
    planes[1][~matched] = xv[1]
    B = 0.01 * torch.randn((3, 3, P), generator=g, device=dev)
    M = torch.einsum("ikp,jkp->ijp", B, B) + 1e-5 * torch.eye(
        3, device=dev)[:, :, None]
    Pv = torch.stack([M[0, 0], M[0, 1], M[0, 2], M[1, 1], M[1, 2],
                      M[2, 2]]).contiguous()
    return (xv, Pv, *planes, z, matched, R)


def compare_refine(got, want) -> float:
    """K3's outputs against its twin's at the golden tolerances, the
    heading wrapped; the largest error."""
    check(bool(torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all()),
          "K3: non-finite output")
    err = compare_poses(got[0], want[0], TOL_REFINE_XV)
    torch.testing.assert_close(got[1], want[1], **TOL_REFINE_PV)
    return max(err, max_abs_err([got[1]], [want[1]]))


def _refine(dev, rng, g, P, K) -> dict:
    args = refine_inputs(dev, rng, g, P, K)
    got, want = kk.fs2_refine(*args), kk.fs2_refine_plain(*args)
    _sync(dev)
    return dict(shape=f"K={K} P={P}", held="golden",
                max_abs_err=compare_refine(got, want))


def _jacobians(dev, rng, g, P, K) -> dict:
    """K1 against ``ops.planes.jacobians_planes``, bearings wrapped."""
    xv, planes, _ = gathered_planes(dev, rng, g, P, K)
    got = kk.jacobians(xv, *planes, R)
    want = pk.jacobians_planes(xv[0:1], xv[1:2], xv[2:3], *planes,
                               *pk.sym2_host(R))
    _sync(dev)
    err = 0.0
    for name, a, b in zip(got._fields, got, want):
        b = b.expand_as(a)
        if name == "zb":
            a, b = wrap_angle(a - b), torch.zeros_like(a)
        err = max(err, _close(f"K1 {name}", [a], [b], TOL))
    return dict(shape=f"K={K} P={P}", held="TOL", max_abs_err=err)


def check_all(device, p_small: int, p_large: int, p_k1: int,
              webmap: dict, config5: dict) -> dict:
    """Every kernel once against its twin at these shapes, in the order
    of the bench lines; raises on the first mismatch, and on a card when
    a wrapper launched no kernel. {check: its shape, what it was held
    to, the largest error}."""
    dev = torch.device(device)
    rng = np.random.default_rng(0)
    g = torch.Generator(device=dev).manual_seed(0)
    before = launch_counts()
    out = {"K2": _update(dev, rng, g, "K2", p_small, webmap),
           "G1": _gather(dev, g, "G1", p_small, webmap["L"]),
           "K6": _predict(dev, g, "K6", p_large, noise=True),
           "K4": _update(dev, rng, g, "K4", p_large, webmap),
           "K5": _resample_update(dev, rng, g, p_large, webmap),
           "G2": _gather(dev, g, "G2", p_large, webmap["L"]),
           "K6b": _predict(dev, g, "K6b", p_large, noise=False),
           "K3": _refine(dev, rng, g, p_large, webmap["K"]),
           "K1": _jacobians(dev, rng, g, p_k1, webmap["K"]),
           "K4 config5": _update(dev, rng, g, "K4", p_large, config5),
           "K5 config5": _resample_update(dev, rng, g, p_large, config5),
           "S1": check_sim_control(dev, g, SIM_SUPERSTEPS),
           "E1": check_ekf_predict(dev, g, **EKF10K),
           "F2": _fs2_tick(dev, g, p_k1)}
    if dev.type == "cuda":
        after = launch_counts()
        idle = [k for k in after if after[k] == before[k]]
        check(not idle, f"kernel gate: {idle} never launched")
        torch.cuda.empty_cache()
    return out


def run(device) -> dict:
    """The gate at the bench lines' shapes, on a CUDA device (a CPU
    device raises ``ValueError``: there every wrapper is its own twin)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"the kernel gate runs on a CUDA device, not on "
                         f"{dev}: on the CPU every wrapper runs its twin")
    return check_all(dev, P_SMALL, P_LARGE, P_K1, WEBMAP, CONFIG5)
