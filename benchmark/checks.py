"""The numbers that decide ``correct``: what the timed path produced,
judged by the plain reference (``benchmark/reference``).

Filter cells (``filter_numbers``), over the runs of the window and the
supersteps the ``Recorder`` copied:

- ``truth_gap_m``: the largest distance between a run's truth poses and
  the reference's truth trajectory (float64);
- ``obs_noise_z``: how far the observations' normalized residuals
  against the truth stray from N(0, 1), as a z-score over every
  observation of the window (none where nothing is observed);
- ``exact_miss``: observation batches that do not hold the visible
  landmarks, and what should be exact and is not: a run's start (poses
  at the origin, uniform weights, an empty map), a resample's pose rows
  from their ancestors, the gate's decision, the id table, the live
  count;
- ``predict_z``: per copied superstep, how far the particles' motion
  over its ticks strays from the reference's Monte Carlo draw of the
  same motion model from the same poses and controls (z-score of the
  mean and of the variance of each coordinate);
- ``lm_gap``, ``lmcov_gap``, ``weight_gap``: the observation update
  against the reference's from the same state (landmark means in units
  of their standard deviation, covariances relative to their scale,
  weights times P);
- ``resample_gap``: how far a fired resample's offspring counts stray
  beyond the reach of a stratified resample computed in float32, w the
  reference's weights: |count - P w| < 2, and one slot more at each of
  a particle's two bounds, where float32 t = P csum rounds; relative to
  P w (at least 1), 0 when every count is within reach; over every
  ancestor but the last, which takes what the others leave;
- ``pose_gap_m``: the run's pose estimate against the reference's, from
  the state the update returned.

BA (``ba_numbers``): ``ba_cost_gap``, the solver's last cost against
the float64 cost at its answer, and ``ba_cost_excess``, that cost over
the cost the reference's float64 solve reaches under the same budget.

With ``control=True`` each function puts the reference itself, one
precision down, in the program's place (bfloat16 for the filter, which
has no matrix product for TF32 to touch; float32 with TF32 for BA) and
judges that instead.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import ba as rba
from benchmark.reference import fastslam as rfs
from benchmark.reference import sim as rsim

BF16 = torch.bfloat16


def _truth_numbers(runs, cfg, waypoints, control: bool):
    period = round(cfg["DT_OBSERVE"] / cfg["DT_CONTROLS"])
    n_ticks = max(r["true_pose"].shape[0] for r in runs) * period
    ref = rsim.truth_trajectory(cfg, waypoints, n_ticks)[period - 1::period]
    ctrl = (rsim.truth_trajectory(cfg, waypoints, n_ticks, BF16)
            [period - 1::period] if control else None)
    gap = 0.0
    for r in runs:
        tp = ctrl[:len(r["true_pose"]), :3] if control else r["true_pose"]
        d = np.linalg.norm(tp[:, :2] - ref[:len(tp), :2], axis=1)
        gap = max(gap, float(d.max()))
    return gap


def _obs_numbers(runs, cfg, landmarks, max_obs: int, gen, control: bool):
    sr, sb = math.sqrt(cfg["sigmaR"] ** 2), math.sqrt(cfg["sigmaB"] ** 2)
    miss, resid = 0, []
    for r in runs:
        z = r["obs_z"]
        if control:
            z = np.zeros_like(z)
            for t in range(z.shape[0]):
                ids = r["obs_ids"][t][r["obs_mask"][t]]
                if ids.size:
                    h = rsim.range_bearing(landmarks[ids], r["true_pose"][t],
                                           BF16)
                    e = torch.randn((ids.size, 2), generator=gen,
                                    dtype=torch.float64).numpy()
                    z[t, :ids.size] = h + e * (sr, sb)
        m, res = rsim.observation_check(
            landmarks, r["true_pose"], z, r["obs_mask"], r["obs_ids"],
            cfg["MAX_RANGE"], max_obs, sr, sb)
        miss += m
        resid.append(res)
    return miss, rsim.noise_z(np.concatenate(resid))


def _stat_z(a, b) -> float:
    """The larger z-score of the difference of the means and of the
    variances of two samples [n] (variances' errors from the fourth
    moments)."""
    n, m = a.numel(), b.numel()
    va, vb = a.var(), b.var()
    z_mean = (a.mean() - b.mean()).abs() / torch.sqrt(va / n + vb / m)
    ma = ((a - a.mean()) ** 4).mean()
    mb = ((b - b.mean()) ** 4).mean()
    z_var = (va - vb).abs() / torch.sqrt((ma - va ** 2) / n
                                         + (mb - vb ** 2) / m)
    return float(torch.maximum(z_mean, z_var))


def _predict_z(rec, cfg, gen, control: bool) -> float:
    """The motion of one superstep's ticks against the reference's draw:
    the largest z-score over x, y and theta."""
    Q = ((cfg["sigmaV"] ** 2, 0.0), (0.0, cfg["sigmaG"] ** 2))
    kw = dict(Q=Q, wheelbase=cfg["WHEELBASE"], dt=cfg["DT_CONTROLS"])
    ctl = torch.cat([c.reshape(-1, 2) for c in rec["controls"]]).cpu()
    xv0 = rec["xv0"]
    nominal = rfs.propagate(xv0, ctl, **kw)
    xv1 = (rfs.propagate(xv0, ctl, gen=gen, dtype=BF16, **kw) if control
           else rec["pre"]["xv"])
    got = xv1.to(torch.float64) - nominal
    want = rfs.propagate(xv0, ctl, gen=gen, **kw) - nominal
    got[2], want[2] = rfs.wrap(got[2]), rfs.wrap(want[2])
    return max(_stat_z(got[i], want[i]) for i in range(3))


def _gather(d: dict, anc) -> dict:
    """The particle fields of ``d`` taken at the ancestors ``anc``."""
    out = dict(d)
    for k in ("logw", "xv", "Pv"):
        out[k] = d[k][..., anc]
    out["lm"], out["lm_P"] = d["lm"][..., anc], d["lm_P"][..., anc]
    return out


def _control_post(pre: dict, z, ids, mask, R, n_min, gen, deferred: bool):
    """The reference's own update of ``pre`` in bfloat16, resample
    included, in the program's layout (float32 planes)."""
    lm, lm_P = pre["lm"], pre["lm_P"]
    if deferred and pre["pending"]:
        anc = _ancestors(pre["S"])
        lm, lm_P = lm[..., anc], lm_P[..., anc]
    logw, lm, lm_P, n, table = rfs.observe_update(
        pre["logw"], pre["xv"], lm, lm_P, pre["n"], pre["table"], z, ids,
        mask, R, dtype=BF16)
    post = dict(pre, logw=logw.float(), lm=lm.float(), lm_P=lm_P.float(),
                n=n, table=table)
    logw_n, _, fired = rfs.resample_decision(logw, n_min)
    P = logw.shape[0]
    post["logw"] = logw_n.float()
    if deferred:
        post.update(pending=fired, S=torch.arange(
            1, P + 1, device=logw.device))
    if fired:
        u = torch.rand(P, generator=gen, dtype=torch.float64,
                       device="cpu").to(logw.device)
        counts = rfs.stratified_counts(torch.exp(logw_n), u.to(BF16))
        anc = torch.repeat_interleave(torch.arange(P, device=logw.device),
                                      counts)
        uniform = torch.full((P,), -math.log(P), dtype=BF16,
                             device=logw.device).float()
        if deferred:
            post.update(S=torch.cumsum(counts, 0), xv=pre["xv"][:, anc],
                        Pv=pre["Pv"][:, anc], logw=uniform)
        else:
            post = dict(_gather(post, anc), logw=uniform)
    pose = rfs.pose_estimate(post["logw"], post["xv"], dtype=BF16)
    return post, pose.to(torch.float64)


def _ancestors(S):
    P = S.shape[0]
    return torch.searchsorted(S.long(), torch.arange(P, device=S.device),
                              right=True).clamp(max=P - 1)


def _match_ancestors(post_xv, pre_xv):
    """Each post particle's ancestor, by its pose bits equal to one pre
    particle's (-1 where none is)."""
    key = {tuple(c): i for i, c in enumerate(
        pre_xv.T.contiguous().view(torch.int32).cpu().tolist())}
    return torch.tensor([key.get(tuple(c), -1) for c in post_xv.T
                         .contiguous().view(torch.int32).cpu().tolist()],
                        device=post_xv.device)


def _start_misses(xv0, pre) -> int:
    """Fields of a run's start that are not what FastSLAM starts from:
    poses at the origin, uniform weights, no landmark, an empty table."""
    P = pre["logw"].shape[0]
    return sum(int(not ok) for ok in (
        bool((xv0 == 0).all()), bool((pre["lm"] == 0).all()),
        bool((pre["lm_P"] == 0).all()), int(pre["n"]) == 0,
        bool((pre["table"] == -1).all()),
        bool(((pre["logw"].double() + math.log(P)).abs() < 1e-6).all())))


def _update_numbers(pre, post, obs, pose_row, cfg, n_min, deferred):
    """(lm_gap, lmcov_gap, weight_gap, resample_gap, pose_gap_m, exact
    misses) of one copied superstep."""
    z, ids, mask = obs
    R = ((cfg["sigmaR"] ** 2, 0.0), (0.0, cfg["sigmaB"] ** 2))
    lm, lm_P = pre["lm"], pre["lm_P"]
    miss = 0
    if deferred and pre["pending"]:
        anc = _ancestors(pre["S"])
        lm, lm_P = lm[..., anc], lm_P[..., anc]
    logw, lm_r, lmP_r, n_r, table_r = rfs.observe_update(
        pre["logw"], pre["xv"], lm, lm_P, pre["n"], pre["table"], z, ids,
        mask, R)
    del lm, lm_P
    logw_n, neff, fired_r = rfs.resample_decision(logw, n_min)
    P = logw.shape[0]
    if deferred:
        fired = bool(post["pending"])
    else:
        fired = not torch.equal(post["xv"], pre["xv"])
    if fired != fired_r and abs(neff - n_min) > 1e-4 * n_min:
        miss += 1
    miss += int(int(post["n"]) != n_r)
    miss += int(not torch.equal(post["table"].long(), table_r))
    w_ref = torch.exp(logw_n)
    resample_gap = 0.0
    lm_p, lmP_p = post["lm"], post["lm_P"]
    if fired:
        if deferred:
            anc = _ancestors(post["S"])
            counts = torch.diff(post["S"].long(), prepend=post["S"].new_zeros(
                1).long())
        else:
            anc = _match_ancestors(post["xv"], pre["xv"])
            miss += int((anc < 0).sum())
            keep = anc >= 0
            anc = anc.clamp(min=0)
            counts = torch.bincount(anc[keep], minlength=P)
            lm_r, lmP_r = lm_r[..., anc], lmP_r[..., anc]
            lm_p, lmP_p = lm_p[..., keep], lmP_p[..., keep]
            lm_r, lmP_r = lm_r[..., keep], lmP_r[..., keep]
        # A stratified resample's counts lie within 2 of P w; float32
        # t = P csum can move each of a particle's two bounds by a slot,
        # so the program's lie within 4. The program hands the float tail
        # of its prefix sum to the last ancestor (``offspring_bounds``):
        # its count is the remainder.
        expect = (P * w_ref)[:-1]
        excess = ((counts.double()[:-1] - expect).abs() - 4.0).clamp(min=0)
        resample_gap = float((excess / expect.clamp(min=1.0)).max())
        if deferred:
            miss += int((post["xv"] != pre["xv"][:, anc]).any(0).sum())
            miss += int((post["Pv"] != pre["Pv"][:, anc]).any(0).sum())
        w_ref = torch.full_like(w_ref, 1.0 / P)
    elif deferred:
        miss += int(not torch.equal(post["xv"], pre["xv"]))
        miss += int(not torch.equal(post["S"].long(), torch.arange(
            1, P + 1, device=post["S"].device)))
    weight_gap = float(((torch.exp(post["logw"].double()) - w_ref).abs()
                        * P).max())
    sd = torch.sqrt(torch.cat([lmP_r[0:1], lmP_r[2:3]]) + 1e-12)
    lm_gap = float(((lm_p.double() - lm_r).abs() / sd).max())
    scale = torch.sqrt(lmP_r[0] * lmP_r[2] + 1e-24)
    lmcov_gap = float(((lmP_p.double() - lmP_r).abs() / scale).max())
    pose = rfs.pose_estimate(post["logw"], post["xv"])
    pose_gap = float((torch.as_tensor(pose_row).double().cpu()[:2]
                      - pose[:2].cpu()).norm())
    return lm_gap, lmcov_gap, weight_gap, resample_gap, pose_gap, miss


def filter_numbers(runs, captures, cfg, landmarks, waypoints, max_obs,
                   n_min, deferred: bool, seed: int, control=False,
                   ba=None) -> dict:
    """The numbers of a filter cell (see the module's docstring).

    ``runs``: per run of the window, its traces (numpy: true_pose,
    est_pose, active, obs_z, obs_mask, obs_ids, odom); ``captures``: (run
    index, superstep, the Recorder's record) of the copied supersteps;
    ``ba``: per composed run, its BA solve as ``ba_numbers`` takes it."""
    gen = torch.Generator().manual_seed(seed)
    out = {"truth_gap_m": _truth_numbers(runs, cfg, waypoints, control)}
    miss, out["obs_noise_z"] = _obs_numbers(runs, cfg, landmarks, max_obs,
                                            gen, control)
    R = ((cfg["sigmaR"] ** 2, 0.0), (0.0, cfg["sigmaB"] ** 2))
    gaps = []
    pz = []
    for run_i, step, rec in captures:
        dgen = torch.Generator(device=rec["xv0"].device).manual_seed(
            seed + 7919 * step + run_i)
        pz.append(_predict_z(rec, cfg, dgen, control))
        pre = rec["pre"]
        if control:
            post, pose_row = _control_post(pre, *rec["obs"], R, n_min, gen,
                                           deferred)
        else:
            post, pose_row = rec["post"], runs[run_i]["est_pose"][step]
        if step == 0:
            miss += _start_misses(rec["xv0"], pre)
        *g, m = _update_numbers(pre, post, rec["obs"], pose_row, cfg, n_min,
                                deferred)
        gaps.append(g)
        miss += m
    g = np.max(np.asarray(gaps), 0) if gaps else [None] * 5
    out.update(exact_miss=miss, predict_z=max(pz) if pz else None,
               lm_gap=g[0], lmcov_gap=g[1], weight_gap=g[2],
               resample_gap=g[3], pose_gap_m=g[4])
    if ba is not None:
        out.update(ba_numbers(ba, control))
    return {k: (None if v is None else float(v)) for k, v in out.items()}


def ba_numbers(solves, control=False) -> dict:
    """The BA numbers over solves: (problem as numpy arrays, poses,
    landmarks, the solver's costs: at the start and after each accepted
    iteration, its iteration budget). ``ba_cost_gap``: the solver's last
    cost against the float64 cost at its answer; ``ba_cost_excess``: the
    float64 cost at the answer over that at the answer of the
    reference's Levenberg-Marquardt in float64 under the same budget,
    less 1; ``ba_first_gap``: the cost after the solver's first accepted
    iteration against the reference's (1 where it has none). Also, for
    information, how far one float64 Gauss-Newton step
    moves the answer (``ba_step_m``, keyframes). The control solves each
    problem itself in float32 with TF32."""
    out = dict(ba_cost_gap=-math.inf, ba_cost_excess=-math.inf,
               ba_first_gap=0.0, ba_step_m=0.0)
    for prob_np, poses, lms, costs, iters in solves:
        dev = poses.device
        prob = rba.to_torch(prob_np, dev)
        if control:
            p32 = rba.to_torch(prob_np, dev, torch.float32)
            tf32 = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                poses, lms, costs = rba.lm_solve(p32, iters)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = tf32
        ref_costs = rba.lm_solve(prob, iters)[2]
        ref = ref_costs[-1]
        first = (abs(costs[1] - ref_costs[1]) / ref_costs[1]
                 if len(costs) > 1 and len(ref_costs) > 1 else 1.0)
        out["ba_first_gap"] = max(out["ba_first_gap"], first)
        j = rba.judge(prob, poses.double(), lms.double())
        out["ba_cost_gap"] = max(out["ba_cost_gap"],
                                 abs(costs[-1] - j["cost"]) / j["cost"])
        out["ba_cost_excess"] = max(out["ba_cost_excess"],
                                    j["cost"] / ref - 1.0)
        out["ba_step_m"] = max(out["ba_step_m"], j["move_m"])
    return out
