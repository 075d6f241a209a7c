"""The numbers that decide ``correct`` in a FastSLAM 2 cell: what the
timed path produced, judged by the plain reference
(``benchmark/reference/fastslam2.py``, float64, on the card).

Over the runs of the window, as the filter cells (``benchmark.checks``):
``truth_gap_m`` and ``obs_noise_z``, and in ``exact_miss`` the
observation batches that do not hold the visible landmarks. Over the
supersteps the ``Fs2Recorder`` copied, each stage from the program's own
state before it (the reference cannot redraw the program's random
numbers):

- the predict (the noise off, so deterministic): the superstep's ticks
  recomputed from the copied poses, pose covariances, controls and true
  headings; ``predict_xv_gap``, the largest gap of a pose (m, and rad
  for the heading), and ``predict_pv_gap``, of a pose covariance entry
  relative to the particle's largest variance;
- the proposal (a random stage, judged by its distribution): the
  refined mean xv_r and covariance Pv_r recomputed from the state that
  reached the update, and the program's sampled poses xvs mapped back to
  eps = chol(Pv_r)^-1 (xvs - xv_r), which must be N(0, 1):
  ``proposal_z``, the largest z-score of a coordinate's mean and of its
  variance against 0 and 1, over the copied supersteps that observed
  anything;
- at the program's xvs: the weights (prior / proposal and the
  likelihood; ``weight_gap``, the normalized weights' largest gap times
  P, and ``weight_tv``, their total variation distance, half the sum of
  the gaps: the largest gap grows with how few particles hold the weight,
  the distance does not), the matched landmarks' means and covariances
  and the new features (``lm_gap``, ``lmcov_gap``, as
  ``benchmark.checks`` scales them), and
  in ``exact_miss`` ``n``, the id table, Pv not zeroed where anything
  was observed (or moved where nothing was), the gate's decision
  (decisions within ``GATE_MARGIN`` of its threshold aside);
- the resample, where it fired: ``resample_gap`` (offspring counts
  against the reach of a stratified resample of the reference's
  weights, as ``benchmark.checks``) and, in ``exact_miss``, particles
  that are not exact copies of an ancestor (pose and pose covariance)
  and weights that are not uniform;
- ``pose_gap_m``: the run's pose estimate against the reference's from
  the state the update returned.

A copied update whose resample the recorder could not see (``mid``
None) counts one miss. With ``control=True`` the reference itself, in
bfloat16, stands in the program's place at every stage, drawing its own
eps and dithers from the seed; the simulator's numbers take the filter
cells' control.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark import checks
from benchmark.reference import fastslam2 as rfs2

BF16 = checks.BF16
# Relative distance of Neff from the gate's threshold within which its
# decision is not compared: the float32 prior / proposal term carries
# ~1e-4 relative error into each log weight (the adjugate of a pose
# covariance with a determinant of ~1e-13), more than FastSLAM 1's.
GATE_MARGIN = 1e-3


def _R(cfg: dict):
    return ((cfg["sigmaR"] ** 2, 0.0), (0.0, cfg["sigmaB"] ** 2))


def _predict_gaps(rec: dict, cfg: dict, control: bool):
    """(predict_xv_gap, predict_pv_gap) of one copied superstep."""
    ticks = rec["ticks"].double().cpu()
    xv_ref, Pv_ref = rfs2.predict(rec["xv0"], rec["Pv0"], ticks, cfg)
    if control:
        xv, Pv = rfs2.predict(rec["xv0"], rec["Pv0"], ticks, cfg, BF16)
    else:
        xv, Pv = rec["pre"]["xv"], rec["pre"]["Pv"]
    d = (xv.double() - xv_ref).abs()
    d[2] = rfs2.wrap(xv[2].double() - xv_ref[2]).abs()
    scale = Pv_ref[[0, 3, 5]].max(0).values.clamp(min=1e-300)
    return float(d.max()), float(((Pv.double() - Pv_ref).abs()
                                  / scale).max())


def _control(rec: dict, cfg: dict, n_min: float, gen):
    """The reference's own update of the copied state in bfloat16, its
    proposal draw and dithers from ``gen``: (mid, post, pose), in the
    program's layout."""
    pre = rec["pre"]
    z, ids, mask = rec["obs"]
    dev, P = pre["xv"].device, pre["logw"].shape[0]
    eps = torch.randn((3, P), generator=gen, dtype=torch.float64).to(dev)
    u = rfs2.update(pre["logw"], pre["xv"], pre["Pv"], pre["lm"],
                    pre["lm_P"], pre["n"], pre["table"], z, ids, mask.bool(),
                    _R(cfg), eps, BF16)
    mid = {k: u[k].float() for k in ("logw", "xv", "Pv")}
    logw_n, _, fired = rfs2.resample_decision(u["logw"], n_min)
    post = dict(mid, logw=logw_n.float(), lm=u["lm"].float(),
                lm_P=u["lm_P"].float(), n=torch.tensor(u["n"]),
                table=u["table"])
    if fired:
        dither = torch.rand(P, generator=gen, dtype=torch.float64).to(dev)
        anc = rfs2.stratified_ancestors(torch.exp(logw_n), dither.to(BF16))
        post = {k: (v[..., anc] if k in ("xv", "Pv", "lm", "lm_P") else v)
                for k, v in post.items()}
        post["logw"] = torch.full((P,), -math.log(P), dtype=BF16,
                                  device=dev).float()
    pose = rfs2.pose_estimate(post["logw"], post["xv"], BF16)
    return mid, post, pose.double()


def _eps_z(eps) -> float:
    """The larger z-score of the means (against 0) and of the mean
    squares (against 1) of the rows of a standard normal sample [3, n]."""
    n = eps.shape[1]
    mean_z = eps.mean(1).abs() * math.sqrt(n)
    var_z = ((eps * eps).mean(1) - 1.0).abs() / math.sqrt(2.0 / n)
    return float(torch.maximum(mean_z, var_z).max())


def _update_numbers(rec: dict, mid: dict, post: dict, pose_row, cfg: dict,
                    n_min: float):
    """(proposal_z or None, weight_gap, weight_tv, lm_gap, lmcov_gap,
    resample_gap, pose_gap_m, misses, matched, fired) of one copied
    update."""
    pre = rec["pre"]
    z, ids, mask = rec["obs"]
    mask = mask.bool()
    R = _R(cfg)
    P = pre["logw"].shape[0]
    f64 = torch.float64
    slot, matched, _ = rfs2.associate(pre["table"], ids, mask)
    miss, prop_z = 0, None
    if bool(mask.any()):
        xv_r, Pv_r = rfs2.refine(pre["xv"], pre["Pv"], pre["lm"],
                                 pre["lm_P"], z, slot, matched, R)
        prop_z = _eps_z(rfs2.noise_of(xv_r, Pv_r, mid["xv"]))
        corr = rfs2.log_weight(pre["xv"], pre["Pv"], xv_r, Pv_r, mid["xv"])
        miss += int(not bool((mid["Pv"] == 0).all()))
        del xv_r, Pv_r
    else:
        corr = 0.0
        miss += int(not torch.equal(mid["xv"], pre["xv"]))
        miss += int(not torch.equal(mid["Pv"], pre["Pv"]))
    loglik, lm_r, lmP_r, n_r, table_r = rfs2.observe(
        mid["xv"], pre["lm"], pre["lm_P"], pre["n"], pre["table"], z, ids,
        mask, R)
    logw_n, neff, fired_ref = rfs2.resample_decision(
        pre["logw"].to(f64) + corr + loglik, n_min)
    w_ref = torch.exp(logw_n)
    dw = torch.softmax(mid["logw"].to(f64), 0) - w_ref
    weight_gap = float((dw.abs() * P).max())
    weight_tv = 0.5 * float(dw.abs().sum())
    fired = not torch.equal(post["xv"], mid["xv"])
    if fired != fired_ref and abs(neff - n_min) > GATE_MARGIN * n_min:
        miss += 1
    miss += int(int(post["n"]) != n_r)
    miss += int(not torch.equal(post["table"].long(), table_r))
    lm_p, lmP_p = post["lm"], post["lm_P"]
    resample_gap = 0.0
    if fired:
        anc = checks._match_ancestors(post["xv"], mid["xv"])
        keep = anc >= 0
        miss += int((~keep).sum())
        anc = anc.clamp(min=0)
        miss += int(((post["Pv"] != mid["Pv"][:, anc]).any(0) & keep).sum())
        miss += int(not bool((post["logw"] == -math.log(P)).all()))
        counts = torch.bincount(anc[keep], minlength=P)
        # As benchmark.checks: within 2 of P w, one slot more at each
        # bound for the float32 prefix sum; the last ancestor takes the
        # sum's float tail.
        expect = (P * w_ref)[:-1]
        excess = ((counts.double()[:-1] - expect).abs() - 4.0).clamp(min=0)
        resample_gap = float((excess / expect.clamp(min=1.0)).max())
        lm_r, lmP_r = lm_r[..., anc][..., keep], lmP_r[..., anc][..., keep]
        lm_p, lmP_p = lm_p[..., keep], lmP_p[..., keep]
    else:
        miss += int(not torch.equal(post["Pv"], mid["Pv"]))
    sd = torch.sqrt(torch.cat([lmP_r[0:1], lmP_r[2:3]]) + 1e-12)
    lm_gap = float(((lm_p.to(f64) - lm_r).abs() / sd).max())
    scale = torch.sqrt(lmP_r[0] * lmP_r[2] + 1e-24)
    lmcov_gap = float(((lmP_p.to(f64) - lmP_r).abs() / scale).max())
    del lm_r, lmP_r
    pose = rfs2.pose_estimate(post["logw"], post["xv"])
    pose_gap = float((torch.as_tensor(pose_row).to(f64).cpu()[:2]
                      - pose[:2].cpu()).norm())
    return (prop_z, weight_gap, weight_tv, lm_gap, lmcov_gap, resample_gap,
            pose_gap,
            miss, int(matched.sum()), int(fired))


def fs2_numbers(runs, captures, cfg: dict, landmarks, waypoints,
                max_obs: int, n_min: float, seed: int,
                control: bool = False) -> dict:
    """The numbers of a FastSLAM 2 cell (see the module's docstring),
    and for information the observations matched (``matched``) and the
    resamples fired (``fired``) over the copied supersteps.

    ``runs``: per run of the window its traces (numpy: true_pose,
    est_pose, active, obs_z, obs_mask, obs_ids, odom); ``captures``:
    (run index, superstep, the ``Fs2Recorder``'s record)."""
    gen = torch.Generator().manual_seed(seed)
    out = {"truth_gap_m": checks._truth_numbers(runs, cfg, waypoints,
                                                control)}
    miss, out["obs_noise_z"] = checks._obs_numbers(runs, cfg, landmarks,
                                                   max_obs, gen, control)
    pred, upd, prop_z = [], [], []
    matched = fired = 0
    for run_i, step, rec in captures:
        pred.append(_predict_gaps(rec, cfg, control))
        if step == 0:
            miss += checks._start_misses(rec["xv0"], rec["pre"])
            miss += int(not bool((rec["Pv0"] == 0).all()))
        if control:
            mid, post, pose_row = _control(rec, cfg, n_min, gen)
        elif rec["mid"] is None:
            miss += 1
            continue
        else:
            mid, post = rec["mid"], rec["post"]
            pose_row = runs[run_i]["est_pose"][step]
        pz, *g, m, k, f = _update_numbers(rec, mid, post, pose_row, cfg,
                                          n_min)
        if pz is not None:
            prop_z.append(pz)
        upd.append(g)
        miss, matched, fired = miss + m, matched + k, fired + f
    p = np.max(np.asarray(pred), 0) if pred else [None] * 2
    g = np.max(np.asarray(upd), 0) if upd else [None] * 6
    out.update(exact_miss=miss, predict_xv_gap=p[0], predict_pv_gap=p[1],
               proposal_z=max(prop_z) if prop_z else None,
               weight_gap=g[0], weight_tv=g[1], lm_gap=g[2],
               lmcov_gap=g[3], resample_gap=g[4], pose_gap_m=g[5],
               matched=matched,
               fired=fired)
    return {k: (None if v is None else float(v)) for k, v in out.items()}
