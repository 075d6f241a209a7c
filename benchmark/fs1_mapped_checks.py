"""The numbers that decide ``correct`` in a FastSLAM 1 cell at full
per-particle capacity, from a mapped start: what the timed path produced,
judged by the plain reference (``benchmark/reference/fastslam.py``,
float64, on the card).

The runs start from a mapped start: the program's filter driven from its
own empty start for ``start_tick`` ticks. Over the runs of the window,
as the filter cells (``benchmark.checks``): ``truth_gap_m``, the runs'
truth against the reference simulator's truth from waypoint 0,
``start_tick`` ticks on; ``obs_noise_z``; and in ``exact_miss`` the
observation batches that do not hold the visible landmarks. Over the
supersteps the ``LiveRecorder`` copied (live slot rows only), each stage
from the program's own state before it:

- ``predict_z``: the predict's draw as a distribution
  (``benchmark.checks``);
- the update, the pending resample's gather applied first: the weights
  that reach the gate (``weight_gap``: the normalized weights' largest
  gap times P, as ``benchmark.checks``; the recorder's ``mid``, so that
  the likelihood is judged on a superstep whose resample fires too, as
  nearly every one here does), the landmark means and covariances of
  slots [0, n) after the update (``lm_gap``, ``lmcov_gap``, as
  ``benchmark.checks`` scales them), and in ``exact_miss`` ``n``, the id
  table, the gate's decision (decisions within ``GATE_MARGIN`` of its
  threshold aside), and where a resample was pending the rows the update
  did not touch that are not their ancestor's bit for bit (the fused
  gather's copies);
- the update's own resample, where it fired: ``resample_gap`` (as
  ``benchmark.checks``) and, in ``exact_miss``, pose rows that are not
  their ancestor's and weights that are not uniform; where it held,
  poses or bounds that moved, and ``weight_gap`` takes the returned
  weights too; an update whose gate the recorder did not see (``mid``
  None) counts one miss;
- ``pose_gap_m``: the run's pose estimate against the reference's from
  the state the update returned;
- in ``exact_miss``, the fields of a run's superstep 0 that are not the
  mapped start's, bit for bit: the poses before its predict, and the
  weights, pose covariances, live rows, ``n``, the table, ``S`` and
  ``pending`` that reach its update (the predict moves the poses only).

Rows at and past ``n`` are never read before a new feature writes them,
so they are not judged. The reference runs in blocks of ``BLOCK``
particles, beside what the window left on the card. With
``control=True`` the reference itself, in bfloat16, stands in the
program's place (``benchmark.checks``), and the simulator's numbers take
the filter cells' control.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import checks
from benchmark.reference import fastslam as rfs
from benchmark.reference import sim as rsim

BLOCK = 4096
# Relative distance of Neff from the gate's threshold within which its
# decision is not compared: float32 log weights carry ~1e-6 relative
# error into Neff.
GATE_MARGIN = 1e-4
START_KEYS = ("logw", "Pv", "n", "table", "S", "pending")


def _start_misses(rec: dict, start: dict) -> int:
    """Fields of a run's superstep 0 that are not the mapped start's."""
    pre, n = rec["pre"], int(start["n"])
    miss = int(not torch.equal(rec["xv0"], start["xv"]))
    for k in START_KEYS:
        a, b = pre[k], start[k]
        miss += int(not (torch.equal(a, b) if isinstance(a, torch.Tensor)
                         else a == b))
    for k in ("lm", "lm_P"):
        miss += int(not torch.equal(pre[k][:, :n], start[k][:, :n]))
    return miss


def _map_numbers(pre: dict, post: dict, obs, R):
    """(logw [P] float64, n, table, lm_gap, lmcov_gap, copy misses) of
    the reference's update of ``pre`` against ``post``, over slots
    [0, n) after it, block by block of particles."""
    z, ids, mask = obs
    P = pre["logw"].shape[0]
    anc = checks._ancestors(pre["S"]) if pre["pending"] else None
    n0 = int(pre["n"])
    slot = pre["table"].long()[ids.long().clamp(0, pre["table"].shape[0]
                                                - 1)]
    untouched = torch.ones(n0, dtype=torch.bool, device=slot.device)
    untouched[slot[mask.bool() & (slot >= 0)]] = False
    logw, lm_gap, lmcov_gap, copies = [], 0.0, 0.0, 0
    n_r = table_r = None
    for p0 in range(0, P, BLOCK):
        cols = slice(p0, min(P, p0 + BLOCK))
        src = cols if anc is None else anc[cols]
        lm, lm_P = pre["lm"][..., src], pre["lm_P"][..., src]
        lw, lm_r, lmP_r, n_r, table_r = rfs.observe_update(
            pre["logw"][cols], pre["xv"][:, cols], lm, lm_P, pre["n"],
            pre["table"], z, ids, mask, R)
        logw.append(lw)
        got, got_P = post["lm"][:, :n_r, cols], post["lm_P"][:, :n_r, cols]
        lm_r, lmP_r = lm_r[:, :n_r], lmP_r[:, :n_r]
        sd = torch.sqrt(torch.cat([lmP_r[0:1], lmP_r[2:3]]) + 1e-12)
        lm_gap = max(lm_gap, float(((got.double() - lm_r).abs() / sd).max()))
        scale = torch.sqrt(lmP_r[0] * lmP_r[2] + 1e-24)
        lmcov_gap = max(lmcov_gap, float(((got_P.double() - lmP_r).abs()
                                          / scale).max()))
        if anc is not None:
            for a, b in ((got, lm), (got_P, lm_P)):
                copies += int((a[:, :n0][:, untouched]
                               != b[:, :n0][:, untouched]).any(0).any(0)
                              .sum())
        del lm, lm_P, lm_r, lmP_r
    return torch.cat(logw), n_r, table_r, lm_gap, lmcov_gap, copies


def _weight_gap(logw, w_ref) -> float:
    """The normalized weights of ``logw`` against ``w_ref``: the largest
    gap times P."""
    w = torch.softmax(logw.double(), 0)
    return float(((w - w_ref).abs() * w.shape[0]).max())


def _update_numbers(pre, mid, post, obs, pose_row, cfg, n_min):
    """(weight_gap, lm_gap, lmcov_gap, resample_gap, pose_gap_m, exact
    misses) of one copied superstep; ``mid`` the log weights that reached
    the gate."""
    R = ((cfg["sigmaR"] ** 2, 0.0), (0.0, cfg["sigmaB"] ** 2))
    logw, n_r, table_r, lm_gap, lmcov_gap, miss = _map_numbers(
        pre, post, obs, R)
    logw_n, neff, fired_r = rfs.resample_decision(logw, n_min)
    P = logw.shape[0]
    w_ref = torch.exp(logw_n)
    weight_gap = 0.0
    if mid is None:
        miss += 1
    else:
        weight_gap = _weight_gap(mid, w_ref)
    fired = bool(post["pending"])
    if fired != fired_r and abs(neff - n_min) > GATE_MARGIN * n_min:
        miss += 1
    miss += int(int(post["n"]) != n_r)
    miss += int(not torch.equal(post["table"].long(), table_r))
    resample_gap = 0.0
    if fired:
        S = post["S"].long()
        anc = checks._ancestors(post["S"])
        counts = torch.diff(S, prepend=S.new_zeros(1))
        # As benchmark.checks: within 2 of P w, one slot more at each
        # bound for the float32 prefix sum; the last ancestor takes the
        # sum's float tail.
        expect = (P * w_ref)[:-1]
        excess = ((counts.double()[:-1] - expect).abs() - 4.0).clamp(min=0)
        resample_gap = float((excess / expect.clamp(min=1.0)).max())
        miss += int((post["xv"] != pre["xv"][:, anc]).any(0).sum())
        miss += int((post["Pv"] != pre["Pv"][:, anc]).any(0).sum())
        miss += int(not bool((post["logw"] == post["logw"][0]).all()))
    else:
        miss += int(not torch.equal(post["xv"], pre["xv"]))
        miss += int(not torch.equal(post["S"].long(), torch.arange(
            1, P + 1, device=post["S"].device)))
        weight_gap = max(weight_gap, _weight_gap(post["logw"], w_ref))
    pose = rfs.pose_estimate(post["logw"], post["xv"])
    pose_gap = float((torch.as_tensor(pose_row).double().cpu()[:2]
                      - pose[:2].cpu()).norm())
    return weight_gap, lm_gap, lmcov_gap, resample_gap, pose_gap, miss


def _control_mid(pre: dict, obs, R):
    """The log weights the reference's update reaches its gate with, in
    bfloat16."""
    lm, lm_P = pre["lm"], pre["lm_P"]
    if pre["pending"]:
        anc = checks._ancestors(pre["S"])
        lm, lm_P = lm[..., anc], lm_P[..., anc]
    return rfs.observe_update(pre["logw"], pre["xv"], lm, lm_P, pre["n"],
                              pre["table"], *obs, R,
                              dtype=checks.BF16)[0].float()


def _truth_gap(runs, cfg, waypoints, start_tick: int, control: bool):
    period = round(cfg["DT_OBSERVE"] / cfg["DT_CONTROLS"])
    n_ticks = start_tick + max(r["true_pose"].shape[0]
                               for r in runs) * period
    first = start_tick + period - 1
    ref = rsim.truth_trajectory(cfg, waypoints, n_ticks)[first::period, :2]
    if control:
        ctrl = rsim.truth_trajectory(cfg, waypoints, n_ticks,
                                     checks.BF16)[first::period, :2]
    return max(float(np.linalg.norm(
        (ctrl if control else r["true_pose"][:, :2])[:len(r["true_pose"])]
        - ref[:len(r["true_pose"])], axis=1).max()) for r in runs)


def fs1_mapped_numbers(runs, captures, cfg: dict, landmarks, waypoints,
                       max_obs: int, n_min: float, seed: int, start: dict,
                       start_tick: int, control: bool = False) -> dict:
    """The numbers of the cell (see the module's docstring), and for
    information the resamples fired over the copied supersteps
    (``fired``).

    ``runs``: per run of the window its traces (numpy: true_pose,
    est_pose, active, obs_z, obs_mask, obs_ids, odom); ``captures``: (run
    index, superstep, the ``LiveRecorder``'s record); ``start``: the
    mapped start as ``fs1_recorder.live_dict`` copies it, its live rows
    [0, n)."""
    gen = torch.Generator().manual_seed(seed)
    out = {"truth_gap_m": _truth_gap(runs, cfg, waypoints, start_tick,
                                     control)}
    miss, out["obs_noise_z"] = checks._obs_numbers(runs, cfg, landmarks,
                                                   max_obs, gen, control)
    R = ((cfg["sigmaR"] ** 2, 0.0), (0.0, cfg["sigmaB"] ** 2))
    gaps, pz, fired = [], [], 0
    for run_i, step, rec in captures:
        dgen = torch.Generator(device=rec["xv0"].device).manual_seed(
            seed + 7919 * step + run_i)
        pz.append(checks._predict_z(rec, cfg, dgen, control))
        pre = rec["pre"]
        if step == 0:
            miss += _start_misses(rec, start)
        if control:
            mid = _control_mid(pre, rec["obs"], R)
            post, pose_row = checks._control_post(pre, *rec["obs"], R, n_min,
                                                  gen, True)
        else:
            mid, post = rec["mid"], rec["post"]
            pose_row = runs[run_i]["est_pose"][step]
        *g, m = _update_numbers(pre, mid, post, rec["obs"], pose_row, cfg,
                                n_min)
        gaps.append(g)
        miss += m
        fired += int(bool(post["pending"]))
    g = np.max(np.asarray(gaps), 0) if gaps else [None] * 5
    out.update(exact_miss=miss, predict_z=max(pz) if pz else None,
               weight_gap=g[0], lm_gap=g[1], lmcov_gap=g[2],
               resample_gap=g[3], pose_gap_m=g[4], fired=fired)
    return {k: (None if v is None else float(v)) for k, v in out.items()}
