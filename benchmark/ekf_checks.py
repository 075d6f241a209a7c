"""The numbers that decide ``correct`` in an EKF cell: what the timed
path produced, judged by the plain reference (``benchmark/reference/
ekf.py``, float64, on the card).

The runs start from a mapped start: the program's filter driven from
its own empty start for ``start_tick`` ticks. The EKF draws no random
number, so each superstep the driver copied is recomputed whole from the
program's own state before it: its ticks' predicts and IMU-heading
observes, the association, the update, the augment. Over the runs of the
window and the copied supersteps:

- ``truth_gap_m``: the runs' truth poses against the reference
  simulator's truth from waypoint 0, ``start_tick`` ticks on (float32's
  own drift over the drive lies in it); ``obs_noise_z``: the
  observations, as the filter cells judge them (``benchmark.checks``);
- ``exact_miss``: observation batches that do not hold the visible
  landmarks; IMU headings outside [truth, truth + sigmaT] (the truth the
  reference simulator's, within ``HEADING_SLACK``); the fields of the
  program's empty start that are not the filter's (zero mean and
  covariance, no landmark, an empty table), and of a run's superstep 0
  that are not the mapped start's, bit for bit; observations whose
  association or new-ness differs from the reference's, decisions within
  ``MARGIN`` of flipping aside; ``n`` and the id table, each compared
  whole;
- ``mean_gap_m``: the mean after the superstep, pose position and
  landmarks, against the reference's (metres);
- ``heading_gap_rad``: the pose heading after the superstep (for
  information: float32 with TF32 moves it by no more than float32's own
  rounding does, so no limit lies between the two);
- ``cov_gap``: the joint covariance after the superstep, the deferred
  heading terms folded (stored Pmm - hk hk'), against the reference's,
  relative to its largest entry.

The reference updates with the program's association (it judges that
association by itself), so that one flip at a near-tie cannot move
every other number.

With ``control=True`` the reference itself stands in the program's
place, one precision down: float32 with TF32 on a card, bfloat16
elsewhere (TF32 exists only on a card); the simulator's numbers take the
filter cells' control (bfloat16).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from benchmark import checks
from benchmark.reference import ekf as rekf
from benchmark.reference import sim as rsim

# Relative distance of a decision's statistic from flipping within which
# association is not compared: float32 NIS and log det S carry ~1e-6
# relative error.
MARGIN = 1e-4
# The program's float32 truth strays from the float64 truth by ~1e-5
# rad of heading over a run.
HEADING_SLACK = 1e-4
ROWS = 2048     # rows of the covariance compared at a time


def dense_covariance(st: dict, dtype=torch.float64):
    """The joint covariance [3 + 2L, 3 + 2L] of a copied block state in
    ``dtype``, the deferred heading terms folded."""
    N = st["x"].shape[0]
    P = torch.empty((N, N), dtype=dtype, device=st["x"].device)
    P[:3, :3] = st["P00"]
    P[:3, 3:] = st["P0m"]
    P[3:, :3] = st["P0m"].T
    P[3:, 3:] = st["Pmm"]
    if st["hk_n"]:
        hk = st["hk"][:, :st["hk_n"]].to(dtype)
        P[3:, 3:].addmm_(hk, hk.T, alpha=-1.0)
    return P


def _cov_gap(got: dict, P_ref) -> float:
    """max |P - P_ref| / max |P_ref|, ``got`` a block state or a dense
    covariance (``P``), row block by row block."""
    scale = float(P_ref.abs().max())
    N = P_ref.shape[0]
    if "P" in got:
        P = got["P"]
        worst = max(float((P[i:i + ROWS].double() - P_ref[i:i + ROWS])
                          .abs().max()) for i in range(0, N, ROWS))
        return worst / max(scale, 1e-300)
    hk = got["hk"][:, :got["hk_n"]].double()
    top = torch.cat([got["P00"], got["P0m"]], 1).double()
    worst = float((top - P_ref[:3]).abs().max())
    for i in range(0, N - 3, ROWS):
        rows = torch.cat([got["P0m"][:, i:i + ROWS].T.double(),
                          got["Pmm"][i:i + ROWS].double()], 1)
        if got["hk_n"]:
            rows[:, 3:] -= hk[i:i + ROWS] @ hk.T
        worst = max(worst, float((rows - P_ref[3 + i:3 + i + ROWS])
                                 .abs().max()))
    return worst / max(scale, 1e-300)


def start_misses(pre: dict) -> int:
    """Fields of a state that are not the filter's empty start."""
    return sum(int(not ok) for ok in (
        bool((pre["x"] == 0).all()), bool((pre["P00"] == 0).all()),
        bool((pre["P0m"] == 0).all()), bool((pre["Pmm"] == 0).all()),
        pre["hk_n"] == 0, int(pre["n"]) == 0,
        bool((pre["table"] == -1).all())))


def _copy_misses(pre: dict, start: dict) -> int:
    """Fields of a run's superstep-0 state that are not the mapped
    start's, bit for bit."""
    return sum(int(not (torch.equal(pre[k], start[k])
                        if isinstance(pre[k], torch.Tensor)
                        else pre[k] == start[k])) for k in start)


def _heading_misses(phi, truth, sigma_t: float) -> int:
    """IMU headings [T] outside [truth, truth + sigma_t], within
    HEADING_SLACK."""
    d = rsim.wrap(torch.as_tensor(phi, dtype=torch.float64)
                  - torch.as_tensor(truth, dtype=torch.float64))
    return int(((d < -HEADING_SLACK) | (d > sigma_t + HEADING_SLACK))
               .sum())


@contextlib.contextmanager
def _tf32(on: bool):
    matmul = torch.backends.cuda.matmul
    before = matmul.allow_tf32
    matmul.allow_tf32 = on
    try:
        yield
    finally:
        matmul.allow_tf32 = before


def _control(x, P, n, table, ticks, z, ids, mask, cfg):
    """The reference in the program's place, one precision down."""
    cuda = x.device.type == "cuda"
    dtype = torch.float32 if cuda else torch.bfloat16
    with _tf32(cuda):
        out = rekf.superstep(x.to(dtype), P.to(dtype), n, table, ticks,
                             z.to(dtype), ids, mask, cfg)
    return out, (out["assoc"], out["is_new"])


def superstep_numbers(rec: dict, cfg: dict, control: bool = False):
    """(mean_gap_m, heading_gap_rad, cov_gap, misses, near-ties, matched)
    of one copied superstep: the program's (or the control's) state after
    it against the reference's from the copied state before it."""
    pre = rec["pre"]
    z, ids, mask = rec["obs"]
    mask = mask.bool()
    ticks = [tuple(float(v) for v in t) for t in rec["ticks"].cpu()]
    x0 = pre["x"].double()
    P0 = dense_covariance(pre)
    n0, t0 = int(pre["n"]), pre["table"].long()
    if control:
        got, decided = _control(x0, P0, n0, t0, ticks, z, ids, mask, cfg)
        got = dict(got, n=torch.tensor(got["n"]))
    else:
        got = rec["post"]
        decided = tuple(t.long() for t in rec["assoc"]) if rec[
            "assoc"] is not None else None
    ref = rekf.superstep(x0, P0, n0, t0, ticks, z.double(), ids, mask, cfg,
                         decided=decided, margin=MARGIN)
    del P0
    misses = int(int(got["n"]) != ref["n"])
    misses += int(not torch.equal(got["table"].long(), ref["table"]))
    if decided is not None:
        sure = ~ref["tie"]
        misses += int(((decided[0] != ref["assoc"])
                       | (decided[1].bool() != ref["is_new"]))[sure].sum())
    x, xr = got["x"].double(), ref["x"]
    mean_gap = float(torch.cat([(x[:2] - xr[:2]).abs(),
                                (x[3:] - xr[3:]).abs()]).max())
    heading_gap = abs(float(rsim.wrap(x[2] - xr[2])))
    cov_gap = _cov_gap(got, ref["P"])
    return (mean_gap, heading_gap, cov_gap, misses, int(ref["tie"].sum()),
            int((ref["assoc"] >= 0).sum()))


def ekf_numbers(runs, captures, cfg: dict, landmarks, waypoints,
                max_obs: int, seed: int, start: dict, start_tick: int,
                init_misses: int, control: bool = False) -> dict:
    """The numbers of an EKF cell (see the module's docstring), and for
    information the near-ties exempted (``near_ties``) and the
    observations matched (``matched``) over the copied supersteps.

    ``runs``: per run of the window its traces (numpy: true_pose,
    est_pose, active, obs_z, obs_mask, obs_ids); ``captures``: (run
    index, superstep, record) with the record's ``pre`` and ``post``
    states (x, P00, P0m, Pmm, hk, hk_n, n, table), ``ticks`` [T, 3]
    (v, g, phi), ``obs`` (z, ids, mask) and ``assoc`` (the program's
    (assoc, is_new), or None under known association); ``start``: the
    mapped start, a state as ``pre``, ``start_tick`` ticks from waypoint
    0; ``init_misses``: ``start_misses`` of the program's empty start."""
    gen = torch.Generator().manual_seed(seed)
    period = round(cfg["DT_OBSERVE"] / cfg["DT_CONTROLS"])
    n_ticks = start_tick + max(r["true_pose"].shape[0] for r in runs) * period
    truth = rsim.truth_trajectory(cfg, waypoints, n_ticks)
    ref = truth[start_tick + period - 1::period, :2]
    if control:
        ctrl = rsim.truth_trajectory(cfg, waypoints, n_ticks, checks.BF16)
        ctrl = ctrl[start_tick + period - 1::period, :2]
    out = {"truth_gap_m": max(float(np.linalg.norm(
        (ctrl if control else r["true_pose"][:, :2])[:len(r["true_pose"])]
        - ref[:len(r["true_pose"])], axis=1).max()) for r in runs)}
    miss, out["obs_noise_z"] = checks._obs_numbers(
        runs, cfg, landmarks, max_obs, gen, control)
    miss += init_misses
    gaps, ties, matched = [], 0, 0
    for _, step, rec in captures:
        if step == 0:
            miss += _copy_misses(rec["pre"], start)
        if not control:
            t0 = start_tick + step * period
            ticks = rec["ticks"].double().cpu()
            miss += _heading_misses(ticks[:, 2], truth[t0:t0 + period, 2],
                                    cfg["sigmaT"])
        *g, m, t, k = superstep_numbers(rec, cfg, control)
        gaps.append(g)
        miss, ties, matched = miss + m, ties + t, matched + k
    g = np.max(np.asarray(gaps), 0) if gaps else [None] * 3
    out.update(exact_miss=miss, mean_gap_m=g[0], heading_gap_rad=g[1],
               cov_gap=g[2], near_ties=ties, matched=matched)
    return {k: (None if v is None else float(v)) for k, v in out.items()}
