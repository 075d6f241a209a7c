"""Plain reference of FastSLAM 2.0 (known data association, the optimal
proposal, stratified resampling), one control tick or one observation
update at a time, on particle-last planes:

    logw [P], xv [3, P], Pv [6, P] (the pose covariance, packed
    symmetric: 00, 01, 02, 11, 12, 22), lm [2, L, P], lm_P [3, L, P]
    (00, 01, 11), n live landmark slots, table [n_map] landmark id ->
    slot (-1 for none).

- ``predict``: each control tick's bicycle step on the given controls
  (the predict noise off) with Pv <- Gv Pv Gv' + Gu Q Gu'; with the
  heading known, then the scalar Joseph update of (xv, Pv) against the
  true heading;
- ``associate``: the shared id table's known association;
- ``refine``: the proposal refined over the matched observations in
  their order: K = Pv Hv' (Hv Pv Hv' + Hf Pf Hf' + R)^-1, xv += K v,
  Pv -= K Hv Pv, the Jacobians at the refined pose so far;
- ``sample``: xvs = xv_r + chol(Pv_r) eps from a given standard normal
  draw eps [3, P], the heading wrapped; ``noise_of`` inverts it;
- ``log_weight``: the importance weight's prior / proposal term,
  log N(xvs; xv, Pv) - log N(xvs; xv_r, Pv_r);
- ``observe``: at given poses, the log likelihood of the matched
  observations, their landmarks' 2x2 EKF updates and the new features;
- ``update``: all of that from a state and eps, up to the resample;
- ``resample_decision`` (the Neff gate), ``stratified_ancestors`` and
  ``stratified_counts`` (a stratified resample from given dithers),
  ``pose_estimate`` (the weighted mean position, the heading of the
  heaviest particle).

Written from matzipan/slam's ``src/backend/algorithms/fastslam2.cpp``
(``predictState``, ``sampleProposal``, ``likelihoodGivenXv``,
``gaussEvaluate``; Montemerlo et al., FastSLAM 2.0) with dense 2x2 and
3x3 matrices, in any dtype: a check runs it in float64, a control in
bfloat16 (the 2x2 solves, which ``torch.linalg`` lacks below float32,
then run in float32 and are rounded back). Its departures from
fastslam2.cpp, each the port's (``slam_tpu_torch.models.fastslam2``) as
well:

- the heading rate is V sin(G) / wheelbase, the simulator's truth
  model (fastslam2.cpp:103 has sin(G / wheelbase));
- the refinement in covariance form (Woodbury), the same Gaussian as
  fastslam2.cpp's information form Pv <- (Hv' Sf^-1 Hv + Pv^-1)^-1,
  xv <- xv + Pv Hv' Sf^-1 v, without inverting Pv, which is singular
  after an update zeroes it;
- a jitter of ``JITTER`` on Pv's diagonal wherever Pv is factored (the
  sample, the prior and the proposal densities), and the factor's pivots
  and the determinant of S clamped to ``TINY``, as the port does;
- a pose sampled and Pv zeroed whenever anything is observed, matched
  or new (fastslam2.cpp:36-42 does so for new features alone too), the
  refinement then over the matched ones only, and nothing sampled or
  weighted on an update that observes nothing;
- the heading observe of every particle on every tick, with the heading
  known (a no-op while Pv == 0).

Imports torch and math only, nothing of the program. The benchmark's
copy, ``benchmark/reference/fastslam2.py``, is this file byte for byte.
"""

from __future__ import annotations

import math

import torch

JITTER = 1e-9
TINY = 1e-30
_LOG_2PI = math.log(2.0 * math.pi)
_PACKED = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))
_LINALG = (torch.float32, torch.float64)


def wrap(a):
    """Angle(s) to [-pi, pi)."""
    return torch.remainder(a + math.pi, 2 * math.pi) - math.pi


def sym3(Pv):
    """[P, 3, 3] of packed planes [6, P]."""
    a, b, c, d, e, f = Pv
    return torch.stack([torch.stack([a, b, c], -1),
                        torch.stack([b, d, e], -1),
                        torch.stack([c, e, f], -1)], -2)


def packed(M):
    """Packed planes [6, P] of symmetric [P, 3, 3] (the mean of the two
    triangles)."""
    return torch.stack([0.5 * (M[:, i, j] + M[:, j, i]) for i, j in _PACKED])


def _linalg(fn, *args):
    """``fn(*args)``, in float32 where the arguments' dtype is below it,
    the result rounded back."""
    dtype = args[0].dtype
    if dtype in _LINALG:
        return fn(*args)
    return fn(*(a.float() for a in args)).to(dtype)


def _chol(M):
    """Lower Cholesky factor [P, 3, 3] of M + JITTER I, each pivot
    clamped to ``TINY`` (a pose covariance that rounding left indefinite
    still factors; the float64 check never meets one)."""
    a = M + JITTER * torch.eye(3, dtype=M.dtype, device=M.device)
    L = torch.zeros_like(a)
    for j in range(3):
        d = a[:, j, j] - (L[:, j, :j] ** 2).sum(-1)
        L[:, j, j] = torch.sqrt(torch.clamp(d, min=TINY))
        for i in range(j + 1, 3):
            L[:, i, j] = (a[:, i, j] - (L[:, i, :j] * L[:, j, :j]).sum(-1)
                          ) / L[:, j, j]
    return L


def _tri_solve(L, d):
    """L^-1 d for lower triangular L [P, 3, 3] and d [P, 3], by forward
    substitution."""
    y = torch.zeros_like(d)
    for i in range(3):
        y[:, i] = (d[:, i] - (L[:, i, :i] * y[:, :i]).sum(-1)) / L[:, i, i]
    return y


def _sym2(lm_P, s, dtype):
    """[P, 2, 2] landmark covariances at slot ``s``."""
    a, b, c = (lm_P[i, s].to(dtype) for i in range(3))
    return torch.stack([torch.stack([a, b], -1), torch.stack([b, c], -1)],
                       -2)


def _noise(R, dtype, device):
    return torch.tensor(R, dtype=dtype, device=device)


def predict(xv, Pv, ticks, cfg: dict, dtype=torch.float64):
    """(xv [3, P], Pv [6, P]) after the control ticks ``ticks`` [T, 3]
    (speed, steer, true heading) with the predict noise off, in
    ``dtype``. ``cfg``: WHEELBASE, DT_CONTROLS, sigmaV, sigmaG, sigmaT,
    SWITCH_HEADING_KNOWN."""
    dev = xv.device
    dt, wb = cfg["DT_CONTROLS"], cfg["WHEELBASE"]
    Q = torch.diag(torch.tensor([cfg["sigmaV"] ** 2, cfg["sigmaG"] ** 2],
                                dtype=dtype, device=dev))
    r = cfg["sigmaT"] ** 2
    x, y, th = (xv[i].to(dtype) for i in range(3))
    M = sym3(Pv.to(dtype))
    P = x.shape[0]
    eye = torch.eye(3, dtype=dtype, device=dev).expand(P, 3, 3)
    zero = torch.zeros_like(x)
    for v, g, phi in ticks.tolist():
        s, c = torch.sin(g + th), torch.cos(g + th)
        # Jacobians of the bicycle step at the heading before it.
        Gv = eye.clone()
        Gv[:, 0, 2] = -v * dt * s
        Gv[:, 1, 2] = v * dt * c
        Gu = torch.stack([
            torch.stack([dt * c, -v * dt * s], -1),
            torch.stack([dt * s, v * dt * c], -1),
            torch.stack([zero + dt * math.sin(g) / wb,
                         zero + v * dt * math.cos(g) / wb], -1)], -2)
        M = Gv @ M @ Gv.transpose(1, 2) + Gu @ Q @ Gu.transpose(1, 2)
        x, y, th = (x + v * dt * c, y + v * dt * s,
                    wrap(th + v * dt * math.sin(g) / wb))
        if cfg["SWITCH_HEADING_KNOWN"]:
            # H = [0, 0, 1]: K = M H' / (H M H' + r); the Joseph form.
            K = M[:, :, 2] / (M[:, 2, 2] + r)[:, None]
            innov = wrap(phi - th)
            x, y = x + K[:, 0] * innov, y + K[:, 1] * innov
            th = wrap(th + K[:, 2] * innov)
            A = eye.clone()
            A[:, :, 2] -= K
            M = (A @ M @ A.transpose(1, 2)
                 + r * K[:, :, None] * K[:, None, :])
    return torch.stack([x, y, th]), packed(M)


def associate(table, ids, mask):
    """(slot [K], 0 where unmatched; matched [K]; is_new [K]) of the
    observations' ids against the shared id table."""
    ids, table = ids.long(), table.long()
    slot = table[ids.clamp(0, table.shape[0] - 1)]
    matched = mask & (slot >= 0)
    return (torch.where(matched, slot, torch.zeros_like(slot)), matched,
            mask & (slot < 0))


def _model(pose, lx, ly, Pf, R):
    """The range-bearing model of one landmark [P] from poses [P, 3]:
    (predicted (range, bearing) [P, 2], Hv [P, 2, 3], Hf [P, 2, 2],
    Sf = Hf Pf Hf' + R [P, 2, 2])."""
    dx, dy = lx - pose[:, 0], ly - pose[:, 1]
    d2 = dx * dx + dy * dy
    d = torch.sqrt(d2)
    zhat = torch.stack([d, wrap(torch.atan2(dy, dx) - pose[:, 2])], -1)
    Hf = torch.stack([torch.stack([dx / d, dy / d], -1),
                      torch.stack([-dy / d2, dx / d2], -1)], -2)
    Hv = torch.cat([-Hf, torch.stack([torch.zeros_like(d),
                                      -torch.ones_like(d)], -1)[..., None]],
                   -1)
    return zhat, Hv, Hf, Hf @ Pf @ Hf.transpose(1, 2) + R


def _innovation(z_k, zhat, dtype):
    v = z_k.to(dtype) - zhat
    return torch.stack([v[:, 0], wrap(v[:, 1])], -1)


def refine(xv, Pv, lm, lm_P, z, slot, matched, R, dtype=torch.float64):
    """The proposal (xv_r [3, P], Pv_r [6, P]) refined from (xv, Pv) over
    the matched observations in their order. ``R``: the 2x2 observation
    noise as nested floats."""
    Rm = _noise(R, dtype, xv.device)
    pose = xv.to(dtype).T.clone()
    M = sym3(Pv.to(dtype))
    for k in torch.nonzero(matched).flatten().tolist():
        s = int(slot[k])
        zhat, Hv, _, Sf = _model(pose, lm[0, s].to(dtype),
                                 lm[1, s].to(dtype), _sym2(lm_P, s, dtype),
                                 Rm)
        v = _innovation(z[k], zhat, dtype)
        U = M @ Hv.transpose(1, 2)                       # Pv Hv' [P, 3, 2]
        S = Sf + Hv @ U
        K = _linalg(lambda A, B: torch.linalg.solve(A, B),
                    S, U.transpose(1, 2)).transpose(1, 2)   # U S^-1
        pose = pose + (K @ v[..., None])[..., 0]
        pose[:, 2] = wrap(pose[:, 2])
        M = M - K @ U.transpose(1, 2)
    return pose.T, packed(M)


def sample(xv_r, Pv_r, eps, dtype=torch.float64):
    """xvs [3, P] = xv_r + chol(Pv_r) eps, the heading wrapped."""
    L = _chol(sym3(Pv_r.to(dtype)))
    xs = xv_r.to(dtype).T + (L @ eps.to(dtype).T[..., None])[..., 0]
    xs[:, 2] = wrap(xs[:, 2])
    return xs.T


def _deviation(x, mu):
    """x - mu [P, 3], the heading wrapped."""
    d = (x - mu).T.clone()
    d[:, 2] = wrap(d[:, 2])
    return d


def noise_of(xv_r, Pv_r, xvs):
    """The standard normal draw eps [3, P] that ``sample`` maps to
    ``xvs``, in float64: chol(Pv_r)^-1 (xvs - xv_r)."""
    f64 = torch.float64
    L = _chol(sym3(Pv_r.to(f64)))
    return _tri_solve(L, _deviation(xvs.to(f64), xv_r.to(f64))).T


def log_gauss3(x, mu, Pv, dtype=torch.float64):
    """log N(x; mu, Pv + JITTER I) [P], the heading's deviation
    wrapped."""
    L = _chol(sym3(Pv.to(dtype)))
    y = _tri_solve(L, _deviation(x.to(dtype), mu.to(dtype)))
    logdet = 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
    return -0.5 * (y * y).sum(-1) - 1.5 * _LOG_2PI - 0.5 * logdet


def log_weight(xv, Pv, xv_r, Pv_r, xvs, dtype=torch.float64):
    """The importance weight's prior / proposal term at the sampled
    poses, log N(xvs; xv, Pv) - log N(xvs; xv_r, Pv_r) [P]."""
    return (log_gauss3(xvs, xv, Pv, dtype)
            - log_gauss3(xvs, xv_r, Pv_r, dtype))


def observe(xv, lm, lm_P, n, table, z, ids, mask, R, dtype=torch.float64):
    """At the poses ``xv`` [3, P]: (the log likelihood of the matched
    observations [P], lm, lm_P, n, table): each matched landmark's 2x2
    EKF update, each new landmark at the next free slot (those past the
    capacity dropped), initialized from the pose. New tensors in
    ``dtype`` (n an int, table int64)."""
    dev = xv.device
    L = lm.shape[1]
    Rm = _noise(R, dtype, dev)
    pose = xv.to(dtype).T
    slot, matched, is_new = associate(table, ids, mask)
    new = is_new.long()
    slot_new = int(n) + torch.cumsum(new, 0) - new
    ok = is_new & (slot_new < L)
    lm_o, lmP_o = lm.to(dtype).clone(), lm_P.to(dtype).clone()
    loglik = torch.zeros(pose.shape[0], dtype=dtype, device=dev)
    for k in torch.nonzero(matched).flatten().tolist():
        s = int(slot[k])
        Pf = _sym2(lm_P, s, dtype)
        zhat, _, Hf, Sf = _model(pose, lm[0, s].to(dtype),
                                 lm[1, s].to(dtype), Pf, Rm)
        v = _innovation(z[k], zhat, dtype)
        Si = _linalg(torch.linalg.inv, Sf)
        det = torch.clamp(Sf[:, 0, 0] * Sf[:, 1, 1]
                          - Sf[:, 0, 1] * Sf[:, 1, 0], min=TINY)
        quad = (v[:, None, :] @ Si @ v[..., None])[:, 0, 0]
        loglik = loglik - 0.5 * quad - _LOG_2PI - 0.5 * torch.log(det)
        W = Pf @ Hf.transpose(1, 2) @ Si
        xf = torch.stack([lm[0, s], lm[1, s]], -1).to(dtype)
        xf = xf + (W @ v[..., None])[..., 0]
        Pn = Pf - W @ Sf @ W.transpose(1, 2)
        lm_o[0, s], lm_o[1, s] = xf[:, 0], xf[:, 1]
        lmP_o[0, s], lmP_o[2, s] = Pn[:, 0, 0], Pn[:, 1, 1]
        lmP_o[1, s] = 0.5 * (Pn[:, 0, 1] + Pn[:, 1, 0])
    for k in torch.nonzero(ok).flatten().tolist():
        s = int(slot_new[k])
        r, b = z[k, 0].to(dtype), z[k, 1].to(dtype)
        c, sn = torch.cos(pose[:, 2] + b), torch.sin(pose[:, 2] + b)
        lm_o[0, s] = pose[:, 0] + r * c
        lm_o[1, s] = pose[:, 1] + r * sn
        # Pf = G R G', G = d(landmark) / d(range, bearing).
        G = torch.stack([torch.stack([c, -r * sn], -1),
                         torch.stack([sn, r * c], -1)], -2)
        Pn = G @ Rm @ G.transpose(1, 2)
        lmP_o[0, s], lmP_o[2, s] = Pn[:, 0, 0], Pn[:, 1, 1]
        lmP_o[1, s] = 0.5 * (Pn[:, 0, 1] + Pn[:, 1, 0])
    table_o = table.long().clone()
    table_o[ids.long()[ok]] = slot_new[ok]
    return loglik, lm_o, lmP_o, int(n) + int(ok.sum()), table_o


def update(logw, xv, Pv, lm, lm_P, n, table, z, ids, mask, R, eps,
           dtype=torch.float64) -> dict:
    """The update of a state up to the resample, the proposal drawn from
    ``eps`` [3, P]: a dict of xv_r, Pv_r, the sampled poses xv, Pv
    (zeroed), logw (prior / proposal and likelihood added), lm, lm_P, n,
    table. With nothing observed the state as it was."""
    if not bool(mask.any()):
        return dict(xv_r=xv.to(dtype), Pv_r=Pv.to(dtype), xv=xv.to(dtype),
                    Pv=Pv.to(dtype), logw=logw.to(dtype), lm=lm.to(dtype),
                    lm_P=lm_P.to(dtype), n=int(n), table=table.long())
    slot, matched, _ = associate(table, ids, mask)
    xv_r, Pv_r = refine(xv, Pv, lm, lm_P, z, slot, matched, R, dtype)
    xvs = sample(xv_r, Pv_r, eps, dtype)
    corr = log_weight(xv, Pv, xv_r, Pv_r, xvs, dtype)
    loglik, lm_o, lmP_o, n_o, table_o = observe(xvs, lm, lm_P, n, table, z,
                                                ids, mask, R, dtype)
    return dict(xv_r=xv_r, Pv_r=Pv_r, xv=xvs,
                Pv=torch.zeros_like(Pv, dtype=dtype),
                logw=logw.to(dtype) + corr + loglik, lm=lm_o, lm_P=lmP_o,
                n=n_o, table=table_o)


def resample_decision(logw, n_min: float):
    """(normalized log weights, Neff, whether Neff < n_min)."""
    logw_n = logw - torch.logsumexp(logw, 0)
    neff = float(1.0 / torch.sum(torch.exp(2 * logw_n)))
    return logw_n, neff, neff < n_min


def stratified_ancestors(w, u):
    """The ancestors [P] of a stratified resample of weights ``w`` [P]
    (summing to 1) with dithers ``u`` [P] in [0, 1): output j draws the
    particle whose stratum of the cumulative weights holds
    (j + u_j) / P."""
    P = w.shape[0]
    pos = (torch.arange(P, dtype=w.dtype, device=w.device) + u.to(w.dtype)
           ) / P
    return torch.searchsorted(torch.cumsum(w, 0), pos,
                              right=True).clamp(max=P - 1)


def stratified_counts(w, u):
    """Offspring counts [P] of ``stratified_ancestors``."""
    return torch.bincount(stratified_ancestors(w, u), minlength=w.shape[0])


def pose_estimate(logw, xv, dtype=torch.float64):
    """[3]: the weighted mean position and the heading of the heaviest
    particle (the first, on ties), computed in ``dtype``."""
    w = torch.softmax(logw.to(dtype), 0)
    xy = (xv[:2].to(dtype) * w).sum(1)
    return torch.cat([xy, xv[2, torch.argmax(logw)].reshape(1).to(dtype)])
