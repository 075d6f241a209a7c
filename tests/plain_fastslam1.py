"""Plain reference of FastSLAM 1.0 (known data association, stratified
resampling), one superstep at a time, on particle-last planes:

    logw [P], xv [3, P], lm [2, L, P], lm_P [3, L, P] (00, 01, 11),
    n [] live landmark slots, da_table [n_map] (landmark id -> slot).

``observe_update`` is the observation update: each observation of a
landmark the particle holds weights the particle by N(v; 0, S) and
updates that landmark by a 2x2 EKF step; each observation of a new
landmark takes the next free slot, initialized from the particle's pose.
``resample_decision`` is the Neff gate; ``stratified_counts`` the
offspring counts of a stratified resample; ``propagate`` the bicycle
motion model; ``pose_estimate`` the weighted-mean position with the
heading of the heaviest particle.

Written from the algorithm (Montemerlo et al., FastSLAM; the reference
simulator's conventions), in any dtype: the check runs it in float64,
the control in bfloat16. Imports torch only.
"""

from __future__ import annotations

import math

import torch


def wrap(a):
    """Angle(s) to [-pi, pi)."""
    return torch.remainder(a + math.pi, 2 * math.pi) - math.pi


def observe_update(logw, xv, lm, lm_P, n, table, z, ids, mask, R,
                   dtype=torch.float64, block: int = 1 << 17):
    """The observation update of every particle: (logw [P], lm, lm_P, n,
    table), new tensors in ``dtype`` (n and table int64). ``R`` is the
    2x2 observation noise as nested floats; z [K, 2], ids [K], mask [K]."""
    dev = xv.device
    L, P = lm.shape[1], xv.shape[1]
    cast = lambda t: t.to(dtype)                          # noqa: E731
    ids = ids.long()
    table = table.long().clone()
    slot = table[ids.clamp(0, table.shape[0] - 1)]
    matched = mask & (slot >= 0)
    is_new = mask & (slot < 0)
    new = is_new.long()
    slot_new = int(n) + torch.cumsum(new, 0) - new
    ok = is_new & (slot_new < L)
    r00, r01, r11 = (torch.tensor(v, dtype=dtype, device=dev)
                     for v in (R[0][0], R[0][1], R[1][1]))
    zr, zb = cast(z[:, 0])[:, None], cast(z[:, 1])[:, None]
    logw_o, lm_o, lmP_o = cast(logw).clone(), cast(lm).clone(), \
        cast(lm_P).clone()
    mk = torch.nonzero(matched).flatten()
    nk = torch.nonzero(ok).flatten()
    for p0 in range(0, P, block):
        sl = slice(p0, min(P, p0 + block))
        x, y, th = (cast(xv[i, sl])[None, :] for i in range(3))
        if mk.numel():
            s = slot[mk]
            lx, ly = cast(lm[0, s, sl]), cast(lm[1, s, sl])
            a, b, c = (cast(lm_P[i, s, sl]) for i in range(3))
            dx, dy = lx - x, ly - y
            d2 = dx * dx + dy * dy
            d = torch.sqrt(d2)
            # Hf = [[h0, h1], [h2, h3]]: d(range, bearing) / d(landmark).
            h0, h1, h2, h3 = dx / d, dy / d, -dy / d2, dx / d2
            v0 = zr[mk] - d
            v1 = wrap(zb[mk] - (torch.atan2(dy, dx) - th))
            # PHt = P Hf', S = Hf P Hf' + R.
            q00, q01 = a * h0 + b * h1, a * h2 + b * h3
            q10, q11 = b * h0 + c * h1, b * h2 + c * h3
            s00 = h0 * q00 + h1 * q10 + r00
            s01 = h0 * q01 + h1 * q11 + r01
            s11 = h2 * q01 + h3 * q11 + r11
            det = s00 * s11 - s01 * s01
            logw_o[sl] += torch.sum(
                -0.5 * (s11 * v0 * v0 - 2 * s01 * v0 * v1 + s00 * v1 * v1)
                / det - math.log(2 * math.pi) - 0.5 * torch.log(det), 0)
            # K = PHt S^-1; x += K v; P -= K S K'.
            k00 = (q00 * s11 - q01 * s01) / det
            k01 = (q01 * s00 - q00 * s01) / det
            k10 = (q10 * s11 - q11 * s01) / det
            k11 = (q11 * s00 - q10 * s01) / det
            lm_o[0, s, sl] = lx + k00 * v0 + k01 * v1
            lm_o[1, s, sl] = ly + k10 * v0 + k11 * v1
            lmP_o[0, s, sl] = a - (k00 * q00 + k01 * q01)
            lmP_o[1, s, sl] = b - (k00 * q10 + k01 * q11)
            lmP_o[2, s, sl] = c - (k10 * q10 + k11 * q11)
        if nk.numel():
            s = slot_new[nk]
            r, brg = zr[nk], zb[nk]
            cs, sn = torch.cos(th + brg), torch.sin(th + brg)
            lm_o[0, s, sl] = x + r * cs
            lm_o[1, s, sl] = y + r * sn
            # P = G R G', G = d(landmark) / d(range, bearing).
            g00, g01, g10, g11 = cs, -r * sn, sn, r * cs
            lmP_o[0, s, sl] = g00 * (g00 * r00 + g01 * r01) + g01 * (
                g00 * r01 + g01 * r11)
            lmP_o[1, s, sl] = g10 * (g00 * r00 + g01 * r01) + g11 * (
                g00 * r01 + g01 * r11)
            lmP_o[2, s, sl] = g10 * (g10 * r00 + g11 * r01) + g11 * (
                g10 * r01 + g11 * r11)
    table[ids[ok]] = slot_new[ok]
    return logw_o, lm_o, lmP_o, int(n) + int(ok.sum()), table


def resample_decision(logw, n_min: float):
    """(normalized log weights, Neff, whether Neff < n_min)."""
    logw_n = logw - torch.logsumexp(logw, 0)
    neff = float(1.0 / torch.sum(torch.exp(2 * logw_n)))
    return logw_n, neff, neff < n_min


def stratified_counts(w, u):
    """Offspring counts [P] of a stratified resample of weights ``w``
    [P] (summing to 1) with dithers ``u`` [P] in [0, 1): output j draws
    the ancestor whose stratum of the cumulative weights holds
    (j + u_j) / P."""
    P = w.shape[0]
    pos = (torch.arange(P, dtype=w.dtype, device=w.device) + u) / P
    csum = torch.cumsum(w, 0)
    anc = torch.searchsorted(csum, pos, right=True).clamp(max=P - 1)
    return torch.bincount(anc, minlength=P)


def propagate(xv, controls, Q, wheelbase: float, dt: float, gen=None,
              dtype=torch.float64):
    """The poses after the control ticks ``controls`` [T, 2] (speed,
    steer), each particle's controls perturbed by N(0, Q) (diagonal Q)
    drawn from ``gen`` where given; [3, P] in ``dtype``."""
    x, y, th = (xv[i].to(dtype) for i in range(3))
    P = x.shape[0]
    sv, sg = math.sqrt(Q[0][0]), math.sqrt(Q[1][1])
    for v, g in controls.tolist():
        V = torch.full((P,), v, dtype=dtype, device=x.device)
        G = torch.full((P,), g, dtype=dtype, device=x.device)
        if gen is not None:
            e = torch.randn((2, P), generator=gen, dtype=torch.float64,
                            device=x.device).to(dtype)
            V, G = V + sv * e[0], G + sg * e[1]
        x, y, th = (x + V * dt * torch.cos(G + th),
                    y + V * dt * torch.sin(G + th),
                    wrap(th + V * dt * torch.sin(G) / wheelbase))
    return torch.stack([x, y, th])


def pose_estimate(logw, xv, dtype=torch.float64):
    """[3]: the weighted mean position and the heading of the heaviest
    particle (the first, on ties), computed in ``dtype``."""
    w = torch.softmax(logw.to(dtype), 0)
    xy = (xv[:2].to(dtype) * w).sum(1)
    return torch.cat([xy, xv[2, torch.argmax(logw)].reshape(1).to(
        dtype)])
