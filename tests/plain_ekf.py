"""Plain reference of EKF-SLAM: the dense joint extended Kalman filter
over the pose and a fixed capacity of landmark slots,

    x = [x, y, theta, lm0x, lm0y, lm1x, ...] [3 + 2L],  P [3 + 2L, 3 + 2L],
    n live slots (slots >= n hold zeros), table [n_map] landmark id -> slot,

one superstep at a time: each control tick's bicycle predict and, with
the heading known, the scalar IMU-heading observe; then chi-square-gated
nearest-neighbour association, one stacked batch update of the matched
observations, and the new features added one after another.

Written from the algorithm (Thrun, Burgard and Fox, *Probabilistic
Robotics*, ch. 10, EKF-SLAM with unknown correspondence) and the
conventions of matzipan/slam's ``src/backend/algorithms/ekfslam.cpp``:
the bicycle model with heading rate V sin(G) / wheelbase; a heading
observation with variance sigmaT^2; association by the least NIS +
log det S among the landmarks whose NIS is under ``GATE_REJECT``, and a
new feature iff every live landmark's NIS exceeds ``GATE_AUGMENT``;
range-bearing observations, the bearing wrapped to [-pi, pi). It runs in
any dtype: the check runs it in float64; a control in float32 (with or
without TF32) or bfloat16. Linear algebra that torch lacks below float32
(the Cholesky, the solves) runs in float32 and is rounded back.

How ``slam_tpu_torch`` departs from it, each exact in exact arithmetic
but for the last:

- the block form (``parallel/ekf.py``): P kept as P00, P0m, Pmm, every
  product with H taken as gathers of the observed columns;
- the deferred form: each tick's heading term -(1/s) c_m c_m' on Pmm
  waits in a column of ``hk`` and is subtracted with the update's own
  term in one pass (stored Pmm = true Pmm + hk hk');
- the closed-form batch augment (``models.ekf.new_block``), which equals
  adding the features one after another;
- unmatched observations kept as zero rows of H, so the update's shapes
  are fixed;
- a jitter of 1e-6 trace(S) / 2K on the diagonal of S, 2K the stacked
  rows (matched or not), which moves the update by about 1e-6 of its
  size relative to S's diagonal.

Imports torch and math only; nothing of the program. The benchmark's
copy is ``benchmark/reference/ekf.py``.
"""

from __future__ import annotations

import math

import torch

LOW = (torch.bfloat16, torch.float16)


def wrap(a):
    """Angle(s) to [-pi, pi)."""
    return torch.remainder(a + math.pi, 2 * math.pi) - math.pi


def _lin(t):
    """``t`` in a dtype torch's linear algebra takes."""
    return t.float() if t.dtype in LOW else t


def _scalar(v, like):
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def init(capacity: int, n_map: int, dtype=torch.float64, device="cpu"):
    """The start: zero pose, zero covariance, no landmark, an empty
    table: (x, P, n, table)."""
    N = 3 + 2 * capacity
    return (torch.zeros(N, dtype=dtype, device=device),
            torch.zeros((N, N), dtype=dtype, device=device), 0,
            torch.full((n_map,), -1, dtype=torch.int64, device=device))


def predict(x, P, v, g, Q, wheelbase: float, dt: float):
    """One control tick of the bicycle model: x' = f(x, (v, g)),
    P' = G P G' + Gu Q Gu', G the identity but for the pose block Gv.
    ``Q`` [2, 2] the control noise. Returns (x', P'), new tensors."""
    v, g = _scalar(v, x), _scalar(g, x)
    th = x[2]
    s, c = torch.sin(g + th), torch.cos(g + th)
    one, zero = torch.ones_like(th), torch.zeros_like(th)
    Gv = torch.stack([torch.stack([one, zero, -v * dt * s]),
                      torch.stack([zero, one, v * dt * c]),
                      torch.stack([zero, zero, one])])
    Gu = torch.stack([
        torch.stack([dt * c, -v * dt * s]),
        torch.stack([dt * s, v * dt * c]),
        torch.stack([dt * torch.sin(g) / wheelbase,
                     v * dt * torch.cos(g) / wheelbase])])
    x = x.clone()
    x[0] = x[0] + v * dt * c
    x[1] = x[1] + v * dt * s
    x[2] = wrap(th + v * dt * torch.sin(g) / wheelbase)
    # G P G' with G = blockdiag(Gv, I): the pose rows, then the pose
    # columns, of P.
    P = P.clone()
    P[:3, :] = Gv @ P[:3, :]
    P[:, :3] = P[:, :3] @ Gv.T
    P[:3, :3] = P[:3, :3] + Gu @ Q.to(P.dtype) @ Gu.T
    return x, P


def observe_heading(x, P, phi, sigma: float):
    """The heading observed as ``phi`` with variance sigma^2, H = e_2:
    W = P H' / s, s = H P H' + sigma^2; x' = x + W wrap(phi - theta);
    P' = (I - W H) P (I - W H)' + sigma^2 W W' (Joseph form)."""
    N = x.shape[0]
    H = torch.zeros(N, dtype=x.dtype, device=x.device)
    H[2] = 1.0
    r = sigma * sigma
    PHt = P @ H
    s = H @ PHt + r
    W = PHt / s
    x = x + W * wrap(_scalar(phi, x) - x[2])
    x[2] = wrap(x[2])
    A = P - torch.outer(W, H @ P)                  # (I - W H) P
    P = A - torch.outer(A @ H, W) + r * torch.outer(W, W)
    return x, P


def _blocks(x, P, n: int):
    """Pose, the first ``n`` landmarks [n, 2], P00 [3, 3], P0j [n, 3, 2]
    and Pjj [n, 2, 2]."""
    idx = 3 + torch.arange(2 * n, device=x.device).reshape(n, 2)
    P0j = P[:3][:, idx].permute(1, 0, 2)
    Pjj = P[idx[:, :, None], idx[:, None, :]]
    return x[:3], x[3:3 + 2 * n].reshape(n, 2), P[:3, :3], P0j, Pjj


def observe_model(pose, lm):
    """Predicted (range, bearing) [..., 2] of landmarks ``lm`` [..., 2]
    from ``pose``, with Hv [..., 2, 3] and Hf [..., 2, 2], the Jacobians
    in the pose and in the landmark."""
    dx, dy = lm[..., 0] - pose[0], lm[..., 1] - pose[1]
    d2 = dx * dx + dy * dy
    d = torch.sqrt(d2)
    zp = torch.stack([d, wrap(torch.atan2(dy, dx) - pose[2])], -1)
    zero = torch.zeros_like(d)
    Hf = torch.stack([torch.stack([dx / d, dy / d], -1),
                      torch.stack([-dy / d2, dx / d2], -1)], -2)
    Hv = torch.cat([-Hf, torch.stack([zero, -torch.ones_like(d)], -1)
                    [..., None]], -1)
    return zp, Hv, Hf


def innovation(z, zp):
    """z - zp with the bearing wrapped."""
    v = z - zp
    return torch.stack([v[..., 0], wrap(v[..., 1])], -1)


def innovation_stats(x, P, n: int, z, R):
    """NIS and NIS + log det S of every observation against every live
    landmark: ([K, n], [K, n]), S_j = H_j P H_j' + R with H_j the pose
    block Hv and the landmark block Hf at slot j."""
    pose, lm, P00, P0j, Pjj = _blocks(x, P, n)
    zp, Hv, Hf = observe_model(pose, lm)
    S = (Hv @ P00 @ Hv.transpose(-1, -2)
         + Hv @ P0j @ Hf.transpose(-1, -2)
         + Hf @ P0j.transpose(-1, -2) @ Hv.transpose(-1, -2)
         + Hf @ Pjj @ Hf.transpose(-1, -2) + R.to(P.dtype))
    v = innovation(z[:, None, :].to(x.dtype), zp[None])          # [K, n, 2]
    Sl = _lin(S)
    sol = torch.linalg.solve(Sl[None].expand(v.shape[0], -1, -1, -1),
                             _lin(v)[..., None])[..., 0]
    nis = (_lin(v) * sol).sum(-1)
    nd = nis + torch.logdet(Sl)[None]
    return nis.to(x.dtype), nd.to(x.dtype)


def associate(x, P, n: int, z, zmask, R, gate_reject: float,
              gate_augment: float, margin: float = 0.0):
    """Gated nearest neighbour: (assoc [K] slot or -1, is_new [K] bool,
    tie [K] bool). An observation matches the live landmark of least
    NIS + log det S among those with NIS < ``gate_reject`` (-1 if there
    is none); it is new iff every live landmark's NIS exceeds
    ``gate_augment``. ``tie`` marks the observations whose decision a
    relative change of ``margin`` in one statistic could flip: the two
    least gated NIS + log det S, an NIS at the reject gate, or the least
    NIS at the augment gate."""
    K = z.shape[0]
    dev = z.device
    assoc = torch.full((K,), -1, dtype=torch.int64, device=dev)
    is_new = zmask.clone().bool()
    tie = torch.zeros(K, dtype=torch.bool, device=dev)
    if n == 0:
        return assoc, is_new, tie
    nis, nd = (t.double() for t in innovation_stats(x, P, n, z, R))

    def near(a, b):
        b = torch.as_tensor(b, dtype=a.dtype, device=a.device)
        return (a - b).abs() <= margin * torch.clamp(
            torch.maximum(a.abs(), b.abs()), min=1.0)
    gated = torch.where(nis < gate_reject, nd, math.inf)
    best = torch.argmin(gated, 1)
    has = torch.isfinite(gated.min(1).values)
    assoc = torch.where(zmask & has, best, -1)
    is_new = zmask & (nis.min(1).values > gate_augment)
    top2 = torch.topk(gated, min(2, n), 1, largest=False).values
    tie = near(nis, gate_reject).any(1) | near(nis.min(1).values,
                                               gate_augment)
    if n > 1:
        tie |= torch.isfinite(top2[:, 1]) & near(top2[:, 0], top2[:, 1])
    return assoc, is_new, tie & zmask


def known_association(table, ids, zmask):
    """Association through the id table: (assoc, is_new), an unseen id
    new."""
    slot = table[ids.long().clamp(0, table.shape[0] - 1)]
    return (torch.where(zmask & (slot >= 0), slot, -1),
            zmask & (slot < 0))


def batch_update(x, P, z, assoc, R):
    """One stacked EKF update of the matched observations: H [2M, N]
    (per observation its pose block Hv and, at its landmark's two
    columns, Hf), S = H P H' + blockdiag(R), Kg = P H' S^-1,
    x' = x + Kg v, P' = P - Kg S Kg'. Returns (x', P')."""
    m = torch.nonzero(assoc >= 0).flatten()
    if m.numel() == 0:
        return x.clone(), P.clone()
    M, N = m.numel(), x.shape[0]
    slot = assoc[m].long()
    zp, Hv, Hf = observe_model(x[:3], x[3:].reshape(-1, 2)[slot])
    H = torch.zeros((M, 2, N), dtype=x.dtype, device=x.device)
    H[:, :, :3] = Hv
    cols = 3 + 2 * slot
    ar = torch.arange(M, device=x.device)
    H[ar, :, cols] = Hf[:, :, 0]
    H[ar, :, cols + 1] = Hf[:, :, 1]
    H = H.reshape(2 * M, N)
    v = innovation(z[m].to(x.dtype), zp).reshape(2 * M)
    PHt = P @ H.T
    S = H @ PHt + torch.block_diag(*[R.to(P.dtype)] * M)
    L = torch.linalg.cholesky(_lin(S))
    # Kg = PHt S^-1 = ((L L')^-1 PHt')'.
    Kg = torch.cholesky_solve(_lin(PHt).T, L).T.to(x.dtype)
    x = x + Kg @ v
    x[2] = wrap(x[2])
    P = P - Kg @ PHt.T
    return x, P


def augment(x, P, n: int, table, z, ids, is_new, R):
    """The new features added one after another, each at the next slot
    while the state has room: x_f = (x, y) + r (cos, sin)(theta + b);
    its rows of P are Gv P[:3, :], its own block Gv P00 Gv' +
    Gz R Gz'; ``table[id]`` takes the slot. Returns (x, P, n, table)."""
    x, P, table = x.clone(), P.clone(), table.clone()
    capacity = (x.shape[0] - 3) // 2
    Rl = R.to(P.dtype)
    for k in torch.nonzero(is_new).flatten().tolist():
        if n >= capacity:
            break
        i = 3 + 2 * n
        r, b = z[k, 0].to(x.dtype), z[k, 1].to(x.dtype)
        ang = x[2] + b
        s, c = torch.sin(ang), torch.cos(ang)
        one, zero = torch.ones_like(r), torch.zeros_like(r)
        Gv = torch.stack([torch.stack([one, zero, -r * s]),
                          torch.stack([zero, one, r * c])])
        Gz = torch.stack([torch.stack([c, -r * s]), torch.stack([s, r * c])])
        x[i] = x[0] + r * c
        x[i + 1] = x[1] + r * s
        rows = Gv @ P[:3, :]
        P[i:i + 2, :] = rows
        P[:, i:i + 2] = rows.T
        P[i:i + 2, i:i + 2] = Gv @ P[:3, :3] @ Gv.T + Gz @ Rl @ Gz.T
        if 0 <= int(ids[k]) < table.shape[0]:
            table[int(ids[k])] = n
        n += 1
    return x, P, n, table


def matrices(cfg: dict, dtype=torch.float64, device="cpu"):
    """(Q, R) of a configuration's ``sigmaV``, ``sigmaG``, ``sigmaR``,
    ``sigmaB``, diagonal [2, 2]."""
    def diag(a, b):
        return torch.diag(torch.tensor([a * a, b * b], dtype=dtype,
                                       device=device))
    return diag(cfg["sigmaV"], cfg["sigmaG"]), diag(cfg["sigmaR"],
                                                    cfg["sigmaB"])


def superstep(x, P, n: int, table, ticks, z, ids, zmask, cfg: dict,
              decided=None, margin: float = 0.0):
    """One superstep from (x, P, n, table): for each tick (v, g, phi) of
    ``ticks`` the predict and, with ``SWITCH_HEADING_KNOWN``, the heading
    observe; then association (the table with
    ``SWITCH_ASSOCIATION_KNOWN``, else gated nearest neighbour), the
    batch update and the augment. ``decided`` = (assoc, is_new): an
    association to update with in place of the one computed (the
    computed one is still returned). Returns a dict: x, P, n, table,
    and the computed assoc, is_new and tie."""
    Q, R = matrices(cfg, x.dtype, x.device)
    for v, g, phi in ticks:
        x, P = predict(x, P, v, g, Q, cfg["WHEELBASE"], cfg["DT_CONTROLS"])
        if cfg["SWITCH_HEADING_KNOWN"]:
            x, P = observe_heading(x, P, phi, cfg["sigmaT"])
    zmask = zmask.bool()
    if cfg["SWITCH_ASSOCIATION_KNOWN"]:
        assoc, is_new = known_association(table, ids, zmask)
        tie = torch.zeros_like(zmask)
    else:
        assoc, is_new, tie = associate(x, P, n, z, zmask, R,
                                       cfg["GATE_REJECT"],
                                       cfg["GATE_AUGMENT"], margin)
    use_assoc, use_new = (assoc, is_new) if decided is None else decided
    x, P = batch_update(x, P, z, use_assoc, R)
    x, P, n, table = augment(x, P, n, table, z, ids, use_new, R)
    return dict(x=x, P=P, n=n, table=table, assoc=assoc, is_new=is_new,
                tie=tie)
