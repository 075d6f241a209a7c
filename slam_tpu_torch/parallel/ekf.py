"""Landmark-sharded EKF-SLAM (counterpart: slam_tpu.parallel.ekf).

At 10k landmarks the joint covariance is [20003, 20003] float32, 1.6 GB,
and the dense EKF's heading observe alone (two N^3 products per tick)
cannot run. This estimator keeps the covariance in blocks,

    P = [ P00  P0m ]     P00 [3, 3]     pose block        (every rank)
        [ P0m' Pmm ]     P0m [3, 2L]    pose-landmark     (every rank)
                         Pmm [2L, 2L]   landmark-landmark (rows split)

and touches Pmm once per observe: the per-tick predict and heading
observe change P00 and P0m only, their rank-1 Pmm terms wait in ``hk``,
and the batch update subtracts them together with its own rank-2K term
in one in-place product over Pmm.

Pmm's rows split over a 1-D mesh on the landmark axis ``LM_AXIS``
(``make_mesh(S, axis="l")``, one rank per device): rank r owns rows
r 2L/S to (r + 1) 2L/S, and the bodies are written against the owned
rows (``row_lo``, ``rows``). Per observe, four collectives join the
shards, where the JAX package has its ``psum`` and ``all_gather``:

- the diagonal 2x2 blocks of Pmm, all-gathered ([L, 2, 2]);
- Pmm's observed rows, all-reduced ([2K, 2L]; each row has one owner);
- S's landmark contraction, all-reduced ([2K, 2K]);
- the gain's landmark rows, all-gathered ([2L, 2K]).

With no mesh the one card owns every row and the collectives are the
identity; a mesh of one rank runs the same operations through
collectives over a group of one, with the same result bit for bit.

A predict tick is one launch of E1 (``ops.kernels.ekf``) on the card
and its plain twin, ``_predict_local_plain``, elsewhere.

An update is four segments of device work (``_Segments``) with the
association's decision, an eager call, between the first two. On the
card with no mesh the segments are replayed from CUDA graphs
(``_UpdateGraphs``), the same kernels on the same operands; on a mesh
(whose collectives a graph would hold) and off the card they run
eagerly. ``update_graphs`` counts the updates replayed, the captures and
the updates run eagerly.

An update records four spans beneath the runner's ``filter.update``
(``slam_tpu_torch.spans``): ``ekf.associate``, ``ekf.gain``, ``ekf.pmm``
(the one pass over Pmm) and ``ekf.augment``. ``pmm_passes.count``
counts every full pass over Pmm: the update's product and each heading
term that finds no free column in ``hk``.

Writes the JAX package drops (``mode="drop"``) are additions here:
slots >= n hold exact zeros in x, P0m and Pmm, and every update keeps
them zero, so adding a new feature's values into them is exact, and a
masked observation adds zeros.
"""

from __future__ import annotations

import collections
import contextlib
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from slam_tpu_torch.config import SlamConfig
from slam_tpu_torch.device import default_device
from slam_tpu_torch.geometry import wrap_angle
from slam_tpu_torch.models import rbpf
from slam_tpu_torch.models.ekf import (
    feature_pose_jacobian,
    full_f32,
    gated_nearest,
    innovation_stats,
    known_association,
    motion_jacobians,
    new_block,
    noise_matrices,
)
from slam_tpu_torch.ops.jacobians import compute_jacobians
from slam_tpu_torch.ops.kalman import (
    add_feature_init,
    cholesky_lower,
    innovation,
    solve_lower,
)
from slam_tpu_torch.ops.kernels.ekf import ekf_predict_tick
from slam_tpu_torch.parallel.mesh import (
    all_gather_rows,
    axis_size,
    gather_state,
    mesh_device,
    psum,
)
from slam_tpu_torch.spans import span

LM_AXIS = "l"

# Full passes over Pmm (read and written whole) since the process began.
pmm_passes = SimpleNamespace(count=0)
# Updates since the process began: served by a replay of CUDA graphs
# (``replays``, each capture's own call included), captures of a new
# key (``captures``), and updates run eagerly (``eager``: off the card,
# on a mesh, and a layout's first call on the card, its warm-up).
update_graphs = SimpleNamespace(replays=0, captures=0, eager=0)


class ShardedEKFState(NamedTuple):
    """Joint EKF state with the covariance in blocks.

    ``x``: [3 + 2L] joint mean. ``P00``: [3, 3]. ``P0m``: [3, 2L].
    ``Pmm``: [rows, 2L], the rows this rank owns (all 2L on one card).
    ``n``: [] int32 live landmark count. ``da_table``: [n_map] id ->
    slot.

    ``hk`` [2L, D] / ``hk_n``: the deferred heading terms. Each scalar
    heading observe subtracts (1/s) c c' from the joint covariance; its
    Pmm block feeds only the next observe (predict reads P00 and P0m),
    so the scaled columns u_t = c_m / sqrt(s_t) collect here and fold
    into Pmm once per observe: the true Pmm is stored Pmm - hk hk'.
    ``hk_n``, the number of columns used, is a host integer: it counts
    predicts since the last observe, known without reading the card.
    """
    x: torch.Tensor
    P00: torch.Tensor
    P0m: torch.Tensor
    Pmm: torch.Tensor
    n: torch.Tensor
    da_table: torch.Tensor
    hk: torch.Tensor
    hk_n: int

    @property
    def capacity(self) -> int:
        return (self.x.shape[-1] - 3) // 2

    @property
    def pose(self) -> torch.Tensor:
        return self.x[:3]


SHARDED_FIELDS = ShardedEKFState._fields


def sharded_ekf_init(capacity: int, n_map_landmarks: int,
                     dtype=torch.float32, n_defer: int = 16,
                     device=None, rows: int | None = None
                     ) -> ShardedEKFState:
    """Zero pose, zero covariance, empty map, ``n_defer`` columns for
    deferred heading terms; on ``device`` (none named: the card).
    ``rows``: Pmm's rows on this rank (all 2L by default)."""
    device = default_device(device)
    L2 = 2 * capacity
    f32 = dict(dtype=dtype, device=device)
    return ShardedEKFState(
        x=torch.zeros(3 + L2, **f32),
        P00=torch.zeros((3, 3), **f32),
        P0m=torch.zeros((3, L2), **f32),
        Pmm=torch.zeros((L2 if rows is None else rows, L2), **f32),
        n=torch.zeros((), dtype=torch.int32, device=device),
        da_table=torch.full((n_map_landmarks,), -1, dtype=torch.int32,
                            device=device),
        hk=torch.zeros((L2, n_defer), **f32),
        hk_n=0,
    )


def state_specs(axis: str = LM_AXIS) -> ShardedEKFState:
    """Specs of the fields (``parallel.mesh``): Pmm's rows split over
    ``axis``, every other field on every rank."""
    return ShardedEKFState(x=(), P00=(), P0m=(), Pmm=(axis, None), n=(),
                           da_table=(), hk=(), hk_n=())


class Shard(NamedTuple):
    """A rank's place on the landmark axis: Pmm's rows ``row_lo`` to
    ``row_lo + rows``, and the group of the collectives (None: one card,
    no process group, and the collectives are the identity)."""
    row_lo: int
    rows: int
    group: object = None


def sharded_state_from_numpy(arrays, device=None) -> ShardedEKFState:
    """ShardedEKFState from a mapping of the JAX package's field names
    to arrays (``hk_n`` a number); ``device`` as in
    ``sharded_ekf_init``."""
    device = default_device(device)

    def tensor(f):
        a = np.asarray(arrays[f])
        dtype = np.int32 if f in ("n", "da_table") else np.float32
        return torch.from_numpy(np.array(a, dtype=dtype, copy=True)
                                ).to(device)
    return ShardedEKFState(
        **{f: tensor(f) for f in SHARDED_FIELDS if f != "hk_n"},
        hk_n=int(arrays["hk_n"]))


def sharded_state_to_numpy(state: ShardedEKFState) -> dict:
    """The inverse of ``sharded_state_from_numpy``."""
    out = {f: getattr(state, f).detach().cpu().numpy()
           for f in SHARDED_FIELDS if f != "hk_n"}
    out["hk_n"] = state.hk_n
    return out


# ---------------------------------------------------------------------------
# Shard-local step bodies
# ---------------------------------------------------------------------------

def _predict_local(state: ShardedEKFState, v, g, Q, wheelbase, dt, phi,
                   sigma_phi, heading_known: bool, shard: Shard
                   ) -> ShardedEKFState:
    """One predict tick: E1 (``ops.kernels.ekf``, one launch) on the
    card, the plain twin ``_predict_local_plain`` elsewhere. On the card
    v, g and phi are 0-d float32 tensors on the state's device; a heading
    term that finds no free column in ``hk`` goes into Pmm here, as in
    the twin."""
    if not state.x.is_cuda:
        return _predict_local_plain(state, v, g, Q, wheelbase, dt, phi,
                                    sigma_phi, heading_known, shard)
    x, P00, P0m, u = ekf_predict_tick(
        state.x, state.P00, state.P0m, state.hk, state.hk_n, v, g, phi, Q,
        wheelbase=wheelbase, dt=dt, sigma_phi=sigma_phi,
        heading_known=heading_known)
    state = state._replace(x=x, P00=P00, P0m=P0m)
    if not heading_known:
        return state
    if u is None:
        return state._replace(hk_n=state.hk_n + 1)
    lo = shard.row_lo
    pmm_passes.count += 1
    state.Pmm.addr_(u[lo:lo + shard.rows], u, alpha=-1.0)
    return state


def _predict_local_plain(state: ShardedEKFState, v, g, Q, wheelbase, dt,
                         phi, sigma_phi, heading_known: bool, shard: Shard
                         ) -> ShardedEKFState:
    """Bicycle predict (pose block and cross rows only; Pmm untouched),
    then the optional scalar heading Joseph update, whose Pmm term is a
    rank-1 outer product, deferred into ``hk``. The plain twin of E1."""
    x = state.x
    v = torch.as_tensor(v, dtype=x.dtype, device=x.device)
    g = torch.as_tensor(g, dtype=x.dtype, device=x.device)
    Gv, Gu, (dx, dy, heading) = motion_jacobians(x[2], v, g, wheelbase, dt)
    P00 = (Gv @ state.P00) @ Gv.T + (Gu @ Q) @ Gu.T
    P0m = Gv @ state.P0m
    x = torch.cat([torch.stack([x[0] + dx, x[1] + dy, heading]), x[3:]])
    if not heading_known:
        return state._replace(x=x, P00=P00, P0m=P0m)

    # Scalar heading observe on the blocks. With c = P[:, 2] and
    # W = c / s the Joseph form collapses (exactly, for a scalar
    # observation) to P' = P - W c' - c W' + s W W'; its Pmm block is
    # -(1/s) c_m c_m', deferred.
    s_inn = P00[2, 2] + sigma_phi * sigma_phi
    cp, cm = P00[:, 2], P0m[2, :]
    Wp, Wm = cp / s_inn, cm / s_inn
    vh = wrap_angle(phi - x[2])
    x = x + torch.cat([Wp, Wm]) * vh
    x[2] = wrap_angle(x[2])
    P00 = (P00 - torch.outer(Wp, cp) - torch.outer(cp, Wp)
           + s_inn * torch.outer(Wp, Wp))
    P0m = (P0m - torch.outer(Wp, cm) - torch.outer(cp, Wm)
           + s_inn * torch.outer(Wp, Wm))
    u = cm / torch.sqrt(s_inn)
    state = state._replace(x=x, P00=P00, P0m=P0m)
    if state.hk_n < state.hk.shape[1]:
        state.hk[:, state.hk_n] = u
        return state._replace(hk_n=state.hk_n + 1)
    # No free column (more predicts per observe than n_defer): this
    # tick's term goes into the owned rows of Pmm now.
    lo = shard.row_lo
    pmm_passes.count += 1
    state.Pmm.addr_(u[lo:lo + shard.rows], u, alpha=-1.0)
    return state


def _diag_blocks_local(Pmm_local, row_lo: int):
    """[rows / 2, 2, 2] diagonal blocks owned by this shard: local row r
    of the slab is global row row_lo + r."""
    rows = Pmm_local.shape[0]
    d = torch.diagonal(Pmm_local, offset=row_lo)             # P[i, i]
    d1 = torch.diagonal(Pmm_local, offset=row_lo + 1)[:rows - 1]
    p00, p11, p01 = d[0::2], d[1::2], d1[0::2]
    return torch.stack([torch.stack([p00, p01], -1),
                        torch.stack([p01, p11], -1)], -2)


def _owned_rows(Pmm_local, idx, row_lo: int):
    """Rows ``idx`` (global) of Pmm that this shard owns, zero for the
    others: [len(idx), 2L]. Summed over shards, the rows themselves."""
    rows = Pmm_local.shape[0]
    local = idx - row_lo
    own = (local >= 0) & (local < rows)
    got = Pmm_local[torch.clamp(local, 0, rows - 1)]
    return torch.where(own[:, None], got, 0.0)


def _associate_local(state: ShardedEKFState, z, zmask, Re,
                     association_known: bool, shard: Shard):
    """The association's device work: (Pjj, stats). Pjj [L, 2, 2], the
    diagonal blocks of the true Pmm; stats (nis, nd) [K, L], the gated
    statistics, or None where the association is known."""
    L = state.capacity
    # Deferred heading terms: true Pmm = stored Pmm - hk hk'. The cheap
    # reads below take the low-rank correction; the subtraction itself
    # rides the batch update's one pass over Pmm.
    hk = state.hk[:, :state.hk_n]
    # The diagonal blocks: each shard's own, gathered.
    Pjj = all_gather_rows(_diag_blocks_local(state.Pmm, shard.row_lo),
                          shard.group)
    hk_blk = hk.reshape(L, 2, hk.shape[1])
    Pjj = Pjj - torch.einsum("lad,lbd->lab", hk_blk, hk_blk)
    if association_known:
        return Pjj, None
    lm = state.x[3:].reshape(L, 2)
    valid = torch.arange(L, device=state.x.device) < state.n
    return Pjj, innovation_stats(state.pose, lm, valid, state.P00,
                                 state.P0m.T.reshape(L, 2, 3), Pjj, z,
                                 zmask, Re)


def _decide(da_table, stats, ids, zmask, gate_reject: float,
            gate_augment: float):
    """The association's decision, (assoc, is_new): the table's lookup,
    or the module's ``gated_nearest`` (looked up at each call) over
    ``stats``. Always an eager call, so that a stand-in sees every
    update."""
    if stats is None:
        return known_association(da_table, ids, zmask)
    return gated_nearest(*stats, zmask, gate_reject, gate_augment)


def _gain_local(state: ShardedEKFState, z, Pjj, assoc, R, shard: Shard):
    """The batch update's gain for the association ``assoc``: the new
    (x, P00, P0m) and W1_m [2L, 2K], whose outer product the pass over
    Pmm subtracts."""
    K = z.shape[0]
    L = state.capacity
    N2 = 2 * L
    dev = state.x.device
    row_lo, rows = shard.row_lo, shard.rows
    hk = state.hk[:, :state.hk_n]
    lm = state.x[3:].reshape(L, 2)

    matched = assoc >= 0
    slot = torch.where(matched, assoc, 0).long()
    zp, Hv, Hf, _ = compute_jacobians(state.pose, lm[slot], Pjj[slot], R)
    Hv = torch.where(matched[:, None, None], Hv, 0.0)
    Hf = torch.where(matched[:, None, None], Hf, 0.0)
    Hp = Hv.reshape(2 * K, 3)                                # [2K, 3]
    # H = [Hp | Hm], where Hm's row pair k holds Hf_k at the columns
    # gcol[2k : 2k + 2] of the matched landmark. Products with Hm are
    # gathers of those columns (two nonzeros a row: the same sums).
    gcol = (2 * slot[:, None] + torch.arange(2, device=dev)).reshape(-1)

    v = torch.where(matched[:, None], innovation(z, zp), 0.0).reshape(2 * K)

    # PHt pose rows [3, 2K]: P00 Hp' + P0m Hm'.
    P0m_obs = state.P0m[:, gcol].reshape(3, K, 2)
    PHt_p = state.P00 @ Hp.T + torch.einsum(
        "ckb,kab->cka", P0m_obs, Hf).reshape(3, 2 * K)
    # PHt landmark rows: Pm0 Hp' + Pmm Hm'. By symmetry Pmm Hm' needs
    # only Pmm's observed rows, with the deferred correction; each row
    # has one owner, so their sum over the shards is exact.
    obs_rows = psum(_owned_rows(state.Pmm, gcol, row_lo), shard.group)
    obs_rows = obs_rows - hk[gcol] @ hk.T                    # [2K, 2L]
    HmP = torch.einsum("kab,kbn->kan", Hf, obs_rows.reshape(K, 2, N2)
                       ).reshape(2 * K, N2)
    PHt_m_loc = (state.P0m[:, row_lo:row_lo + rows].T @ Hp.T
                 + HmP[:, row_lo:row_lo + rows].T)           # [rows, 2K]

    # S = H P H' + R; the landmark contraction is a sum over shards.
    HmPHt = psum(torch.einsum(
        "kab,kbc->kac", Hf,
        _owned_rows(PHt_m_loc, gcol, row_lo).reshape(K, 2, 2 * K)),
        shard.group)
    S = Hp @ PHt_p + HmPHt.reshape(2 * K, 2 * K)
    RR = torch.kron(torch.eye(K, dtype=S.dtype, device=dev), R)
    S = 0.5 * (S + S.T) + RR
    S = S + 1e-6 * torch.trace(S) / (2 * K) * torch.eye(
        2 * K, dtype=S.dtype, device=dev)

    Lc = cholesky_lower(S)
    # W1 = PHt L^-T ; P -= W1 W1' ; x += PHt S^-1 v.
    W1_p = solve_lower(Lc, PHt_p.T).T                        # [3, 2K]
    W1_m_loc = solve_lower(Lc, PHt_m_loc.T).T                # [rows, 2K]
    W1_m = all_gather_rows(W1_m_loc, shard.group)            # [2L, 2K]
    sv = solve_lower(Lc, v)
    x = state.x + torch.cat([W1_p @ sv, W1_m @ sv])
    x[2] = wrap_angle(x[2])

    P00 = state.P00 - W1_p @ W1_p.T
    P0m = state.P0m - W1_p @ W1_m.T
    return x, P00, P0m, W1_m


def _pmm_local(state: ShardedEKFState, x, P00, P0m, W1_m, shard: Shard
               ) -> ShardedEKFState:
    """The one pass over Pmm: the batch update and the deferred heading
    terms, Pmm -= [W1_m | hk] [W1_m | hk]', in place; hk emptied."""
    row_lo, rows = shard.row_lo, shard.rows
    W = torch.cat([W1_m, state.hk[:, :state.hk_n]], 1)       # [2L, 2K + D]
    Pmm = state.Pmm.addmm_(W[row_lo:row_lo + rows], W.T, alpha=-1.0)
    return state._replace(x=x, P00=0.5 * (P00 + P00.T), P0m=P0m, Pmm=Pmm,
                          hk=state.hk.zero_(), hk_n=0)


class _Segments:
    """An update's device work in the four segments between which the
    host acts (the decision, the spans, the pass counter), run eagerly:
    the body that every path shares, and that ``_UpdateGraphs``
    captures."""

    def __init__(self, state, z, ids, zmask, R, Re,
                 association_known: bool, shard: Shard):
        self.state, self.z, self.ids, self.zmask = state, z, ids, zmask
        self.R, self.Re, self.shard = R, Re, shard
        self.known = association_known

    def fresh(self) -> tuple:
        """The inputs a call brings anew (a replay copies them):
        x, P00, P0m, n, z, ids, zmask."""
        st = self.state
        return st.x, st.P00, st.P0m, st.n, self.z, self.ids, self.zmask

    def associate(self):
        self.Pjj, stats = _associate_local(self.state, self.z, self.zmask,
                                           self.Re, self.known, self.shard)
        return stats

    def gain(self, assoc, is_new) -> None:
        self.is_new = is_new
        self.gained = _gain_local(self.state, self.z, self.Pjj, assoc,
                                  self.R, self.shard)

    def pmm(self) -> None:
        self.state = _pmm_local(self.state, *self.gained, self.shard)

    def augment(self) -> ShardedEKFState:
        return _augment_local(self.state, self.z, self.ids, self.is_new,
                              self.Re, self.shard)


def _update_phases(seg: _Segments, gate_reject: float, gate_augment: float,
                   steps=None) -> ShardedEKFState:
    """Observe step: associate -> batch update -> augment, each in its
    span, run by ``steps`` (``seg`` itself, or a replay of its capture);
    the decision between the first two always eager, on ``seg``'s
    inputs."""
    steps = seg if steps is None else steps
    with span("ekf.associate"):
        stats = steps.associate()
        assoc, is_new = _decide(seg.state.da_table, stats, seg.ids,
                                seg.zmask, gate_reject, gate_augment)
    with span("ekf.gain"):
        steps.gain(assoc, is_new)
    with span("ekf.pmm"):
        pmm_passes.count += 1
        steps.pmm()
    with span("ekf.augment"):
        return steps.augment()


def _update_local(state: ShardedEKFState, z, ids, zmask, R, Re,
                  gate_reject: float, gate_augment: float,
                  association_known: bool, shard: Shard
                  ) -> ShardedEKFState:
    """Observe step: associate -> batch update -> augment, on the
    blocks. Pmm, hk and the id table are written in place. On a card
    with no mesh (no collective) the segments are replayed from CUDA
    graphs (``_UpdateGraphs``); elsewhere they run eagerly."""
    seg = _Segments(state, z, ids, zmask, R, Re, association_known, shard)
    if state.x.is_cuda and shard.group is None:
        return _GRAPHS.update(seg, gate_reject, gate_augment)
    update_graphs.eager += 1
    return _update_phases(seg, gate_reject, gate_augment)


def _augment_local(state: ShardedEKFState, z, ids, is_new, Re,
                   shard: Shard) -> ShardedEKFState:
    """Batch augment on the blocks. New feature i at slot s_i:
        x[3 + 2s_i : 3 + 2s_i + 2]  = xf_i
        P0m[:, 2s_i : 2s_i + 2]     = P00 Gv_i'
        Pmm rows and columns 2s_i.. = Gv_i P0m, the new-new block
    (the closed form of ``models.ekf.ekf_augment``). Every target holds
    zero before, so the values are added in place; masked observations
    add zeros."""
    K = z.shape[0]
    row_lo, rows = shard.row_lo, shard.rows

    slot, ok = rbpf.new_slots(state, is_new)
    okf = ok.to(state.x.dtype)
    okc = okf[:, None].expand(K, 2).reshape(2 * K)
    cols = (2 * torch.where(ok, slot, 0)[:, None]
            + torch.arange(2, device=z.device)).reshape(-1).long()

    xf, Gz = add_feature_init(state.pose, z)
    Gv = feature_pose_jacobian(state.x[2], z)                # [K, 2, 3]
    x = state.x.index_add(0, 3 + cols, (xf * okf[:, None]).reshape(-1))

    # Cross terms against the existing state: Gv_i [P00 | P0m].
    Bp = torch.einsum("kab,bc->kac", Gv, state.P00).reshape(2 * K, 3)
    Bm = torch.einsum("kab,bn->kan", Gv, state.P0m).reshape(2 * K, -1)
    Bm = Bm * okc[:, None]
    P0m = state.P0m.index_add(1, cols, (Bp * okc[:, None]).T)

    # New rows owned here: the cross terms, plus the new-new block at
    # the new columns (Bm is zero there: P0m was).
    NN = new_block(Gv, Gz, state.P00, Re) * (okc[:, None] * okc[None, :])
    new_rows = Bm.index_add(1, cols, NN)                     # [2K, 2L]
    local = cols - row_lo
    own = (local >= 0) & (local < rows)
    state.Pmm.index_add_(0, torch.clamp(local, 0, rows - 1),
                         new_rows * own[:, None])
    # New columns on every owned row; at the new rows Bm adds zero.
    state.Pmm.index_add_(1, cols, Bm[:, row_lo:row_lo + rows].T)

    rbpf.set_table(state.da_table, ids, slot, ok)
    return state._replace(x=x, P0m=P0m,
                          n=state.n + torch.sum(ok, dtype=torch.int32))


class _Captured(NamedTuple):
    """One layout's four CUDA graphs and the tensors they own: ``inputs``
    (x, P00, P0m, n, z, ids, zmask) and ``decided`` (assoc, is_new), the
    static copies of a call's fresh inputs; ``stats`` and ``outputs``
    (x, P00, P0m, n), what the host reads; ``keep``, the other segment
    outputs a later graph reads."""
    graphs: list
    inputs: list
    decided: tuple
    stats: tuple | None
    outputs: tuple
    keep: tuple


class _Replay:
    """A call's four segments replayed from ``_Captured``: its fresh
    inputs copied into the static ones first, and the state returned
    holding copies of the graphs' outputs (a later replay overwrites
    them)."""

    def __init__(self, cap: _Captured, seg: _Segments):
        self.cap, self.seg = cap, seg

    def associate(self):
        for dst, src in zip(self.cap.inputs, self.seg.fresh()):
            dst.copy_(src)
        self.cap.graphs[0].replay()
        return self.cap.stats

    def gain(self, assoc, is_new) -> None:
        self.cap.decided[0].copy_(assoc)
        self.cap.decided[1].copy_(is_new)
        self.cap.graphs[1].replay()

    def pmm(self) -> None:
        self.cap.graphs[2].replay()

    def augment(self) -> ShardedEKFState:
        self.cap.graphs[3].replay()
        x, P00, P0m, n = (t.clone() for t in self.cap.outputs)
        return self.seg.state._replace(x=x, P00=P00, P0m=P0m, n=n, hk_n=0)


class _UpdateGraphs:
    """The update's segments as CUDA graphs (``torch.cuda.CUDAGraph``),
    keyed on the layout of the call (shapes, dtypes, ``hk_n``, the arm)
    and the addresses of what the graphs read or write in place: Pmm,
    hk, the id table, R and Re. At most ``KEYS`` captures are kept, the
    least recently used dropped. A capture holds no reference to a
    state's tensors (a state let go frees its Pmm, 1.6 GB at 10k
    landmarks); a tensor with the key's address and layout is the one
    the graphs address. A layout's first call in the process runs
    eagerly on the side stream the captures use, as their warm-up; a
    new key of a warm layout captures and replays at once."""

    KEYS = 2

    def __init__(self):
        self.captured = collections.OrderedDict()
        self.warm = set()
        self.streams = {}

    def update(self, seg: _Segments, gate_reject: float,
               gate_augment: float) -> ShardedEKFState:
        st = seg.state
        in_place = (st.Pmm, st.hk, st.da_table, seg.R, seg.Re)
        layout = (st.x.device, st.hk_n, seg.known, seg.shard,
                  *((t.shape, t.dtype) for t in seg.fresh()),
                  *((t.shape, t.stride(), t.dtype) for t in in_place))
        key = (*layout, *(t.data_ptr() for t in in_place))
        dev = st.x.device
        with torch.cuda.device(dev):
            cap = self.captured.get(key)
            if cap is None and layout not in self.warm:
                update_graphs.eager += 1
                with self._side(dev):
                    out = _update_phases(seg, gate_reject, gate_augment)
                self.warm.add(layout)
                return out
            if cap is None:
                cap = self.captured[key] = self._capture(seg, dev)
                if len(self.captured) > self.KEYS:
                    self.captured.popitem(last=False)
            else:
                self.captured.move_to_end(key)
            update_graphs.replays += 1
            return _update_phases(seg, gate_reject, gate_augment,
                                  _Replay(cap, seg))

    @contextlib.contextmanager
    def _side(self, dev):
        """Work on the side stream of ``dev``, ordered after the current
        stream's and before what the current stream does next."""
        side = self.streams.get(dev)
        if side is None:
            side = self.streams[dev] = torch.cuda.Stream(dev)
        cur = torch.cuda.current_stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            yield
        cur.wait_stream(side)

    def _capture(self, seg: _Segments, dev) -> _Captured:
        """The four segments of ``seg``'s layout captured on the side
        stream into one memory pool (they replay in capture order), on
        static copies of its fresh inputs. Nothing runs."""
        update_graphs.captures += 1
        inputs = [torch.empty_like(t) for t in seg.fresh()]
        x, P00, P0m, n, z, ids, zmask = inputs
        K = seg.z.shape[0]
        decided = (torch.empty(K, dtype=torch.int32, device=dev),
                   torch.empty(K, dtype=torch.bool, device=dev))
        body = _Segments(seg.state._replace(x=x, P00=P00, P0m=P0m, n=n), z,
                         ids, zmask, seg.R, seg.Re, seg.known, seg.shard)
        steps = (body.associate, lambda: body.gain(*decided), body.pmm,
                 body.augment)
        graphs = [torch.cuda.CUDAGraph() for _ in steps]
        pool = torch.cuda.graph_pool_handle()
        outs = []
        with self._side(dev):
            for graph, step in zip(graphs, steps):
                graph.capture_begin(pool=pool,
                                    capture_error_mode="thread_local")
                try:
                    outs.append(step())
                finally:
                    graph.capture_end()
        out = outs[3]
        return _Captured(graphs, inputs, decided, outs[0],
                         (out.x, out.P00, out.P0m, out.n),
                         (body.Pjj, body.gained))


_GRAPHS = _UpdateGraphs()


# ---------------------------------------------------------------------------
# Estimator (Runner-compatible)
# ---------------------------------------------------------------------------

class ShardedEkfSlam:
    """Landmark-sharded EKF-SLAM with the estimator interface of
    ``models.ekf.EkfSlam``. ``mesh``: a 1-D mesh on the landmark axis
    (``make_mesh(S, axis="l")``); every rank of it runs the estimator,
    on the mesh's device, and ``init`` returns the rank's block. The
    capacity is padded to a multiple of S, so that every rank owns whole
    landmarks. With no mesh: one card (the card, unless ``device`` names
    another) owns every row."""

    IS_EKF = True

    def __init__(self, config: SlamConfig, n_map_landmarks: int,
                 mesh: DeviceMesh | None = None, device=None):
        self.config = config
        self.n_map = n_map_landmarks
        self.mesh = mesh
        cap = config.max_landmarks or n_map_landmarks
        if mesh is None:
            self.device = default_device(device)
            self.axis, S, group, rank = LM_AXIS, 1, None, 0
        else:
            self.device = mesh_device(mesh) if device is None else device
            self.axis = mesh.mesh_dim_names[0]
            S = axis_size(mesh, self.axis)
            group = mesh.get_group(self.axis)
            rank = mesh.get_local_rank(self.axis)
        # Pad so that every shard owns whole landmarks: 2L % (2S) == 0.
        self.capacity = -(-cap // S) * S
        rows = 2 * self.capacity // S
        self.shard = Shard(row_lo=rank * rows, rows=rows, group=group)
        self.Q, self.R, self.Re = noise_matrices(config, self.device)

    def state_specs(self) -> ShardedEKFState:
        """How the state splits over the mesh (``parallel.mesh``)."""
        return state_specs(self.axis)

    def init(self, n_particles=None) -> ShardedEKFState:
        return sharded_ekf_init(self.capacity, self.n_map,
                                device=self.device, rows=self.shard.rows)

    def predict(self, state, generator, vn, gn, phi) -> ShardedEKFState:
        del generator
        cfg = self.config
        with full_f32():
            return _predict_local(
                state, vn, gn, self.Q, cfg.WHEELBASE, cfg.DT_CONTROLS, phi,
                cfg.sigmaT, bool(cfg.SWITCH_HEADING_KNOWN), self.shard)

    def update(self, state, generator, z, ids, zmask) -> ShardedEKFState:
        del generator
        cfg = self.config
        with full_f32():
            return _update_local(
                state, z, ids, zmask, self.R, self.Re, cfg.GATE_REJECT,
                cfg.GATE_AUGMENT, bool(cfg.SWITCH_ASSOCIATION_KNOWN),
                self.shard)

    def pose(self, state) -> torch.Tensor:
        """The joint state's head, x[:3], as a copy."""
        return state.x[:3].clone()


def dense_covariance(state: ShardedEKFState,
                     mesh: DeviceMesh | None = None) -> torch.Tensor:
    """The dense [3+2L, 3+2L] joint covariance, with the deferred
    heading terms folded (for tests). With ``mesh``, every rank of it
    calls this and gets the whole matrix: Pmm's rows are gathered."""
    if mesh is not None:
        state = gather_state(state, mesh, state_specs(mesh.mesh_dim_names[0]))
    hk = state.hk[:, :state.hk_n]
    Pmm = state.Pmm - hk @ hk.T
    top = torch.cat([state.P00, state.P0m], dim=1)
    bot = torch.cat([state.P0m.T, Pmm], dim=1)
    return torch.cat([top, bot], dim=0)
