"""Collective stratified resampling over a sharded particle axis
(counterpart: slam_tpu.parallel.resampling).

Each rank holds a block of Pl particles of the global N = S Pl. The
semantics are the single-device resample's (global stratified positions
u_i = (i + U_i) / N over the normalized weights' prefix sum, the Neff
gate), with only these crossing ranks:

- scalars, by ``all_reduce`` (JAX's pmax / psum / pmin) and
  ``all_gather_into_tensor`` (the shard totals);
- the particle blocks, when the gate fires on more than one rank: a ring
  of ``batch_isend_irecv`` in which every block visits every rank once
  and each rank copies out the ancestors whose weight interval falls in
  the visiting block (JAX's ``ppermute`` ring).

Every function is called on every rank of ``group`` in the same order.
The gate ``need`` comes from all-reduced scalars, so it is the same on
every rank; it is read on the host once per call (``rbpf.host_bool``),
and every rank then takes the same branch.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from slam_tpu_torch.models import rbpf
from slam_tpu_torch.ops import resampling as rs
from slam_tpu_torch.ops.kernels import bounds_gather_multi, sorted_gather_multi
from slam_tpu_torch.ops.kernels.gather import bounds_form
from slam_tpu_torch.spans import span

PARTICLE_FIELDS = ("xv", "Pv", "lm", "lm_P")


def _all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    dist.all_reduce(t, op=op, group=group)
    return t


def _normalized_weights(logw, group):
    """Globally normalized linear weights and the global max log weight
    ([1]), by a collective max and sum (a logsumexp across ranks)."""
    gmax = _all_reduce(logw.max().reshape(1), dist.ReduceOp.MAX, group)
    w = torch.exp(logw - gmax)
    total = _all_reduce(w.sum().reshape(1), dist.ReduceOp.SUM, group)
    return w / total, gmax


def _neff(wn, group):
    """Neff = 1 / sum(w_i^2) over the global particle set, [1]."""
    return 1.0 / _all_reduce((wn * wn).sum().reshape(1),
                             dist.ReduceOp.SUM, group)


def global_neff(logw, group):
    """Neff of the global particle set from this rank's log weights
    ([Pl]), on every rank."""
    wn, _ = _normalized_weights(logw, group)
    return _neff(wn, group)


def ring_resample(state, logw, generator, n_min: float, do_resample: bool,
                  group, particle_fields: tuple[str, ...] = PARTICLE_FIELDS,
                  dither=None):
    """Neff-gated global stratified resampling of a sharded NamedTuple.

    ``state``'s ``particle_fields`` have this rank's block of particles
    on their last axis; ``logw`` [Pl] its log weights. ``dither`` [Pl]
    are this rank's stratified draws U_i (tests inject JAX's); by
    default they come from ``generator``, the rank's own stream.
    Returns (new state, new logw [Pl], whether it resampled)."""
    S, me = dist.get_world_size(group), dist.get_rank(group)
    Pl = logw.shape[0]
    N = S * Pl
    if dither is None:
        dither = torch.rand(Pl, generator=generator, device=logw.device)

    wn, _ = _normalized_weights(logw, group)
    need = bool(do_resample) and rbpf.host_bool(_neff(wn, group) < n_min)
    if not need:
        return state, torch.log(torch.clamp(wn, min=1e-38)), False

    with span("filter.resample"):
        # My output slots' stratified positions (global slot ids).
        gslot = me * Pl + torch.arange(Pl, dtype=torch.int32,
                                       device=wn.device)
        u = (gslot.to(wn.dtype) + dither) / float(N)
        if S == 1:
            state = _run_local(state, wn, u, dither, particle_fields)
        else:
            state = _run_ring(state, wn, u, group, particle_fields)
        return state, torch.full_like(logw, -math.log(N)), True


def _rows(state, particle_fields):
    """The particle fields as [rows, Pl] views."""
    return [getattr(state, f).reshape(-1, getattr(state, f).shape[-1])
            for f in particle_fields]


def _unpack(state, particle_fields, picked):
    return state._replace(**{f: p.reshape(getattr(state, f).shape)
                             for f, p in zip(particle_fields, picked)})


def _run_local(state, wn, u, dither, particle_fields):
    """One rank: every ancestor is local, so the ring becomes a plain
    stratified gather. On the card, where ``bounds_form`` picks it, G2
    from the offspring bounds (JAX's ``bounds_gather_multi`` arm on a
    TPU), with the dither table read at the bounds' positions; else G1
    by the ancestors that a search of the prefix sum finds for u. The prefix
    sums here are blocked (``ops.resampling._cumsum_blocked``): a CUDA
    ``torch.cumsum`` of a long vector rounds differently from run to
    run, and one ulp moves an ancestor."""
    Pl = wn.shape[0]
    # Off the card G1 at every Pl: JAX's ring takes it off a TPU, and the
    # CPU tests hold this ring bit for bit against JAX's.
    if wn.is_cuda and bounds_form(Pl):
        return _local_bounds_resample(state, wn, lambda pos: dither[pos],
                                      particle_fields)
    idx = torch.searchsorted(rs._cumsum_blocked(wn), u, out_int32=True)
    idx = torch.clamp(idx, 0, Pl - 1)
    return _unpack(state, particle_fields,
                   sorted_gather_multi(_rows(state, particle_fields), idx))


def _local_bounds_resample(state, wn, uniform_at: rs.UniformAt,
                           particle_fields=PARTICLE_FIELDS):
    """One rank's stratified resample through G2: the blocked prefix sum,
    the closed-form offspring bounds (``uniform_at`` the dither at a
    position), one gather over every particle field."""
    Pl = wn.shape[0]
    S_b = rs.offspring_bounds(rs._cumsum_blocked(wn), Pl, uniform_at)
    return _unpack(state, particle_fields,
                   bounds_gather_multi(_rows(state, particle_fields), S_b))


def _run_ring(state, wn, u, group, particle_fields):
    """S ranks: the particle fields and the prefix sum packed into one
    [C + 1, Pl] buffer that travels the ring, rank r sending to r + 1
    and receiving from r - 1; S - 1 exchanges. At each step a rank keeps
    the visiting block's particles whose global weight interval holds
    its u; the globally last block takes the float tail (u may pass the
    last prefix sum by rounding)."""
    S, me = dist.get_world_size(group), dist.get_rank(group)
    Pl = wn.shape[0]
    csum = rs._cumsum_blocked(wn)
    totals = torch.empty(S, dtype=wn.dtype, device=wn.device)
    dist.all_gather_into_tensor(totals, wn.sum().reshape(1), group=group)
    bases = torch.cumsum(totals, 0) - totals                  # exclusive
    rows = _rows(state, particle_fields)
    visit = torch.cat([*rows, csum[None]])                    # [C + 1, Pl]
    out = torch.zeros_like(visit[:-1])
    send_to = dist.get_global_rank(group, (me + 1) % S)
    recv_from = dist.get_global_rank(group, (me - 1) % S)
    for step in range(S):
        owner = (me - step) % S
        base = bases[owner]
        hi = (torch.full_like(base, math.inf) if owner == S - 1
              else base + totals[owner])
        valid = (u > base) & (u <= hi)
        idx = torch.searchsorted(visit[-1].contiguous(), u - base,
                                 out_int32=True)
        idx = torch.clamp(idx, 0, Pl - 1)
        out = torch.where(valid[None, :], visit[:-1, idx], out)
        if step < S - 1:
            nxt = torch.empty_like(visit)
            for req in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, visit, send_to, group),
                    dist.P2POp(dist.irecv, nxt, recv_from, group)]):
                req.wait()
            visit = nxt
    picked, row = [], 0
    for r in rows:
        picked.append(out[row:row + r.shape[0]])
        row += r.shape[0]
    return _unpack(state, particle_fields, picked)


def sharded_estimate_position(logw, xv, group):
    """Weighted-mean x/y and the heading of the max-weight particle over
    the global particle set (the first rank holding the maximum breaks
    ties, each rank its first particle): the sharded
    ``estimate_position``, [3] on every rank. ``xv``: [3, Pl]."""
    S, me = dist.get_world_size(group), dist.get_rank(group)
    wn, gmax = _normalized_weights(logw, group)
    xy = _all_reduce(torch.sum(wn[None, :] * xv[:2], dim=-1),
                     dist.ReduceOp.SUM, group)
    best = torch.argmax(logw).reshape(1)
    mine = torch.where(logw.index_select(0, best) == gmax, me, S)
    owner = _all_reduce(mine.to(torch.int32), dist.ReduceOp.MIN, group)
    theta = torch.where(owner == me, xv[2].index_select(0, best), 0.0)
    theta = _all_reduce(theta, dist.ReduceOp.SUM, group)
    return torch.cat([xy, theta])
