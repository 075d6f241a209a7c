"""Particle resampling: stratified, log-space, sort-free
(counterpart: slam_tpu.ops.resampling).

- Weights live in log space and are normalized with logsumexp.
- Stratified positions u_j = (j + U_j) / N; the offspring bounds
  S_i = #{j : u_j < csum_i} come in closed form from the dither
  evaluated at k = floor(N csum_i), so no search over u is needed.
- The dither is an injectable ``uniform_at(pos)`` callable: one random
  function of position, equal positions giving equal draws. The JAX
  package evaluates it with threefry ``fold_in``, which torch cannot
  reproduce, so tests inject the JAX draws and compare bit for bit.
  ``uniform_from_generator`` gives the default, drawn from a
  ``torch.Generator``: a ``DitherTable``, which also hands its table to
  R1.
- On the card the bounds are one launch of R1 (``ops.kernels.bounds``);
  ``offspring_bounds_plain`` is its twin, and what runs on the CPU.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

UniformAt = Callable[[torch.Tensor], torch.Tensor]


def normalize_log_weights(logw: torch.Tensor) -> torch.Tensor:
    """Normalize so that sum(exp(logw)) == 1."""
    return logw - torch.logsumexp(logw, dim=-1, keepdim=True)


def effective_particles(logw: torch.Tensor) -> torch.Tensor:
    """Neff = 1 / sum(w^2) on normalized weights."""
    logw = normalize_log_weights(logw)
    return torch.exp(-torch.logsumexp(2.0 * logw, dim=-1))


def cumulative_weights(logw_n: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of the (normalized) weights exp(logw_n):
    the stratum edges the offspring bounds are read against."""
    return _cumsum_blocked(torch.exp(logw_n))


def _cumsum_blocked(x: torch.Tensor, block: int = 1024) -> torch.Tensor:
    """Inclusive cumsum of a 1-D tensor that rounds the same way on
    every run: scans within rows of ``block`` elements, then over the
    row totals.

    On CUDA, ``torch.cumsum`` of a long 1-D tensor is a single-pass scan
    that combines tile prefixes in an order set by timing, so its float
    rounding changes from run to run (on an H100, 399 of 400 repeats at
    2^17 elements differed in some bit); one ulp moves a stratum edge
    and with it a resampled particle. A row-wise scan runs in a fixed
    order. The row edges can dip by an ulp, which offspring_bounds'
    running max absorbs."""
    n = x.shape[0]
    if n <= block:
        return torch.cumsum(x, dim=0)
    rows = torch.nn.functional.pad(x, (0, -n % block)).reshape(-1, block)
    within = torch.cumsum(rows, dim=1)
    inclusive = _cumsum_blocked(within[:, -1], block)
    prefix = torch.cat([inclusive.new_zeros(1), inclusive[:-1]])
    return (within + prefix[:, None]).reshape(-1)[:n]


class DitherTable:
    """A ``uniform_at`` read from a table of U[0, 1) draws; R1 reads the
    table itself."""

    def __init__(self, table: torch.Tensor):
        self.table = table

    def __call__(self, pos: torch.Tensor) -> torch.Tensor:
        return self.table[pos]


def uniform_from_generator(n: int, generator: torch.Generator,
                           device=None) -> DitherTable:
    """A ``uniform_at`` over positions [0, n): one U[0, 1) table drawn
    from ``generator``, read at the requested positions."""
    return DitherTable(torch.rand(n, generator=generator, device=device))


def offspring_bounds(csum: torch.Tensor, n_out: int,
                     uniform_at: UniformAt) -> torch.Tensor:
    """The stratified offspring bounds (``offspring_bounds_plain``): on a
    CUDA tensor one launch of R1, on a CPU tensor the plain form."""
    # Imported here: the kernels' package imports this module.
    from slam_tpu_torch.ops.kernels.bounds import offspring_bounds as r1
    return r1(csum, n_out, uniform_at)


def offspring_bounds_plain(csum: torch.Tensor, n_out: int,
                           uniform_at: UniformAt) -> torch.Tensor:
    """S_i = #{j : u_j < csum_i} for the grid u_j = (j + U_j) / n_out,
    in closed form: u_j < c iff j < k, or j == k and U_k < frac, with
    k = floor(n_out c). S is non-decreasing; ancestor i owns output
    slots [S_{i-1}, S_i). The last entry is forced to n_out so the float
    tail of the cumsum goes to the last ancestor.

    The running max keeps S a partition when the prefix sum dips by an
    ulp (the JAX package's blocked cumsum does at block edges); it
    moves a bound by at most one slot and never fires on a monotone
    csum."""
    t = csum * float(n_out)
    k = torch.clamp(t.to(torch.int32), 0, n_out - 1)
    Uk = uniform_at(k).to(csum.dtype)
    S = k + (Uk < t - k.to(csum.dtype)).to(torch.int32)
    S = torch.cummax(torch.clamp(S, max=n_out), dim=0).values
    S[-1] = n_out
    return S


def ancestors_from_bounds(S: torch.Tensor, n_out: int) -> torch.Tensor:
    """Invert offspring bounds S (non-decreasing, S[-1] == n_out) into
    the ancestor vector [n_out]: output j's ancestor is the first i
    with S_i > j."""
    j = torch.arange(n_out, dtype=S.dtype, device=S.device)
    return torch.searchsorted(S, j, right=True, out_int32=True)


def stratified_indices(logw: torch.Tensor, uniform_at: UniformAt,
                       n_out: int | None = None) -> torch.Tensor:
    """Stratified resampling ancestors (int32 [n_out], non-decreasing)."""
    n = logw.shape[-1]
    n_out = n if n_out is None else n_out
    csum = cumulative_weights(normalize_log_weights(logw))
    S = offspring_bounds(csum, n_out, uniform_at)
    return torch.clamp(ancestors_from_bounds(S, n_out), 0, n - 1)


def resample_particles(uniform_at: UniformAt, logw: torch.Tensor, n_min,
                       do_resample: bool = True):
    """The gated resample decision (counterpart: JAX
    ``resample_particles``, with the dither ``uniform_at`` in place of
    the key): (ancestors int32 [N], new logw [N], resampled bool []).
    Neff >= n_min, or resampling off: the identity and the normalized
    weights; otherwise the stratified ancestors and uniform weights. The
    decision stays on the device (no host read); gathering the state by
    the ancestors is the caller's."""
    n = logw.shape[-1]
    logw_n = normalize_log_weights(logw)
    need = (torch.exp(-torch.logsumexp(2.0 * logw_n, dim=-1)) < n_min
            ) & bool(do_resample)
    identity = torch.arange(n, dtype=torch.int32, device=logw.device)
    idx = torch.where(need, stratified_indices(logw_n, uniform_at),
                      identity)
    new_logw = torch.where(need, torch.full_like(logw_n, -math.log(n)),
                           logw_n)
    return idx, new_logw, need
