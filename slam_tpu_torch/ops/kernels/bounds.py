"""R1: the offspring bounds of a fired stratified resample in one launch
(no TPU kernel behind it: the JAX package leaves ``offspring_bounds`` to
XLA).

``offspring_bounds(csum, n_out, uniform_at)`` is
``ops.resampling.offspring_bounds_plain``, its twin, bit for bit. A CPU
tensor goes to the twin, a CUDA tensor to csrc/offspring_bounds.cu, one
launch; ``offspring_bounds.launches`` counts them. The kernel reads the
dither as a table: ``uniform_from_generator``'s carries one
(``resampling.DitherTable``); any other ``uniform_at`` is evaluated once
at positions [0, n_out), which gives the same draws (equal positions,
equal draws).
"""

from __future__ import annotations

import torch

from slam_tpu_torch.ops import resampling as rs
from slam_tpu_torch.ops.kernels import build

# The kernel's scratch, one a (device, stream): its tile scan's counters
# and status words, which every launch leaves zeroed for the next.
_workspaces: dict = {}


def dither_table(uniform_at: rs.UniformAt, n_out: int, device):
    """The dither U at positions [0, n_out) as a float32 table: the table
    a ``DitherTable`` holds, or ``uniform_at`` evaluated at positions on
    ``device``."""
    table = getattr(uniform_at, "table", None)
    if table is None:
        table = uniform_at(torch.arange(n_out, dtype=torch.int32,
                                        device=device))
    return table.to(torch.float32).contiguous()


def _workspace(device, stream: int, words: int) -> torch.Tensor:
    ws = _workspaces.get((device, stream))
    if ws is None or ws.numel() < words:
        ws = torch.zeros(words, dtype=torch.int64, device=device)
        _workspaces[(device, stream)] = ws
    return ws


def offspring_bounds(csum: torch.Tensor, n_out: int,
                     uniform_at: rs.UniformAt) -> torch.Tensor:
    """R1: the stratified offspring bounds S [P] int32 of the inclusive
    prefix sum csum [P] float32 over n_out slots, with the dither
    ``uniform_at``: ``offspring_bounds_plain``'s S, in one launch."""
    if not csum.is_cuda:
        return rs.offspring_bounds_plain(csum, n_out, uniform_at)
    P = csum.shape[0] if csum.dim() == 1 else 0
    if not (csum.dtype == torch.float32 and P > 0 and csum.is_contiguous()):
        raise ValueError("csum must be a non-empty contiguous float32 "
                         "CUDA vector")
    if n_out < 1:
        raise ValueError(f"n_out must be at least 1, got {n_out}")
    U = dither_table(uniform_at, n_out, csum.device)
    if U.device != csum.device or U.dim() != 1 or U.shape[0] < n_out:
        raise ValueError(f"the dither table must hold {n_out} draws on "
                         f"{csum.device}: {tuple(U.shape)} on {U.device}")
    lib = build.load_library()
    stream = torch.cuda.current_stream(csum.device).cuda_stream
    ws = _workspace(csum.device, stream,
                    lib.slam_offspring_bounds_workspace(P))
    S = torch.empty(P, dtype=torch.int32, device=csum.device)
    err = lib.slam_offspring_bounds(csum.data_ptr(), U.data_ptr(),
                                    S.data_ptr(), P, n_out, ws.data_ptr(),
                                    stream)
    build.check(err, "slam_offspring_bounds")
    offspring_bounds.launches += 1
    return S


offspring_bounds.launches = 0
