"""G1 and G2: the resample gathers (counterpart:
slam_tpu.ops.pallas.gather).

``sorted_gather_multi(arrays, idx)`` is ``[a[:, idx] for a in arrays]``;
``bounds_gather_multi(arrays, S)`` is the same gather with the ancestors
given as offspring bounds (``bounds_form`` picks one for a resample).
Both are bit-exact copies. A CPU tensor goes to the plain twin, a CUDA
tensor to csrc/gather.cu, one launch for the whole list; each wrapper
counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import torch

from slam_tpu_torch.ops.kernels import build
from slam_tpu_torch.ops.resampling import ancestors_from_bounds

# G2 at a P that is a multiple of this, else G1: the JAX package's TPU rule
# (its bounds gather takes whole 512-particle blocks).
BOUNDS_ALIGN = 512


def bounds_form(P: int) -> bool:
    """Whether a resample of P particles gathers by offspring bounds."""
    return P % BOUNDS_ALIGN == 0


def sorted_gather_multi_plain(arrays, idx):
    return [a[:, idx] for a in arrays]


def bounds_gather_multi_plain(arrays, S):
    idx = ancestors_from_bounds(S, S.shape[0])
    return [a[:, idx] for a in arrays]


def _gather_arrays(arrays, n_out: int):
    """Validate the [C_i, P] f32 CUDA planes, allocate the [C_i, n_out]
    outputs, and pack both into the kernels' by-value argument."""
    if len(arrays) > build.MAX_GATHER_ARRAYS:
        raise ValueError(f"at most {build.MAX_GATHER_ARRAYS} arrays per "
                         f"launch, got {len(arrays)}")
    P = arrays[0].shape[1]
    for a in arrays:
        if not (a.is_cuda and a.dtype == torch.float32 and a.dim() == 2
                and a.shape[1] == P and a.is_contiguous()
                and a.device == arrays[0].device):
            raise ValueError("gather arrays must be contiguous [C, P] "
                             "float32 CUDA tensors on one device")
    outs = [torch.empty((a.shape[0], n_out), dtype=a.dtype,
                        device=a.device) for a in arrays]
    packed = build.GatherArrays()
    for q, (a, o) in enumerate(zip(arrays, outs)):
        packed.src[q] = a.data_ptr()
        packed.dst[q] = o.data_ptr()
        packed.rows[q] = a.shape[0]
    packed.n_arrays = len(arrays)
    return P, outs, packed


def _index_vector(v, name: str, device) -> None:
    if not (v.is_cuda and v.dtype == torch.int32 and v.dim() == 1
            and v.is_contiguous() and v.device == device):
        raise ValueError(f"{name} must be a contiguous int32 CUDA vector "
                         f"on {device}")


def sorted_gather_multi(arrays, idx):
    """G1 (replaces gather.py:sorted_gather_multi): ``[a[:, idx] for a
    in arrays]`` for [C_i, P] planes and int32 idx [N]. Fast when idx is
    non-decreasing (stratified ancestors); right for any idx in [0, P)."""
    arrays = list(arrays)
    if not idx.is_cuda:
        return sorted_gather_multi_plain(arrays, idx)
    P, outs, packed = _gather_arrays(arrays, idx.shape[0])
    _index_vector(idx, "idx", arrays[0].device)
    err = build.load_library().slam_sorted_gather(
        packed, idx.data_ptr(), P, idx.shape[0],
        torch.cuda.current_stream(idx.device).cuda_stream)
    build.check(err, "slam_sorted_gather")
    sorted_gather_multi.launches += 1
    return outs


sorted_gather_multi.launches = 0


def bounds_gather_multi(arrays, S):
    """G2 (replaces gather.py:bounds_gather_multi): the resample gather
    driven by offspring bounds S [P] (non-decreasing, S[-1] == P),
    ancestor g owning outputs [S[g-1], S[g]); the ancestor vector is
    never materialized on the card."""
    arrays = list(arrays)
    if not S.is_cuda:
        return bounds_gather_multi_plain(arrays, S)
    P, outs, packed = _gather_arrays(arrays, S.shape[0])
    _index_vector(S, "S", arrays[0].device)
    if S.shape[0] != P:
        raise ValueError("bounds gather keeps the particle count: "
                         f"S has {S.shape[0]} entries for P = {P}")
    err = build.load_library().slam_bounds_gather(
        packed, S.data_ptr(), P,
        torch.cuda.current_stream(S.device).cuda_stream)
    build.check(err, "slam_bounds_gather")
    bounds_gather_multi.launches += 1
    return outs


bounds_gather_multi.launches = 0
