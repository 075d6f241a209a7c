"""K1, K2, K3, K4 and K5: the Jacobians, the FastSLAM 1 updates and
the FastSLAM 2 proposal refinement (counterpart:
slam_tpu.ops.pallas.kernels).

Each kernel has a wrapper that dispatches on the device of its tensors:
a CPU tensor goes to the plain PyTorch twin in this module, a CUDA
tensor to the CUDA kernel in ``csrc/`` (built on first use). Nothing
falls back: a CUDA launch that fails raises. Each wrapper counts its
kernel launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from slam_tpu_torch.geometry import wrap_angle
from slam_tpu_torch.ops import planes as pk
from slam_tpu_torch.ops.kernels import build
from slam_tpu_torch.ops.kernels.gather import bounds_gather_multi_plain


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_cuda(tensors: dict, dtypes: dict) -> torch.device:
    device = None
    for name, t in tensors.items():
        _require(t.is_cuda, f"{name} must be a CUDA tensor")
        _require(t.is_contiguous(), f"{name} must be contiguous")
        _require(t.dtype == dtypes.get(name, torch.float32),
                 f"{name} has dtype {t.dtype}")
        device = device or t.device
        _require(t.device == device, f"{name} is on {t.device}, "
                 f"not {device}")
    return device


# ---------------------------------------------------------------------------
# K1: batched Jacobians on pre-gathered planes
# ---------------------------------------------------------------------------

def jacobians(xv, lmx, lmy, p00, p01, p11, R) -> pk.JacobianPlanes:
    """K1 (replaces kernels.py:jacobians_tpu): the range-bearing model at
    each particle's pose xv [3, P] against gathered landmark planes
    [K, P], as a JacobianPlanes of [K, P] planes. The twin,
    ``pk.jacobians_planes``, on the CPU; csrc/jacobians.cu on the
    card."""
    if not xv.is_cuda:
        return pk.jacobians_planes(xv[0:1], xv[1:2], xv[2:3], lmx, lmy,
                                   p00, p01, p11, *pk.sym2_host(R))
    K, P = lmx.shape
    _check_cuda(dict(xv=xv, lmx=lmx, lmy=lmy, p00=p00, p01=p01, p11=p11),
                {})
    _require(xv.shape == (3, P) and 0 < K <= 65535
             and all(t.shape == (K, P) for t in (lmy, p00, p01, p11)),
             "jacobians: shapes do not match xv [3, P], planes [K, P] "
             "with 0 < K <= 65535")
    out = torch.empty((13, K, P), dtype=torch.float32, device=xv.device)
    err = build.load_library().slam_jacobians(
        xv.data_ptr(), lmx.data_ptr(), lmy.data_ptr(), p00.data_ptr(),
        p01.data_ptr(), p11.data_ptr(), *pk.sym2_host(R), K, P,
        out.data_ptr(), torch.cuda.current_stream(xv.device).cuda_stream)
    build.check(err, "slam_jacobians")
    jacobians.launches += 1
    return pk.JacobianPlanes(*out.unbind(0))


jacobians.launches = 0


# ---------------------------------------------------------------------------
# K3: FastSLAM 2 proposal refinement on pre-gathered planes
# ---------------------------------------------------------------------------

def fs2_refine_plain(xv, Pv, lmx, lmy, p00, p01, p11, z, matched, R):
    """Plain twin of K3: the sequential proposal refinement over the K
    observations, in order. For each k, the Jacobians at the current
    pose, the wrapped innovation and one ``pk.refine_pose_planes`` step,
    kept where matched[k]. xv [3, P], Pv [6, P] packed symmetric,
    gathered planes [K, P], z [K, 2], matched [K] bool. Returns fresh
    (xv_r [3, P], Pv_r [6, P])."""
    r = pk.sym2_host(R)
    x = tuple(xv)
    S = tuple(Pv)
    for k in range(z.shape[0]):
        J = pk.jacobians_planes(x[0], x[1], x[2], lmx[k], lmy[k], p00[k],
                                p01[k], p11[k], *r)
        v0 = z[k, 0] - J.zr
        v1 = wrap_angle(z[k, 1] - J.zb)
        (dx0, dx1, dx2), S_new = pk.refine_pose_planes(J, S, v0, v1)
        keep = matched[k]
        x = (torch.where(keep, x[0] + dx0, x[0]),
             torch.where(keep, x[1] + dx1, x[1]),
             torch.where(keep, wrap_angle(x[2] + dx2), x[2]))
        S = tuple(torch.where(keep, n, o) for n, o in zip(S_new, S))
    return torch.stack(x), torch.stack(S)


def fs2_refine(xv, Pv, lmx, lmy, p00, p01, p11, z, matched, R):
    """K3 (replaces kernels.py:fs2_refine_tpu): the twin on the CPU, the
    CUDA kernel csrc/refine.cu on the card. Returns fresh (xv_r, Pv_r);
    the inputs are not written."""
    if not xv.is_cuda:
        return fs2_refine_plain(xv, Pv, lmx, lmy, p00, p01, p11, z, matched,
                                R)
    K, P = lmx.shape
    _check_cuda(dict(xv=xv, Pv=Pv, lmx=lmx, lmy=lmy, p00=p00, p01=p01,
                     p11=p11, z=z, matched=matched),
                dict(matched=torch.bool))
    _require(xv.shape == (3, P) and Pv.shape == (6, P)
             and z.shape == (K, 2) and matched.shape == (K,)
             and all(t.shape == (K, P) for t in (lmy, p00, p01, p11)),
             "fs2_refine: shapes do not match xv [3, P], Pv [6, P], "
             "planes [K, P], z [K, 2], matched [K]")
    xv_r, Pv_r = torch.empty_like(xv), torch.empty_like(Pv)
    err = build.load_library().slam_fs2_refine(
        xv.data_ptr(), Pv.data_ptr(), lmx.data_ptr(), lmy.data_ptr(),
        p00.data_ptr(), p01.data_ptr(), p11.data_ptr(), z.data_ptr(),
        matched.data_ptr(), *pk.sym2_host(R), K, P, xv_r.data_ptr(),
        Pv_r.data_ptr(), torch.cuda.current_stream(xv.device).cuda_stream)
    build.check(err, "slam_fs2_refine")
    fs2_refine.launches += 1
    return xv_r, Pv_r


fs2_refine.launches = 0


# ---------------------------------------------------------------------------
# K4 and K2: the in-place update on the landmark state
# ---------------------------------------------------------------------------

def fused_update_plain(xv, logw, lm, lm_P, z, slot, matched, slot_new,
                       ok_new, R):
    """Plain twin of K4 and K2, in place like the kernels: logw [P] +=
    the log-likelihood summed over the matched k; the matched slots of
    lm [2, L, P] / lm_P [3, L, P] get their EKF update, the ``ok_new``
    slots their new feature, in one write where the first valid entry
    aimed at a slot wins, every update computed from the old values.
    Untouched slots keep their values."""
    # Imported here: models.rbpf imports this package (through
    # models.particles), so a module-level import would be circular.
    from slam_tpu_torch.models.rbpf import scatter_slots

    L = lm.shape[1]
    gathered = (lm[0, slot], lm[1, slot], lm_P[0, slot], lm_P[1, slot],
                lm_P[2, slot])
    J = pk.jacobians_planes(xv[0:1], xv[1:2], xv[2:3], *gathered,
                            *pk.sym2_host(R))
    v0 = z[:, 0:1] - J.zr
    v1 = wrap_angle(z[:, 1:2] - J.zb)
    logw += torch.where(matched[:, None],
                        pk.log_gauss2_planes(v0, v1, J.s00, J.s01, J.s11),
                        0.0).sum(dim=0)
    upd = pk.feature_update_planes(*gathered, v0, v1, J)
    ini = pk.feature_init_planes(xv[0:1], xv[1:2], xv[2:3], z[:, 0:1],
                                 z[:, 1:2], *pk.sym2_host(R))
    # One write of matched updates and new features: their slots are
    # disjoint (matched < n <= new).
    tgt = torch.cat([slot, torch.clamp(slot_new, 0, L - 1)])
    valid = torch.cat([matched, ok_new & (slot_new < L)])
    scatter_slots(lm, tgt, torch.cat([torch.stack([upd.nx, upd.ny]),
                                      torch.stack(ini[:2])], dim=1), valid)
    scatter_slots(lm_P, tgt,
                  torch.cat([torch.stack([upd.np00, upd.np01, upd.np11]),
                             torch.stack(ini[2:])], dim=1), valid)


def _update_launch(name, xv, logw, lm, lm_P, z, slot, matched, slot_new,
                   ok_new, R) -> None:
    """Check the arguments of K4 or K2 (one contract) and launch the
    kernel ``name`` of the library in place on logw, lm and lm_P."""
    _, L, P = lm.shape
    K = z.shape[0]
    _check_cuda(dict(xv=xv, logw=logw, lm=lm, lm_P=lm_P, z=z, slot=slot,
                     matched=matched, slot_new=slot_new, ok_new=ok_new),
                dict(slot=torch.int32, slot_new=torch.int32,
                     matched=torch.bool, ok_new=torch.bool))
    _require(xv.shape == (3, P) and logw.shape == (P,)
             and lm.shape == (2, L, P) and lm_P.shape == (3, L, P)
             and z.shape == (K, 2)
             and all(t.shape == (K,)
                     for t in (slot, matched, slot_new, ok_new)),
             f"{name}: shapes do not match xv [3, P], logw [P], "
             "lm [2, L, P], lm_P [3, L, P], z [K, 2], slots [K]")
    err = getattr(build.load_library(), name)(
        xv.data_ptr(), logw.data_ptr(), lm.data_ptr(), lm_P.data_ptr(),
        z.data_ptr(), slot.data_ptr(), matched.data_ptr(),
        slot_new.data_ptr(), ok_new.data_ptr(), *pk.sym2_host(R), K, L, P,
        torch.cuda.current_stream(xv.device).cuda_stream)
    build.check(err, name)


def fused_update(xv, logw, lm, lm_P, z, slot, matched, slot_new, ok_new,
                 R) -> None:
    """K4 (replaces kernels.py:fs1_update_tpu), in place on logw, lm and
    lm_P: the twin on the CPU, the CUDA kernel csrc/fused_update.cu on
    the card (4 or 1 threads per particle as P grows, each loading a
    chunk of its observations' slots before it stores any: see
    fused_update_map)."""
    if not xv.is_cuda:
        fused_update_plain(xv, logw, lm, lm_P, z, slot, matched, slot_new,
                           ok_new, R)
        return
    _update_launch("slam_fs1_fused_update", xv, logw, lm, lm_P, z, slot,
                   matched, slot_new, ok_new, R)
    fused_update.launches += 1


fused_update.launches = 0


def fused_update_map(P: int) -> tuple[int, int]:
    """K4's map at P particles, as the built library launches it:
    (threads per particle, observations a thread loads before it
    stores)."""
    threads, chunk = ctypes.c_int(), ctypes.c_int()
    build.check(build.load_library().slam_fs1_fused_update_map(
        P, ctypes.byref(threads), ctypes.byref(chunk)),
        "slam_fs1_fused_update_map")
    return threads.value, chunk.value


def observe_plain(xv, logw, lm, lm_P, z, slot, matched, slot_new, ok_new,
                  R) -> None:
    """Plain twin of K2: K4's function, ``fused_update_plain``."""
    fused_update_plain(xv, logw, lm, lm_P, z, slot, matched, slot_new,
                       ok_new, R)


def observe(xv, logw, lm, lm_P, z, slot, matched, slot_new, ok_new,
            R) -> None:
    """K2 (replaces kernels.py:_observe_call and, around it, the gather,
    scatters and add_new_features of the JAX package's update at a P
    that is no multiple of 128): K4's contract at any P, in place on
    logw, lm and lm_P. The twin on the CPU, the CUDA kernel
    csrc/observe.cu (one thread per (observation, particle) pair) on
    the card; on a slot that two matched observations share it keeps the
    first one's update, as the twin does."""
    if not xv.is_cuda:
        observe_plain(xv, logw, lm, lm_P, z, slot, matched, slot_new,
                      ok_new, R)
        return
    _update_launch("slam_fs1_observe", xv, logw, lm, lm_P, z, slot,
                   matched, slot_new, ok_new, R)
    observe.launches += 1


observe.launches = 0


# ---------------------------------------------------------------------------
# K5: fused resample + update into fresh landmark planes
# ---------------------------------------------------------------------------

def resample_update_plain(xv, logw, lm, lm_P, S, z, slot, matched,
                          slot_new, ok_new, R):
    """Plain twin of K5: gather the landmark planes by offspring bounds
    S (G2's twin), then K4's twin on the gathered planes. logw [P] is
    updated in place; returns the new (lm [2, L, P], lm_P [3, L, P])."""
    _, L, P = lm.shape
    lm_g, lmP_g = bounds_gather_multi_plain(
        [lm.reshape(2 * L, P), lm_P.reshape(3 * L, P)], S)
    lm_g, lmP_g = lm_g.reshape(2, L, P), lmP_g.reshape(3, L, P)
    fused_update_plain(xv, logw, lm_g, lmP_g, z, slot, matched, slot_new,
                       ok_new, R)
    return lm_g, lmP_g


def resample_update(xv, logw, lm, lm_P, S, z, slot, matched, slot_new,
                    ok_new, R):
    """K5 (replaces kernels.py:fs1_resample_update_tpu): K4 applied to
    the landmark planes gathered by the pending offspring bounds S [P]
    (int32, non-decreasing, S[-1] == P). xv and logw are the already
    permuted rows; logw is updated in place. Returns fresh (lm, lm_P):
    the kernel cannot run in place. The twin on the CPU, the CUDA kernel
    csrc/resample_update.cu on the card."""
    if not xv.is_cuda:
        return resample_update_plain(xv, logw, lm, lm_P, S, z, slot,
                                     matched, slot_new, ok_new, R)
    _, L, P = lm.shape
    K = z.shape[0]
    _check_cuda(dict(xv=xv, logw=logw, lm=lm, lm_P=lm_P, S=S, z=z,
                     slot=slot, matched=matched, slot_new=slot_new,
                     ok_new=ok_new),
                dict(S=torch.int32, slot=torch.int32,
                     slot_new=torch.int32, matched=torch.bool,
                     ok_new=torch.bool))
    _require(xv.shape == (3, P) and logw.shape == (P,) and S.shape == (P,)
             and lm.shape == (2, L, P) and lm_P.shape == (3, L, P)
             and z.shape == (K, 2)
             and all(t.shape == (K,)
                     for t in (slot, matched, slot_new, ok_new)),
             "resample_update: shapes do not match xv [3, P], logw [P], "
             "S [P], lm [2, L, P], lm_P [3, L, P], z [K, 2], slots [K]")
    lm_o, lmP_o = resample_update_launch(xv, logw, lm, lm_P, S, z, slot,
                                         matched, slot_new, ok_new, R)
    resample_update.launches += 1
    return lm_o, lmP_o


def resample_update_launch(xv, logw, lm, lm_P, S, z, slot, matched,
                           slot_new, ok_new, R, staged: bool = True):
    """One launch of csrc/resample_update.cu on tensors that
    ``resample_update`` has checked; fresh (lm, lm_P). ``staged``: bring
    the ancestors' rows through shared memory wherever a tile's ancestor
    run fits (the path's setting); False reads every ancestor column
    from device memory, to measure that branch on its own."""
    _, L, P = lm.shape
    lm_o, lmP_o = torch.empty_like(lm), torch.empty_like(lm_P)
    err = build.load_library().slam_fs1_resample_update(
        xv.data_ptr(), logw.data_ptr(), lm.data_ptr(), lm_P.data_ptr(),
        lm_o.data_ptr(), lmP_o.data_ptr(), S.data_ptr(), z.data_ptr(),
        slot.data_ptr(), matched.data_ptr(), slot_new.data_ptr(),
        ok_new.data_ptr(), *pk.sym2_host(R), z.shape[0], L, P, int(staged),
        torch.cuda.current_stream(xv.device).cuda_stream)
    build.check(err, "slam_fs1_resample_update")
    return lm_o, lmP_o


resample_update.launches = 0
