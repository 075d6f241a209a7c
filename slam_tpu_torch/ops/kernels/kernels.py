"""K2 and K4: the FastSLAM 1 observation updates (counterpart:
slam_tpu.ops.pallas.kernels).

Each kernel has a wrapper that dispatches on the device of its tensors:
a CPU tensor goes to the plain PyTorch twin in this module, a CUDA
tensor to the CUDA kernel in ``csrc/`` (built on first use). Nothing
falls back: a CUDA launch that fails raises. Each wrapper counts its
kernel launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import torch

from slam_tpu_torch.geometry import wrap_angle
from slam_tpu_torch.ops import planes as pk
from slam_tpu_torch.ops.kernels import build


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


def _observe_math(xv, gathered, z, matched, R):
    """The observation update both twins share, on gathered landmark
    planes [K, P]: (dlogw [P] summed over matched k, EKF-updated planes
    of every k)."""
    J = pk.jacobians_planes(xv[0:1], xv[1:2], xv[2:3], *gathered,
                            *pk.sym2_host(R))
    v0 = z[:, 0:1] - J.zr
    v1 = wrap_angle(z[:, 1:2] - J.zb)
    logl = torch.where(matched[:, None],
                       pk.log_gauss2_planes(v0, v1, J.s00, J.s01, J.s11),
                       0.0)
    return logl.sum(dim=0), pk.feature_update_planes(*gathered, v0, v1, J)


# ---------------------------------------------------------------------------
# K2: fused observe on pre-gathered planes
# ---------------------------------------------------------------------------

def observe_plain(xv, lmx, lmy, p00, p01, p11, z, matched, R):
    """Plain twin of K2. xv [3, P]; gathered planes [K, P]; z [K, 2];
    matched [K] bool. Returns (dlogw [P], nx, ny, np00, np01, np11)."""
    dlogw, upd = _observe_math(xv, (lmx, lmy, p00, p01, p11), z, matched,
                               R)
    m = matched[:, None]
    return (dlogw,
            torch.where(m, upd.nx, lmx), torch.where(m, upd.ny, lmy),
            torch.where(m, upd.np00, p00), torch.where(m, upd.np01, p01),
            torch.where(m, upd.np11, p11))


def observe(xv, lmx, lmy, p00, p01, p11, z, matched, R):
    """K2 (replaces kernels.py:_observe_call): the twin on the CPU, the
    CUDA kernel csrc/observe.cu on the card."""
    if not xv.is_cuda:
        return observe_plain(xv, lmx, lmy, p00, p01, p11, z, matched, R)
    K, P = lmx.shape
    _check_cuda(dict(xv=xv, lmx=lmx, lmy=lmy, p00=p00, p01=p01, p11=p11,
                     z=z, matched=matched), dict(matched=torch.bool))
    _require(xv.shape == (3, P) and z.shape == (K, 2)
             and matched.shape == (K,)
             and all(t.shape == (K, P) for t in (lmy, p00, p01, p11)),
             "observe: shapes do not match xv [3, P], planes [K, P], "
             "z [K, 2], matched [K]")
    lib = build.load_library()
    dlogw = torch.empty(P, dtype=torch.float32, device=xv.device)
    outs = [torch.empty_like(lmx) for _ in range(5)]
    err = lib.slam_fs1_observe(
        xv.data_ptr(), lmx.data_ptr(), lmy.data_ptr(), p00.data_ptr(),
        p01.data_ptr(), p11.data_ptr(), z.data_ptr(), matched.data_ptr(),
        *pk.sym2_host(R), K, P, dlogw.data_ptr(),
        *[o.data_ptr() for o in outs],
        torch.cuda.current_stream(xv.device).cuda_stream)
    build.check(err, "slam_fs1_observe")
    observe.launches += 1
    return (dlogw, *outs)


observe.launches = 0


# ---------------------------------------------------------------------------
# K4: fused in-place update on the landmark state
# ---------------------------------------------------------------------------

def fused_update_plain(xv, logw, lm, lm_P, z, slot, matched, slot_new,
                       ok_new, R):
    """Plain twin of K4, in place like the kernel: logw [P] += dlogw;
    matched slots of lm [2, L, P] / lm_P [3, L, P] get their EKF
    update, ``ok_new`` slots their new feature. Untouched slots keep
    their values."""
    # Imported here: models.rbpf imports this package (through
    # models.particles), so a module-level import would be circular.
    from slam_tpu_torch.models.rbpf import scatter_slots

    L = lm.shape[1]
    gathered = (lm[0, slot], lm[1, slot], lm_P[0, slot], lm_P[1, slot],
                lm_P[2, slot])
    dlogw, upd = _observe_math(xv, gathered, z, matched, R)
    logw += dlogw
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


def fused_update(xv, logw, lm, lm_P, z, slot, matched, slot_new, ok_new,
                 R) -> None:
    """K4 (replaces kernels.py:fs1_update_tpu), in place on logw, lm and
    lm_P: the twin on the CPU, the CUDA kernel csrc/fused_update.cu on
    the card."""
    if not xv.is_cuda:
        fused_update_plain(xv, logw, lm, lm_P, z, slot, matched, slot_new,
                           ok_new, R)
        return
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
             "fused_update: shapes do not match xv [3, P], logw [P], "
             "lm [2, L, P], lm_P [3, L, P], z [K, 2], slots [K]")
    lib = build.load_library()
    err = lib.slam_fs1_fused_update(
        xv.data_ptr(), logw.data_ptr(), lm.data_ptr(), lm_P.data_ptr(),
        z.data_ptr(), slot.data_ptr(), matched.data_ptr(),
        slot_new.data_ptr(), ok_new.data_ptr(), *pk.sym2_host(R), K, L, P,
        torch.cuda.current_stream(xv.device).cuda_stream)
    build.check(err, "slam_fs1_fused_update")
    fused_update.launches += 1


fused_update.launches = 0
