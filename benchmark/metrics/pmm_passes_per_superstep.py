"""pmm_passes_per_superstep (program counter): full passes over the EKF's
landmark covariance Pmm (``slam_tpu_torch.parallel.ekf.pmm_passes``:
the update's product, and each heading term that finds no free column
in ``hk``) over the window, per superstep. 1.0 where every heading term
waits for the update. Layer: simulator and estimator (parallel/ekf.py)."""


def read(ctx):
    units = ctx["units"]
    if not units or any("pmm_passes" not in u for u in units):
        return None
    return (sum(u["pmm_passes"] for u in units)
            / sum(u["supersteps"] for u in units))
