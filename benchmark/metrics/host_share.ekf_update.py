"""host_share.ekf_update (program span), %: the self time of the EKF's
``filter.update`` and of the four spans beneath it, ``ekf.associate``,
``ekf.gain``, ``ekf.pmm`` and ``ekf.augment`` (a program without them
puts all of it in ``filter.update``), beneath the supersteps recorded
whole in the traced sub-window (``slam_tpu_torch.spans``), over those
supersteps' total time. Layer: simulator and estimator
(parallel/ekf.py)."""

PHASES = ("filter.update", "ekf.associate", "ekf.gain", "ekf.pmm",
          "ekf.augment")


def read(ctx):
    try:
        from slam_tpu_torch import spans
    except ImportError:     # a program without spans
        return None
    recs = spans.records()
    steps = spans.summary(recs).get("superstep")
    if not steps:
        return None
    phases = spans.summary(recs, within="superstep")
    self_s = sum(phases[k]["self_s"] for k in PHASES if k in phases)
    return 100.0 * self_s / steps["total_s"]
