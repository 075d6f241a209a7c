"""host_share.fs2_predict (program span), %: the self time of FastSLAM
2's per-tick ``filter.predict`` spans (the bicycle step and the
pose-covariance propagation) and of the ``fs2.heading`` spans beneath
them (the per-particle heading update; a program without them puts it
in ``filter.predict``), beneath the supersteps recorded whole in the
traced sub-window (``slam_tpu_torch.spans``), over those supersteps'
total time. Layer: simulator and estimator (models/fastslam2.py)."""

PHASES = ("filter.predict", "fs2.heading")


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
