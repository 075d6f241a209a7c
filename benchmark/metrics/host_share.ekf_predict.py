"""host_share.ekf_predict (program span), %: the self time of the EKF's
per-tick ``filter.predict`` spans (the bicycle predict, the IMU-heading
observe and its deferral into ``hk``) beneath the supersteps recorded
whole in the traced sub-window (``slam_tpu_torch.spans``), over those
supersteps' total time. Layer: simulator and estimator
(parallel/ekf.py)."""


def read(ctx):
    try:
        from slam_tpu_torch import spans
    except ImportError:     # a program without spans
        return None
    recs = spans.records()
    steps = spans.summary(recs).get("superstep")
    if not steps:
        return None
    phase = spans.summary(recs, within="superstep").get("filter.predict")
    return 100.0 * (phase["self_s"] if phase else 0.0) / steps["total_s"]
