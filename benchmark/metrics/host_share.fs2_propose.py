"""host_share.fs2_propose (program span), %: the self time of the
``fs2.propose`` spans (FastSLAM 2's proposal: K3's launch, the 3x3
Cholesky, the sample and the prior / proposal weight term) beneath the
supersteps recorded whole in the traced sub-window
(``slam_tpu_torch.spans``), over those supersteps' total time; nothing
where the program records no such span. Layer: simulator and estimator
(models/fastslam2.py)."""


def read(ctx):
    try:
        from slam_tpu_torch import spans
    except ImportError:     # a program without spans
        return None
    recs = spans.records()
    steps = spans.summary(recs).get("superstep")
    phase = spans.summary(recs, within="superstep").get("fs2.propose")
    if not steps or not phase:
        return None
    return 100.0 * phase["self_s"] / steps["total_s"]
