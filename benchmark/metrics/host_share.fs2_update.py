"""host_share.fs2_update (program span), %: the self time of FastSLAM
2's ``filter.update`` and of the spans beneath it, ``fs2.associate``,
``fs2.propose``, ``fs2.map`` and ``filter.resample`` (a program without
the ``fs2.*`` spans puts their time in ``filter.update``; the gate's
host read, ``filter.host_read``, left out), beneath the supersteps
recorded whole in the traced sub-window (``slam_tpu_torch.spans``),
over those supersteps' total time. Layer: simulator and estimator
(models/fastslam2.py)."""

PHASES = ("filter.update", "fs2.associate", "fs2.propose", "fs2.map",
          "filter.resample")


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
