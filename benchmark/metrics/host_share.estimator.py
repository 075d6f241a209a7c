"""host_share.estimator (program span), %: the self time of the
estimator's spans, ``filter.predict``, ``filter.update`` and
``filter.resample`` (the gates' host reads, ``filter.host_read``, left
out), beneath the supersteps recorded whole in the traced sub-window
(``slam_tpu_torch.spans``), over those supersteps' total time.
Layer: simulator and estimator (models/)."""

PHASES = ("filter.predict", "filter.update", "filter.resample")


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
