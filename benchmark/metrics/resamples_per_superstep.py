"""resamples_per_superstep (program span): the resamples fired
(``filter.resample`` spans) beneath the supersteps recorded whole in
the traced sub-window (``slam_tpu_torch.spans``), per such superstep. A
guard on the traffic: a change that moves it changed the filter's work.
Layer: simulator and estimator (models/rbpf.py, models/fastslam1.py)."""


def read(ctx):
    try:
        from slam_tpu_torch import spans
    except ImportError:     # a program without spans
        return None
    recs = spans.records()
    steps = spans.summary(recs).get("superstep")
    if not steps:
        return None
    fired = spans.summary(recs, within="superstep").get("filter.resample")
    return (fired["count"] if fired else 0) / steps["count"]
