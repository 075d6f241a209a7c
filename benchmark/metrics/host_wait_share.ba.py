"""host_wait_share.ba (program span), %: the time of BA's device-to-host
reads (``ba.host_read``: the plan's, the first cost's, one a trial)
inside the BA solves (``ba.solve``) recorded in the traced sub-window
(``slam_tpu_torch.spans``), over those solves' total time. Layer: BA
(posegraph/)."""


def read(ctx):
    try:
        from slam_tpu_torch import spans
    except ImportError:     # a program without spans
        return None
    recs = spans.records()
    solves = spans.summary(recs).get("ba.solve")
    if not solves:
        return None
    reads = spans.summary(recs, within="ba.solve").get("ba.host_read")
    return 100.0 * (reads["total_s"] if reads else 0.0) / solves["total_s"]
