"""host_wait_share.filter (program span), %: the time of the particle
filter's host reads at its gates (``filter.host_read``, the resample
gate and the new-feature gate: the host blocked on the device) beneath
the supersteps recorded whole in the traced sub-window
(``slam_tpu_torch.spans``), over those supersteps' total time.
Layer: entry (the gate in models/rbpf.py)."""


def read(ctx):
    try:
        from slam_tpu_torch import spans
    except ImportError:     # a program without spans
        return None
    recs = spans.records()
    steps = spans.summary(recs).get("superstep")
    if not steps:
        return None
    reads = spans.summary(recs, within="superstep").get("filter.host_read")
    return 100.0 * (reads["total_s"] if reads else 0.0) / steps["total_s"]
