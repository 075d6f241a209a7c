"""host_share.sim (program span), %: the self time of the simulator's
spans, ``sim.control`` (each control tick) and ``sim.observe``, beneath
the supersteps recorded whole in the traced sub-window
(``slam_tpu_torch.spans``), over those supersteps' total time.
Layer: simulator and estimator (sim/, runtime/loop.py)."""


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
    self_s = sum(phases[k]["self_s"] for k in ("sim.control", "sim.observe")
                 if k in phases)
    return 100.0 * self_s / steps["total_s"]
