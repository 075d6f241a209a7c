"""ba_trial_ms (program span), ms: the median duration of the
Levenberg-Marquardt trials (``ba.trial`` spans: the step, the cost and
its host read) inside the BA solves (``ba.solve``) recorded in the
traced sub-window (``slam_tpu_torch.spans``). Layer: BA (posegraph/)."""

import statistics


def read(ctx):
    try:
        from slam_tpu_torch import spans
    except ImportError:     # a program without spans
        return None
    trials = [(r[4] - r[3]) * 1e-6
              for r in spans.beneath(spans.records(), "ba.solve")
              if r[0] == "ba.trial"]
    return statistics.median(trials) if trials else None
