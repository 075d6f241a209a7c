"""fs2_predict_fused_share (program counter), %: FastSLAM 2's per-tick
predicts run as one F2 launch over all its per-tick predicts
(``slam_tpu_torch.models.fastslam2.fs2_predict_ticks``: ``fused`` over
``fused + eager``; eager: the plain twin's ticks, off the card), since
the process began: the set-up's warm-up and the window. None where the
program has no such counter or ran no per-tick predict. Layer:
simulator and estimator (models/fastslam2.py)."""


def read(ctx):
    from slam_tpu_torch.models import fastslam2
    counter = getattr(fastslam2, "fs2_predict_ticks", None)
    if counter is None:
        return None
    n = counter.fused + counter.eager
    return 100.0 * counter.fused / n if n else None
