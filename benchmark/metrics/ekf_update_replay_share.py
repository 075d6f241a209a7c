"""ekf_update_replay_share (program counter), %: the block EKF's updates
replayed from CUDA graphs over those replayed and those run eagerly
(``slam_tpu_torch.parallel.ekf.update_graphs``: ``replays`` over
``replays + eager``; eager: a layout's first update, its warm-up, and
any update off the card or on a mesh), since the process began: the
set-up's drive and the window. None where the program has no such
counter or ran no update. Layer: simulator and estimator
(parallel/ekf.py)."""


def read(ctx):
    from slam_tpu_torch.parallel import ekf
    counter = getattr(ekf, "update_graphs", None)
    if counter is None:
        return None
    n = counter.replays + counter.eager
    return 100.0 * counter.replays / n if n else None
