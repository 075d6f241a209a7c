"""The multi-device layer (counterpart: slam_tpu.parallel). Ported so
far: the one-card arm of the landmark-block EKF (``parallel.ekf``)."""
