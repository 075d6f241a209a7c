"""Where an entry point runs when its caller names no device.

The port is written for the card: ``Runner``, ``Simulator``, the
estimators and the CLI run on CUDA unless the caller asks for another
device, and refuse to start when there is no card. Nothing falls back to
the CPU on its own; ``device="cpu"`` (``-device cpu``) is the only way
there.
"""

from __future__ import annotations

import torch


def default_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the card.

    Any explicit value (``"cpu"``, ``"cuda:0"``, a ``torch.device``) is
    taken as given. ``None`` is ``torch.device("cuda")``, and raises a
    ``RuntimeError`` when ``torch.cuda.is_available()`` is false."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "slam_tpu_torch runs on a CUDA device by default, and "
            "torch.cuda.is_available() is False (PyTorch sees no NVIDIA "
            "GPU, or is a CPU-only build). Pass device=\"cpu\" "
            "(-device cpu on the command line) to run on the CPU.")
    return torch.device("cuda")
