"""Starting the process group of a multi-device run (counterpart:
slam_tpu.parallel.distributed).

One process per device. JAX discovers a TPU pod's processes by itself;
nothing tells a process here of a cluster, so every process names the
coordinator's address (``tcp://host:port``), the number of processes
and its own index. The backend follows the device: NCCL between cards,
gloo between CPU processes (the tests). Nothing switches one for the
other: a missing NCCL, or no card where one is asked for, raises.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from slam_tpu_torch.device import default_device
from slam_tpu_torch.parallel.mesh import make_mesh


def init_distributed(coordinator_address: str, num_processes: int,
                     process_id: int, device=None) -> torch.device:
    """Join the process group as rank ``process_id`` of
    ``num_processes``, its coordinator at ``coordinator_address``
    (``tcp://localhost:29500``). No device named: NCCL on the card
    ``cuda:<process_id mod cards>``, a ``RuntimeError`` without one
    (``device.default_device``); ``device="cpu"``: gloo. Returns the
    rank's device."""
    device = default_device(device)
    if device.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("this PyTorch build has no NCCL; a run "
                               "across cards needs it")
        if device.index is None:
            device = torch.device("cuda",
                                  process_id % torch.cuda.device_count())
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", init_method=coordinator_address,
                                world_size=num_processes, rank=process_id,
                                device_id=device)
    elif device.type == "cpu":
        dist.init_process_group("gloo", init_method=coordinator_address,
                                world_size=num_processes, rank=process_id)
    else:
        raise ValueError(f"no process-group backend for {device}")
    return device


def global_particle_mesh():
    """The particle mesh over every process of the group."""
    return make_mesh()


def is_coordinator() -> bool:
    return dist.get_rank() == 0
