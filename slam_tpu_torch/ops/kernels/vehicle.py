"""S1: the simulator's control ticks of a superstep in one launch
(``csrc/sim_control.cu``), with its plain twin. No TPU kernel stands
behind it: the JAX package runs a tick inside its superstep's
``lax.scan``; the port ran each tick as some 72 eager operations on 0-d
tensors.

A tick is the truth vehicle's steering and motion
(``sim.vehicle.steer_and_move``), its noisy controls
(``sim.vehicle.noisy_controls``) and the dead-reckoning odometry over
the superstep so far (``sim.vehicle.predict_true_position`` of the noisy
controls). The noise comes in as a [T, 2] tensor of standard normals, so
the caller draws it as it always did.

A CPU tensor goes to the twin, a CUDA tensor to the kernel; nothing
falls back, and any other device is refused. ``control_multi.launches``
counts the launches. The kernel keeps the eager code's operation order
as ATen runs it on the card and is bit-equal to the twin there.
"""

from __future__ import annotations

import torch

from slam_tpu_torch.ops.kernels import build
from slam_tpu_torch.ops.kernels.kernels import _check_cuda, _require

F32, I32 = torch.float32, torch.int32


def control_multi_plain(vehicle, waypoints, noise, *, V, wheelbase, dt,
                        at_waypoint, rateg, maxg, sigma_v, sigma_g):
    """Plain twin of S1: for each row of ``noise`` [T, 2], one
    ``steer_and_move`` tick of ``vehicle`` (a ``sim.vehicle.VehicleState``)
    toward ``waypoints`` [n_wp, 2], its noisy controls and the
    dead-reckoning step. Returns (vehicle after the T ticks, controls
    [T, 2] (v, g), truth poses [T, 3] after each tick, odometry [3])."""
    # Imported here: sim.simulator imports this module.
    from slam_tpu_torch.sim.vehicle import (
        noisy_controls,
        predict_true_position,
        steer_and_move,
    )

    dr = torch.zeros(3, dtype=F32, device=noise.device)
    ctl, poses = [], []
    for t in range(noise.shape[0]):
        vehicle = steer_and_move(vehicle, waypoints, V=V,
                                 wheelbase=wheelbase, dt=dt,
                                 at_waypoint=at_waypoint, rateg=rateg,
                                 maxg=maxg)
        v, g = noisy_controls(vehicle.steer, noise[t], V, sigma_v, sigma_g)
        dr = predict_true_position(dr, v, g, wheelbase, dt)
        ctl.append(torch.stack([v, g]))
        poses.append(vehicle.pose)
    return vehicle, torch.stack(ctl), torch.stack(poses), dr


def _check(vehicle, waypoints, noise) -> None:
    """Shapes and dtypes, then one device for every tensor."""
    tensors = dict(zip(vehicle._fields, vehicle), waypoints=waypoints,
                   noise=noise)
    dtypes = dict(waypoint=I32, loops=I32, done=torch.bool)
    for name, t in tensors.items():
        _require(t.dtype == dtypes.get(name, F32),
                 f"control_multi: {name} has dtype {t.dtype}")
    _require(vehicle.pose.shape == (3,)
             and all(t.shape == () for t in vehicle[1:])
             and waypoints.dim() == 2 and waypoints.shape[0] >= 1
             and waypoints.shape[1] == 2 and noise.dim() == 2
             and noise.shape[0] >= 1 and noise.shape[1] == 2,
             "control_multi: shapes do not match pose [3], steer, "
             "waypoint, loops and done [], waypoints [n_wp >= 1, 2], "
             "noise [T >= 1, 2]")
    devices = {t.device for t in tensors.values()}
    _require(len(devices) == 1,
             f"control_multi: the tensors lie on {sorted(map(str, devices))}")


def control_multi(vehicle, waypoints, noise, *, V, wheelbase, dt,
                  at_waypoint, rateg, maxg, sigma_v, sigma_g):
    """S1: T = ``noise.shape[0]`` control ticks of the truth vehicle with
    its noisy controls and odometry, as ``control_multi_plain``: the twin
    on the CPU, ``csrc/sim_control.cu`` on the card (one launch, no host
    read). The configuration's numbers are host floats; ``sigma_v`` and
    ``sigma_g`` scale the noise. Returns fresh tensors: (vehicle, controls
    [T, 2], truth poses [T, 3], odometry [3])."""
    _check(vehicle, waypoints, noise)
    kw = dict(V=V, wheelbase=wheelbase, dt=dt, at_waypoint=at_waypoint,
              rateg=rateg, maxg=maxg, sigma_v=sigma_v, sigma_g=sigma_g)
    if noise.device.type == "cpu":
        return control_multi_plain(vehicle, waypoints, noise, **kw)
    _check_cuda(dict(zip(vehicle._fields, vehicle), waypoints=waypoints,
                     noise=noise),
                dict(waypoint=I32, loops=I32, done=torch.bool))
    T, dev = noise.shape[0], noise.device
    out = type(vehicle)(*(torch.empty_like(t) for t in vehicle))
    ctl = torch.empty((T, 2), dtype=F32, device=dev)
    poses = torch.empty((T, 3), dtype=F32, device=dev)
    dr = torch.empty(3, dtype=F32, device=dev)
    # Products of two host floats are folded in double and rounded to
    # float32 once, as ATen takes a Python scalar.
    err = build.load_library().slam_sim_control_multi(
        *(t.data_ptr() for t in vehicle), waypoints.data_ptr(),
        noise.data_ptr(), V, V * dt, dt, wheelbase,
        at_waypoint * at_waypoint, rateg * dt, maxg, sigma_v, sigma_g,
        waypoints.shape[0], T, *(t.data_ptr() for t in out),
        ctl.data_ptr(), poses.data_ptr(), dr.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "slam_sim_control_multi")
    control_multi.launches += 1
    return out, ctl, poses, dr


control_multi.launches = 0
