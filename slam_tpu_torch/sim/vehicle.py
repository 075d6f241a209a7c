"""Bicycle vehicle truth model and waypoint steering (counterpart:
slam_tpu.sim.vehicle). Branch-free tensor code: the state lives on the
run's device and a tick reads nothing back to the host."""

from __future__ import annotations

from typing import NamedTuple

import torch

from slam_tpu_torch.geometry import wrap_angle


class VehicleState(NamedTuple):
    """``pose`` [3] (x, y, theta), ``steer`` [], ``waypoint`` [] int32,
    ``loops`` [] int32 remaining, ``done`` [] bool."""
    pose: torch.Tensor
    steer: torch.Tensor
    waypoint: torch.Tensor
    loops: torch.Tensor
    done: torch.Tensor


def init_vehicle(number_loops: int, device=None) -> VehicleState:
    """Origin pose, zero steer, first waypoint."""
    return VehicleState(
        pose=torch.zeros(3, dtype=torch.float32, device=device),
        steer=torch.zeros((), dtype=torch.float32, device=device),
        waypoint=torch.zeros((), dtype=torch.int32, device=device),
        loops=torch.full((), number_loops, dtype=torch.int32,
                         device=device),
        done=torch.zeros((), dtype=torch.bool, device=device),
    )


def predict_true_position(pose, V, G, wheelbase, dt):
    """One bicycle step: x += V dt cos(G + theta); y += V dt
    sin(G + theta); theta = wrap(theta + V dt sin(G) / wheelbase)."""
    theta = pose[2]
    G = torch.as_tensor(G, dtype=pose.dtype, device=pose.device)
    return torch.stack([
        pose[0] + V * dt * torch.cos(G + theta),
        pose[1] + V * dt * torch.sin(G + theta),
        wrap_angle(theta + V * dt * torch.sin(G) / wheelbase),
    ])


def _row(table, i):
    """table[i] for a 0-d device index, without reading it on the host
    (a Python-style index would)."""
    return table.index_select(0, i.reshape(1))[0]


def _update_steering(pose, steer, waypoint, loops, waypoints,
                     at_waypoint, rateg, maxg, dt):
    """Steer toward the current waypoint with rate and angle clamps,
    advancing waypoints and loops. Returns (steer, waypoint, loops,
    done)."""
    n_wp = waypoints.shape[0]
    wp = _row(waypoints, waypoint)
    d2 = torch.sum((wp - pose[:2]) ** 2)

    reached = d2 < at_waypoint * at_waypoint
    next_idx = torch.where(reached, waypoint + 1, waypoint)

    exhausted = next_idx >= n_wp
    new_loops = torch.where(exhausted & (loops > 1), loops - 1, loops)
    done = exhausted & (loops <= 1)
    next_idx = torch.where(exhausted, 0, next_idx).to(torch.int32)

    target = _row(waypoints, torch.clamp(next_idx, 0, n_wp - 1))
    delta = wrap_angle(torch.atan2(target[1] - pose[1], target[0] - pose[0])
                       - pose[2] - steer)
    max_delta = rateg * dt
    delta = torch.clamp(delta, -max_delta, max_delta)
    new_steer = torch.clamp(steer + delta, -maxg, maxg)

    new_steer = torch.where(exhausted, steer, new_steer)
    return new_steer, next_idx, new_loops, done


def noisy_controls(steer, noise, V, sigma_v, sigma_g):
    """The estimator's controls of a tick: (V + n0 sigma_v, steer + n1
    sigma_g) for the tick's two standard normals ``noise`` [2]."""
    return V + noise[0] * sigma_v, steer + noise[1] * sigma_g


def steer_and_move(state: VehicleState, waypoints, *, V, wheelbase, dt,
                   at_waypoint, rateg, maxg) -> VehicleState:
    """One control tick: chase the waypoint, clamp the steering,
    propagate the truth; a no-op once ``done``."""
    steer, wp_idx, loops, done = _update_steering(
        state.pose, state.steer, state.waypoint, state.loops, waypoints,
        at_waypoint, rateg, maxg, dt)
    done = state.done | done
    new_pose = predict_true_position(state.pose, V, steer, wheelbase, dt)
    return VehicleState(
        pose=torch.where(done, state.pose, new_pose),
        steer=torch.where(done, state.steer, steer),
        waypoint=torch.where(done, state.waypoint, wp_idx),
        loops=torch.where(done, state.loops, loops),
        done=done,
    )
