"""Simulation: vehicle truth, sensor, and the simulator driver."""

from slam_tpu_torch.sim.sensors import Observation, observe
from slam_tpu_torch.sim.simulator import (
    Controls,
    ControlTicks,
    Simulator,
    SimState,
)
from slam_tpu_torch.sim.vehicle import (
    VehicleState,
    init_vehicle,
    noisy_controls,
    predict_true_position,
    steer_and_move,
)

__all__ = ["Controls", "ControlTicks", "Observation", "SimState",
           "Simulator", "VehicleState", "init_vehicle", "noisy_controls",
           "observe", "predict_true_position", "steer_and_move"]
