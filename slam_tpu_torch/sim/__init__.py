"""Simulation: vehicle truth, sensor, and the simulator driver."""

from slam_tpu_torch.sim.sensors import Observation, observe
from slam_tpu_torch.sim.simulator import Controls, Simulator, SimState
from slam_tpu_torch.sim.vehicle import (
    VehicleState,
    init_vehicle,
    predict_true_position,
    steer_and_move,
)

__all__ = ["Controls", "Observation", "SimState", "Simulator",
           "VehicleState", "init_vehicle", "observe",
           "predict_true_position", "steer_and_move"]
