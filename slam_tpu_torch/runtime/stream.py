"""The streaming run: one superstep at a time, with the reference GUI's
messages after each (counterpart: slam_tpu.runtime.stream).

The message sequence is the JAX package's, which replays the reference
wrappers' plotting (configurePlot / addWaypointsAndLandmarks,
slamwrapper.cpp:94-139; the per-iteration emission,
ekfslamwrapper.cpp:88-105; the particle drawing,
ParticleSLAMWrapper.cpp:34-54): the scene once, then per superstep the
true and estimated positions and cars, the laser lines, the particle
clouds (a ``ParticleState``) or the covariance ellipses (an
``EKFState``), the loop time and ``plot``; ``endPlot`` at the end. With
a plot, the run stops after the first superstep at which the vehicle is
no longer active.

Each superstep reads its telemetry from the device in one packed copy:
the trace row, bit for bit (float32 words reinterpreted as int32), and
the live landmark count. With a plot, a second copy brings the particle
clouds, or all n + 1 ellipses, made on the device by one batched
``covariance_ellipse``. ``RunResult.host_syncs`` counts these reads
beside the gates.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from slam_tpu_torch.geometry import covariance_ellipse, laser_lines
from slam_tpu_torch.models import rbpf
from slam_tpu_torch.models.ekf import EKFState
from slam_tpu_torch.models.particles import ParticleState

# The trace row's dtypes, in RunResult's order.
TRACE_DTYPES = (np.float32, np.float32, np.bool_, np.int32, np.float32,
                np.float32, np.bool_, np.int32, np.float32)


def _configure_plot(plot, runner, sim_name):
    """The scene (SLAMWrapper::configurePlot, slamwrapper.cpp:94-110, and
    setPlotRange, :141-172)."""
    ext = runner.map.extent()
    plot.set_plot_range(ext[0], ext[1], ext[2], ext[3])
    plot.set_simulation_name(sim_name)
    plot.set_car_size(runner.config.WHEELBASE, 0)
    plot.set_car_size(runner.config.WHEELBASE, 1)
    lm = runner.map.landmarks
    wp = runner.map.waypoints
    plot.set_landmarks(list(lm[:, 0]), list(lm[:, 1]))
    plot.set_waypoints(list(wp[:, 0]), list(wp[:, 1]))


def _words(t: torch.Tensor) -> torch.Tensor:
    """A tensor as flat int32 words: float32 reinterpreted, the rest
    converted (exact for bools and int32)."""
    t = t.reshape(-1)
    return t.view(torch.int32) if t.dtype == torch.float32 else t.int()


def read_telemetry(out, est_state):
    """One device-to-host copy of a superstep's trace row and the
    estimator's live landmark count: ([nine numpy arrays], n)."""
    live = getattr(est_state, "n", None)
    parts = list(out) + ([live] if live is not None else [])
    words = torch.cat([_words(t) for t in parts]).cpu().numpy()
    row, at = [], 0
    for t, dtype in zip(out, TRACE_DTYPES):
        chunk = words[at:at + t.numel()]
        at += t.numel()
        chunk = (chunk.view(np.float32) if dtype == np.float32
                 else chunk.astype(dtype))
        row.append(chunk.reshape(tuple(t.shape)))
    return row, (int(words[at]) if live is not None else 0)


def ellipses(state: EKFState, n: int) -> torch.Tensor:
    """The 2-sigma ellipses of the pose and of the n live landmarks,
    [n + 1, 17, 2], in one batched call on the state's device."""
    dev = state.x.device
    lo = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                    3 + 2 * torch.arange(n, device=dev)])
    r = lo[:, None] + torch.arange(2, device=dev)          # [n + 1, 2]
    return covariance_ellipse(state.x[r], state.P[r[:, :, None],
                                                  r[:, None, :]])


def _emit_state(plot, est_state, n: int) -> int:
    """The estimator's overlays: the particle clouds of a ParticleState
    (ParticleSLAMWrapper.cpp:34-54), the covariance ellipses of an
    EKFState (EKFSLAMWrapper::drawCovarianceEllipseLines,
    ekfslamwrapper.cpp:117-137); nothing for another state, as in the
    JAX package. Returns the device reads it made (0 or 1)."""
    if isinstance(est_state, ParticleState):
        P = est_state.n_particles
        flat = torch.cat([est_state.xv[:2].reshape(-1),
                          est_state.lm[:, :n, :].reshape(-1)]).cpu().numpy()
        xv, lm = flat[:2 * P].reshape(2, P), flat[2 * P:].reshape(2, n, P)
        plot.set_particles(list(xv[0]), list(xv[1]))
        if n:
            plot.set_feature_particles(list(lm[0].reshape(-1)),
                                       list(lm[1].reshape(-1)))
        return 1
    if isinstance(est_state, EKFState):
        ell = ellipses(est_state, n).cpu().numpy()
        plot.cov_ellipse_add(n + 1)
        for j in range(n + 1):
            plot.set_cov_ellipse(ell[j].T, j)
        return 1
    return 0


def stream_run(runner, seed=0, n_ticks=None, plot=None,
               sim_name="simulation"):
    """``runner``'s run one superstep at a time, each followed by its
    messages to ``plot`` (a NetworkPlot, or None for none): a RunResult
    whose ``host_syncs`` counts the gates and the telemetry reads, and
    whose ``wall_seconds`` covers the messages too."""
    from slam_tpu_torch.runtime.loop import run_result

    period = runner.config.steps_per_observe
    if n_ticks is None:
        n_ticks = runner.estimate_run_ticks()
    n_supersteps = n_ticks // period
    sim_state, est_state, gen, build_s = runner._init(seed)
    superstep = runner._superstep_for(est_state)

    if plot is not None:
        _configure_plot(plot, runner, sim_name)

    rows, reads = [], 0
    syncs0 = rbpf.host_bool.count
    runner._sync()
    t0 = time.perf_counter()
    for _ in range(n_supersteps):
        it0 = time.perf_counter()
        sim_state, est_state, out = runner._step(superstep, sim_state,
                                                 est_state, gen)
        row, n = read_telemetry(out, est_state)
        reads += 1
        rows.append(row)
        if plot is not None:
            (tp, ep, active, _count, _rs, z, zmask, _ids, _odom) = row
            plot.add_true_position(tp[0], tp[1])
            plot.add_estimated_position(ep[0], ep[1])
            plot.set_car_true_position(tp[0], tp[1], tp[2])
            plot.set_car_estimated_position(ep[0], ep[1], ep[2])
            lines = laser_lines(torch.from_numpy(z[zmask]),
                                torch.from_numpy(tp))
            plot.set_laser_lines(lines.numpy().T)
            reads += _emit_state(plot, est_state, n)
            plot.loop_time(int(1e6 * (time.perf_counter() - it0)))
            plot.plot()
            if not bool(active):
                break
    wall = time.perf_counter() - t0
    if plot is not None:
        plot.end_plot()

    traces = [np.stack([r[i] for r in rows]) for i in range(len(rows[0]))]
    return run_result(traces, est_state, len(rows) * period, wall, build_s,
                      rbpf.host_bool.count - syncs0 + reads)
