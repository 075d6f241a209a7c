"""The ``Recorder`` of a FastSLAM 1 cell at full per-particle capacity: it
copies the live slot rows only.

At 10,000 slots and 32,768 particles the landmark planes are 6.55 GB,
so a copied superstep's pre and post states, copied whole, would hold
13 GB, and four of them more than the card. Rows at and past a state's
live count ``n`` are never read before a new feature writes all five
of them, so the check judges rows [0, n) alone. At each superstep of
``capture`` this recorder reads ``n`` on the host (one sync, at a copied
superstep only) and copies rows [0, min(n + K, L)) of ``lm`` and
``lm_P`` of the state that reaches the update and of the state it
returns (an update adds at most K rows), with every other field whole,
as ``benchmark.recorder.particle_dict`` names them, and the log weights
that reach the resample's gate (``mid``: read by standing in for
``rbpf.resample_bounds`` during that update only; None if the update
calls none). The poses before the superstep's predict, its controls and
the profiled sub-window are the ``Recorder``'s.
"""

from __future__ import annotations

from benchmark.recorder import Recorder


def live_dict(dstate, rows: int) -> dict:
    """A device copy of a deferred FastSLAM 1 state with slot rows
    [0, rows) of its landmark planes, under the names the check reads."""
    ps = dstate.ps
    return dict(logw=ps.logw.clone(), xv=ps.xv.clone(), Pv=ps.Pv.clone(),
                lm=ps.lm[:, :rows].clone(), lm_P=ps.lm_P[:, :rows].clone(),
                n=ps.n.clone(), table=ps.da_table.clone(),
                S=dstate.S.clone(), pending=bool(dstate.pending))


class LiveRecorder(Recorder):
    """The estimator ``est``, copying the live rows at the supersteps of
    ``capture`` (see the module's docstring); ``n_obs`` is K, the
    observation slots of an update."""

    def __init__(self, est, n_obs: int):
        self.n_obs = n_obs
        super().__init__(est)

    def update(self, state, generator, z, ids, zmask):
        rec = self._record()
        if rec is None:
            return super().update(state, generator, z, ids, zmask)
        rows = min(int(state.ps.n) + self.n_obs, state.ps.capacity)
        rec["pre"] = live_dict(state, rows)
        rec["obs"] = (z.clone(), ids.clone(), zmask.clone())
        rec["mid"] = None
        from slam_tpu_torch.models import rbpf
        inner = rbpf.resample_bounds

        def spy(logw, *args, **kw):
            rec["mid"] = logw.clone()
            return inner(logw, *args, **kw)
        # The base class then runs the update and the sub-window alone.
        self.capture.discard(self.step)
        rbpf.resample_bounds = spy
        try:
            out = super().update(state, generator, z, ids, zmask)
        finally:
            rbpf.resample_bounds = inner
        rec["post"] = live_dict(out, rows)
        return out
