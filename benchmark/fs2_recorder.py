"""The ``Recorder`` of a FastSLAM 2 cell: what ``benchmark.recorder``
copies, and what the FastSLAM 2 check needs besides.

At each superstep of ``capture`` it also copies the pose covariances
before the superstep's first predict (``Pv0``, beside ``xv0``), each
tick's true heading with its controls (``controls``: one (speed, steer,
true heading) a tick; a multi-tick predict, which takes no heading,
gives a heading of 0), and the weights, poses and pose covariances of
the state that reaches the resample (``mid``: read by standing in for
``rbpf.resample`` during that update only; None if the update calls
none). The profiled sub-window is the ``Recorder``'s.
"""

from __future__ import annotations

import torch

from benchmark.recorder import Recorder


class Fs2Recorder(Recorder):
    """The estimator ``est``, recording at the supersteps of ``capture``
    (see the module's docstring); every other attribute is ``est``'s."""

    def _start(self, state):
        rec = self._record()
        if rec is not None and "xv0" not in rec:
            rec["xv0"], rec["Pv0"] = state.xv.clone(), state.Pv.clone()
        return rec

    def predict(self, state, generator, vn, gn, phi):
        rec = self._start(state)
        if rec is not None:
            rec["controls"].append(torch.stack([vn, gn, phi]).reshape(3))
        return self._est.predict(state, generator, vn, gn, phi)

    def _predict_multi(self, state, generator, controls):
        rec = self._start(state)
        if rec is not None:
            rec["controls"] = list(torch.cat(
                [controls, torch.zeros_like(controls[:, :1])], 1))
        return self._est.predict_multi(state, generator, controls)

    def update(self, state, generator, z, ids, zmask):
        rec = self._record()
        if rec is None:
            return super().update(state, generator, z, ids, zmask)
        from slam_tpu_torch.models import rbpf
        inner = rbpf.resample
        rec["mid"] = None

        def spy(st, *args, **kw):
            rec["mid"] = {k: getattr(st, k).clone()
                          for k in ("logw", "xv", "Pv")}
            return inner(st, *args, **kw)
        rbpf.resample = spy
        try:
            return super().update(state, generator, z, ids, zmask)
        finally:
            rbpf.resample = inner
