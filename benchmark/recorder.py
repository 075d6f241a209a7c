"""An estimator that records, for the correctness check, what the timed
path did at chosen supersteps, and opens the profiler's sub-window.

``Recorder(est)`` stands in for the estimator that ``Runner`` drives and
forwards every call to it. At each superstep of ``capture`` it copies
the particle poses before the superstep's first predict, the controls of
its ticks, the state and observations that reach the update, and the
state it returns: device copies, made as they happen, since the kernels
write the state in place. The copies cost device memory and a few
milliseconds of device time each inside the window; the cells keep
their number small. With ``window=(start, n)`` it starts ``prof`` after
the update of superstep ``start`` and stops it after that of superstep
``start + n``, each end behind a device sync, and keeps the two host
times.
"""

from __future__ import annotations

import time

import torch


def clone_state(state):
    """A device copy of an estimator state (a tuple of tensors, possibly
    nested; other values as they are)."""
    if isinstance(state, torch.Tensor):
        return state.clone()
    if isinstance(state, tuple):
        return type(state)(*(clone_state(v) for v in state))
    return state


def particle_dict(state) -> dict:
    """The fields of a FastSLAM state as the reference reads them:
    logw, xv, Pv, lm, lm_P, n, table, and for the deferred filter the
    pending offspring bounds S and whether they are pending."""
    ps = getattr(state, "ps", state)
    out = dict(logw=ps.logw, xv=ps.xv, Pv=ps.Pv, lm=ps.lm, lm_P=ps.lm_P,
               n=ps.n, table=ps.da_table)
    if hasattr(state, "ps"):
        out.update(S=state.S, pending=bool(state.pending))
    return out


def _poses(state):
    return getattr(state, "ps", state).xv


class Recorder:
    """The estimator ``est``, recording at the supersteps of ``capture``
    (see the module's docstring); every other attribute is ``est``'s."""

    def __init__(self, est):
        self._est = est
        if hasattr(est, "predict_multi"):
            self.predict_multi = self._predict_multi
        self.arm()

    def __getattr__(self, name):
        return getattr(self._est, name)

    def arm(self, capture=(), window=None, prof=None) -> None:
        """Start a run: record at the supersteps ``capture``; profile
        ``window`` = (start, n) supersteps with ``prof``."""
        self.step = 0
        self.capture = set(capture)
        self.records = {}
        self.window, self.prof, self.window_times = window, prof, None

    def _record(self):
        return (self.records.setdefault(self.step, {"controls": []})
                if self.step in self.capture else None)

    def predict(self, state, generator, vn, gn, phi):
        rec = self._record()
        if rec is not None:
            rec.setdefault("xv0", _poses(state).clone())
            rec["controls"].append(torch.stack([vn, gn]).reshape(2))
        return self._est.predict(state, generator, vn, gn, phi)

    def _predict_multi(self, state, generator, controls):
        rec = self._record()
        if rec is not None:
            rec["xv0"] = _poses(state).clone()
            rec["controls"] = [controls.clone()]
        return self._est.predict_multi(state, generator, controls)

    def update(self, state, generator, z, ids, zmask):
        rec = self._record()
        if rec is not None:
            rec["pre"] = clone_state(state)
            rec["obs"] = (z.clone(), ids.clone(), zmask.clone())
        out = self._est.update(state, generator, z, ids, zmask)
        if rec is not None:
            rec["post"] = clone_state(out)
        self.step += 1
        if self.window is not None:
            start, n = self.window
            if self.step in (start, start + n):
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                now = time.perf_counter()
                if self.step == start:
                    self.window_times = [now]
                    self.prof.start()
                else:
                    self.prof.stop()
                    self.window_times.append(now)
        return out
