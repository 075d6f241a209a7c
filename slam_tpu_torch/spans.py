"""Host spans of the port's phases: each times itself on one clock, and
is recorded on the clock of the profiler's trace while one is active.

``with span("filter.update"): ...`` stamps the block's entry and exit
with ``_clock`` (``time.time_ns()``), profiler or not.

**The clocks.** Within the open ``superstep`` span each name's
inclusive duration is added to that name's total for the superstep
(several ``filter.predict`` spans sum); when the ``superstep`` ends it
writes one row into a fixed ring of RING rows: its own duration, each
name's total in a column the name took at its first use (COLUMNS at
most, ``superstep`` first; a name past them raises ``RuntimeError``),
and ``traced``, set if a profiler was active at the superstep's entry or
at its exit. Spans outside a superstep (``run.init``, ``run.to_host``,
``ckpt.save``, ``config5.*``, BA's) are in no row. Totals are inclusive,
so a span added later beneath another moves none of its parent's
totals. ``steps(n)`` returns the last ``n`` rows; the ring (RING = 2^15
rows of int64, ~8 MB) is allocated at import and its oldest rows are
overwritten once it is full. Each name has one timer, which keeps this
accounting; with the profiler off a span is its name's timer: two clock
reads and two list updates, no record. The clocks assume one thread:
the port starts none.

**The store.** While a ``torch.profiler`` is active (the benchmark's
traced sub-window, the CLI's ``-profile``, ``runtime.profiling``; nothing
else turns it on) each span is also recorded, with its timer's stamps.
A span is kept only if the profiler is active both when it is entered
and when it ends, so the store holds what lies wholly inside a profiled
window (``cut()`` counts the spans that outlived the profiler). A record
is ``(name, id, parent id, t0_ns, t1_ns)``: the parent is the innermost
recorded span open at entry (None if there is none), and the stamps are
the clock's, the Unix nanoseconds on which the profiler stamps its host
events (an event's start is ``trace_start_ns() + 1000 *
time_range.start``), so a span and the operations inside it share one
clock, and a traced row's totals are the sums of its superstep's
records. Records are appended as spans end: children before parents.

Spans never go through ``torch.profiler.record_function``: with the CUDA
activity on, the profiler copies each such range onto the device's
timeline as an annotation event, which a reader of device events would
take for device work; and entering one costs microseconds even with the
profiler off.
"""

from __future__ import annotations

import itertools
import time

import numpy as np
from torch.autograd import profiler as _profiler

CAPACITY = 2 ** 20     # records kept; later ones are counted in dropped()
RING = 2 ** 15         # superstep rows kept; later ones overwrite the oldest
COLUMNS = 32           # names a row holds, "superstep" first

_clock = time.time_ns
_records: list = []
_open: list = []       # ids of the recorded spans still open, innermost last
_ids = itertools.count()
_counts = {"dropped": 0, "cut": 0}

_cols: dict = {"superstep": 0}     # name -> its column in the ring
_timers: dict = {}     # name -> its _Timer, shared by all its spans
_acc = [0] * COLUMNS   # the open superstep's totals by column
_ZERO = [0] * COLUMNS
_ring = np.zeros((RING, COLUMNS), np.int64)
_traced = np.zeros(RING, bool)
_rows = 0              # rows written since the last clear()


class _Timer:
    """The clock of a name's spans, one object a name: it adds each
    span's duration to the name's total as the exit's stamp less the
    entry's, so that nested spans of one name need no stack. Off the
    profiler a span is its name's timer; a ``_Span`` calls its ``start``
    and ``stop`` and records their stamps."""

    __slots__ = ("col",)

    def __init__(self, col: int):
        self.col = col

    def start(self) -> int:
        t = _clock()
        _acc[self.col] -= t
        return t

    def stop(self) -> int:
        t = _clock()
        _acc[self.col] += t
        return t

    def __enter__(self):
        _acc[self.col] -= _clock()      # start(), less a call

    def __exit__(self, et, ev, tb):
        _acc[self.col] += _clock()      # stop(), less a call
        return False


class _StepTimer(_Timer):
    """``superstep``'s: its start zeroes the totals (what spans outside a
    superstep added is dropped there) and notes whether a profiler is
    active; its stop writes the row."""

    __slots__ = ("traced",)

    def start(self) -> int:
        _acc[:] = _ZERO
        self.traced = _profiler._is_profiler_enabled
        return _Timer.start(self)

    def stop(self) -> int:
        global _rows
        t = _Timer.stop(self)
        row = _rows % RING
        _ring[row] = _acc
        _traced[row] = self.traced or _profiler._is_profiler_enabled
        _rows += 1
        return t

    def __enter__(self):
        self.start()

    def __exit__(self, et, ev, tb):
        self.stop()
        return False


def _timer(name: str) -> _Timer:
    """The timer of ``name``, made at its first use, which gives the name
    the ring's next column; a name past COLUMNS is refused."""
    timer = _timers.get(name)
    if timer is None:
        col = _cols.get(name)
        if col is None:
            col = len(_cols)
            if col >= COLUMNS:
                raise RuntimeError(
                    f"span {name!r}: the ring holds {COLUMNS} span names "
                    f"({', '.join(_cols)}); raise spans.COLUMNS")
            _cols[name] = col
        timer = _timers[name] = (_StepTimer if col == 0 else _Timer)(col)
    return timer


class _Span:
    """A span entered with the profiler active: timed by its name's
    timer, and recorded with the timer's stamps."""

    __slots__ = ("name", "timer", "id", "parent", "t0")

    def __init__(self, name: str):
        self.name = name
        self.timer = _timer(name)

    def __enter__(self):
        self.id = next(_ids)
        self.parent = _open[-1] if _open else None
        _open.append(self.id)
        self.t0 = self.timer.start()
        return None

    def __exit__(self, et, ev, tb):
        t1 = self.timer.stop()
        _open.pop()
        if not _profiler._is_profiler_enabled:
            _counts["cut"] += 1
        elif len(_records) < CAPACITY:
            _records.append((self.name, self.id, self.parent, self.t0, t1))
        else:
            _counts["dropped"] += 1
        return False


def span(name: str):
    """A context manager that times the block as the span ``name``, and
    records it while a profiler is active (see the module's docstring)."""
    if _profiler._is_profiler_enabled:
        return _Span(name)
    timer = _timers.get(name)
    return timer if timer is not None else _timer(name)


def steps(n: int | None = None) -> dict | None:
    """The last ``n`` superstep rows (all held if None), oldest first:
    ``{"superstep": int64[n], "traced": bool[n], <name>: int64[n], ...}``,
    durations in nanoseconds, a column for each name used since the last
    ``clear()``; None if the ring holds fewer than ``n``."""
    held = min(_rows, RING)
    n = held if n is None else n
    if n > held:
        return None
    idx = np.arange(_rows - n, _rows) % RING
    out = {"superstep": _ring[idx, 0], "traced": _traced[idx]}
    for name, col in _cols.items():
        out[name] = _ring[idx, col]
    return out


def records() -> list:
    """The recorded spans, ``(name, id, parent id, t0_ns, t1_ns)``, in
    the order they ended."""
    return list(_records)


def clear() -> None:
    """Empty the store and the ring, zero the counts of dropped and cut
    spans, and free the ring's columns."""
    global _rows
    _records.clear()
    _counts["dropped"] = _counts["cut"] = 0
    _rows = 0
    _cols.clear()
    _cols["superstep"] = 0
    _timers.clear()


def dropped() -> int:
    """Spans not kept because the store held CAPACITY records."""
    return _counts["dropped"]


def cut() -> int:
    """Spans not kept because the profiler stopped before they ended."""
    return _counts["cut"]


def beneath(recs, name: str) -> list:
    """The records of ``recs`` that have an ancestor in ``recs`` named
    ``name``."""
    by_id = {r[1]: r for r in recs}
    out = []
    for r in recs:
        p = by_id.get(r[2])
        while p is not None and p[0] != name:
            p = by_id.get(p[2])
        if p is not None:
            out.append(r)
    return out


def summary(recs=None, within: str | None = None) -> dict:
    """{name: {"count", "total_s", "self_s"}} of ``recs`` (the store by
    default), or of those beneath a span named ``within``. A span's self
    time is its duration less that of its recorded children."""
    recs = records() if recs is None else recs
    covered: dict = {}
    for r in recs:
        covered[r[2]] = covered.get(r[2], 0) + r[4] - r[3]
    out: dict = {}
    for r in (recs if within is None else beneath(recs, within)):
        s = out.setdefault(r[0], {"count": 0, "total_s": 0.0,
                                  "self_s": 0.0})
        s["count"] += 1
        s["total_s"] += (r[4] - r[3]) * 1e-9
        s["self_s"] += (r[4] - r[3] - covered.get(r[1], 0)) * 1e-9
    return out
