"""Host spans of the port's phases, on the clock of the profiler's trace.

``with span("filter.update"): ...`` records the block's start and end
while a ``torch.profiler`` is active, and nothing otherwise: the
benchmark's traced sub-window, the CLI's ``-profile`` and
``runtime.profiling`` turn spans on by running the profiler; nothing
else does. Off, ``span`` reads one module global of torch's profiler and
returns a shared no-op context: it reads no clock and allocates nothing.

A span is kept only if the profiler is active both when it is entered
and when it ends, so the store holds what lies wholly inside a profiled
window (``cut()`` counts the spans that outlived the profiler). A record
is ``(name, id, parent id, t0_ns, t1_ns)``: the parent is the innermost
recorded span open at entry (None if there is none), and the stamps are
``time.time_ns()``, the Unix nanoseconds on which the profiler stamps its
host events (an event's start is ``trace_start_ns() + 1000 *
time_range.start``), so a span and the operations inside it share one
clock. Records are appended as spans end: children before parents.

Spans never go through ``torch.profiler.record_function``: with the CUDA
activity on, the profiler copies each such range onto the device's
timeline as an annotation event, which a reader of device events would
take for device work; and entering one costs microseconds even with the
profiler off.
"""

from __future__ import annotations

import itertools
import time

from torch.autograd import profiler as _profiler

CAPACITY = 2 ** 20     # records kept; later ones are counted in dropped()

_clock = time.time_ns
_records: list = []
_open: list = []       # ids of the recorded spans still open, innermost last
_ids = itertools.count()
_counts = {"dropped": 0, "cut": 0}


class _Off:
    """The shared context of a span entered with the profiler off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:

    __slots__ = ("name", "id", "parent", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.id = next(_ids)
        self.parent = _open[-1] if _open else None
        _open.append(self.id)
        self.t0 = _clock()
        return None

    def __exit__(self, *exc):
        t1 = _clock()
        _open.pop()
        if not _profiler._is_profiler_enabled:
            _counts["cut"] += 1
        elif len(_records) < CAPACITY:
            _records.append((self.name, self.id, self.parent, self.t0, t1))
        else:
            _counts["dropped"] += 1
        return False


def span(name: str):
    """A context manager that records the block as the span ``name``
    while a profiler is active (see the module's docstring)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def records() -> list:
    """The recorded spans, ``(name, id, parent id, t0_ns, t1_ns)``, in
    the order they ended."""
    return list(_records)


def clear() -> None:
    """Empty the store and zero its counts of dropped and cut spans."""
    _records.clear()
    _counts["dropped"] = _counts["cut"] = 0


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
