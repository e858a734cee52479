"""Tracing of the port: named stage timers for the CLI, and the program's
spans on the profiler's clock.

``StageTimers`` (port of ``pslam_tpu/utils/trace.py``): named stages with
count/total/max and a context-manager API. Used by the CLI app.

``RECORDER`` (a ``SpanRecorder``) holds the spans that ``SlamSystem`` opens
at its layer boundaries: the tracked frame (``frame``, ``track``,
``track.step``, ``track.orb``, ``track.pose``, ...) and the keyframe event
(``mapping``, ``mapping.insert``, ``local_ba.dispatch``, ...). It is off by
default, and then each ``span(...)`` returns one shared no-op context
manager: it reads no clock and never synchronizes the device. To read them,
turn it on, run frames, and take the records::

    from pslam_tpu_torch.utils import trace
    trace.RECORDER.enable()
    slam.track_rgbd(gray, depth, t)
    for name, start_ns, end_ns, parent, frame, attrs in trace.RECORDER.records():
        ...
    trace.RECORDER.clear()   # between windows: the list grows while on

Times are ``time.time_ns()``, the wall clock that ``torch.profiler`` stamps
its events with, so a record can be placed against the device activity of a
profiler window. Each span is also a ``torch.profiler.record_function``
range of the same name, so a chrome trace shows the stages and a profiler
window links the device work to them. Spans stay at stage boundaries (about
12 on a tracked frame, 25 on a keyframe frame): none opens inside an LM
iteration.
"""

from __future__ import annotations

import contextlib
import time

import torch


class StageTimers:
    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self.maxima: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1
        self.maxima[name] = max(self.maxima.get(name, 0.0), dt)

    def mean(self, name: str) -> float:
        c = self.counts.get(name, 0)
        return self.totals.get(name, 0.0) / c if c else 0.0

    def report(self) -> str:
        rows = ["stage              count   mean_ms    max_ms  total_s"]
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            rows.append(
                f"{name:<18} {self.counts[name]:>5} "
                f"{self.mean(name) * 1e3:>9.2f} {self.maxima[name] * 1e3:>9.2f} "
                f"{self.totals[name]:>8.2f}"
            )
        return "\n".join(rows)

    def as_dict(self) -> dict:
        return {
            n: {
                "count": self.counts[n],
                "mean_s": self.mean(n),
                "max_s": self.maxima[n],
                "total_s": self.totals[n],
            }
            for n in self.totals
        }


class _Off:
    """The context manager of every span while the recorder is off."""

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("rec", "name", "attrs", "index", "generation", "t0", "frame", "parent",
                 "range")

    def __init__(self, rec: "SpanRecorder", name: str, attrs: dict):
        self.rec, self.name, self.attrs = rec, name, attrs

    def __enter__(self):
        rec = self.rec
        self.generation = rec._generation
        self.parent = rec._open[-1] if rec._open else None
        inherited = rec._records[self.parent][4] if self.parent is not None else None
        self.frame = self.attrs.get("frame", inherited)
        self.index = len(rec._records)
        rec._records.append(None)
        rec._open.append(self.index)
        self.range = torch.profiler.record_function(self.name)
        self.t0 = time.time_ns()
        rec._records[self.index] = (self.name, self.t0, None, self.parent, self.frame,
                                    self.attrs)
        self.range.__enter__()
        return self

    def __exit__(self, *exc):
        self.range.__exit__(*exc)
        t1 = time.time_ns()
        rec = self.rec
        if rec._generation == self.generation:
            rec._open.pop()
            rec._records[self.index] = (self.name, self.t0, t1, self.parent, self.frame,
                                        self.attrs)
        return False


class SpanRecorder:
    """Process-wide spans of the program, in memory.

    A record is ``(name, start_ns, end_ns, parent, frame, attrs)``:
    ``parent`` is the index in ``records()`` of the span open around it (or
    None), ``frame`` the id given to the enclosing ``frame`` span (as
    ``frame=``), ``attrs`` the keywords given to ``span``. A span still open
    has ``end_ns`` None. Records keep the order in which the spans opened.
    """

    def __init__(self):
        self.on = False
        self._records: list = []
        self._open: list[int] = []
        self._generation = 0

    def enable(self):
        self.on = True

    def disable(self):
        """Stop opening spans; those open close and are kept."""
        self.on = False

    def records(self) -> list:
        return list(self._records)

    def clear(self):
        """Drop every record. A span open now closes unrecorded."""
        self._records = []
        self._open = []
        self._generation += 1

    def span(self, name: str, **attrs):
        if not self.on:
            return _OFF
        return _Span(self, name, attrs)


RECORDER = SpanRecorder()
span = RECORDER.span
