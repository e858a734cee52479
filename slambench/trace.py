"""Spans and the device trace of a ``--trace 1`` run.

The benchmark records spans from its own files: it wraps named functions of
the program from outside, for the traced run only, and leaves the program's
files as they are. A span target is ``"module:Qualified.name"``; a per-layer
reader declares the spans it reads (``SPANS`` in its file), and the harness
installs the union of them.

Each wrapped call is a ``torch.profiler.record_function`` range named
``slambench.<span>`` and, while ``Spans.timing`` is on, a host-clock record
(start, end). While ``Spans.capture`` is on, a reader's ``capture`` function
keeps what it needs of the call's arguments (shapes, for operation counts).

``device_trace`` reads the profiler's raw trace (building the profiler's
event tree for the ~20,000 activities of a frame takes longer than the
frame; a copy of ``pslam_tpu_torch/utils/profile.py``'s reader) and links
each device activity to the CUDA call that launched it, and so to the
spans whose ranges held that call.
"""

from __future__ import annotations

import bisect
import functools
import importlib
import inspect
import time
from collections import defaultdict

PREFIX = "slambench."


def resolve(target: str):
    """``"module:Qualified.name"`` -> (owner object, attribute name)."""
    mod_name, _, qual = target.partition(":")
    owner = importlib.import_module(mod_name)
    *path, attr = qual.split(".")
    for p in path:
        owner = getattr(owner, p)
    if not hasattr(owner, attr):
        raise AttributeError(f"span target {target} does not exist")
    return owner, attr


class Spans:
    """Host-clock spans and captured arguments of wrapped calls."""

    def __init__(self):
        self.records: dict[str, list[tuple[float, float]]] = defaultdict(list)
        self.captured: dict[str, list] = defaultdict(list)
        self.timing = False
        self.capture = False
        self._undo = []

    def install(self, target: str, name: str, capture=None):
        """Wrap ``target``; a ``staticmethod`` or ``classmethod`` stays one,
        and ``remove`` puts back the object that was there."""
        import torch

        owner, attr = resolve(target)
        raw = inspect.getattr_static(owner, attr)
        kind = type(raw) if isinstance(raw, (staticmethod, classmethod)) else None
        fn = raw.__func__ if kind else raw
        records, captured, label = self.records[name], self.captured[name], PREFIX + name

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if self.capture and capture is not None:
                captured.append(capture(args, kwargs))
            t0 = time.perf_counter()
            try:
                with torch.profiler.record_function(label):
                    return fn(*args, **kwargs)
            finally:
                if self.timing:
                    records.append((t0, time.perf_counter()))

        setattr(owner, attr, kind(wrapper) if kind else wrapper)
        self._undo.append((owner, attr, raw))

    def remove(self):
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)
        self._undo.clear()

    def total_s(self, name: str) -> float:
        return sum(b - a for a, b in self.records.get(name, ()))

    def count(self, name: str) -> int:
        return len(self.records.get(name, ()))


class DeviceTrace:
    """The device activities of one profiler window, each linked to the
    spans whose ranges held the host call that launched it."""

    def __init__(self, activities, ranges, window_s: float):
        # activities: [(name, start_ns, end_ns, launch host ns or None)]
        self.activities = activities
        self.ranges = ranges  # span name -> sorted [(start_ns, end_ns)]
        self.window_s = window_s

    def _in(self, name: str, ns) -> bool:
        iv = self.ranges.get(name)
        if not iv or ns is None:
            return False
        k = bisect.bisect_right(iv, (ns, float("inf"))) - 1
        return k >= 0 and iv[k][0] <= ns <= iv[k][1]

    def under(self, name: str):
        """The activities launched inside ``name``'s ranges."""
        return [a for a in self.activities if self._in(name, a[3])]

    def busy_s(self) -> float:
        """Seconds in which some activity ran: the union of their intervals."""
        busy, end = 0, None
        for _, s, e, _ in sorted(self.activities, key=lambda a: a[1]):
            if end is None or s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy / 1e9

    def top_ops(self, k: int = 10):
        by = defaultdict(int)
        for name, s, e, _ in self.activities:
            by[name] += e - s
        return [[n, ns / 1e9] for n, ns in sorted(by.items(), key=lambda x: -x[1])[:k]]

    def idle_gaps(self, span_order, k: int = 10):
        """Idle seconds between device activities, summed by the innermost
        span the host was in when the gap began (``span_order``: outermost
        first); ``outside spans`` where it was in none."""
        acts = sorted(self.activities, key=lambda a: a[1])
        by = defaultdict(int)
        end = None
        for _, s, e, _ in acts:
            if end is not None and s > end:
                label = "outside spans"
                for name in span_order:
                    if self._in(name, end):
                        label = name
                by[label] += s - end
            end = e if end is None else max(end, e)
        return [[n, ns / 1e9] for n, ns in sorted(by.items(), key=lambda x: -x[1])[:k]]


def device_trace(prof, window_s: float, name_chars: int = 120) -> DeviceTrace:
    """Read ``prof``'s raw kineto events into a ``DeviceTrace``. A device
    activity's launch time is that of the CUDA runtime or driver call with
    its correlation id (``cudaLaunchKernel`` and its kin, made by PyTorch or
    by the kernels' C libraries alike); failing that, the start of the
    operator it is linked to. Names are cut to ``name_chars``."""
    from torch.autograd import DeviceType

    events = list(prof.profiler.kineto_results.events())
    runtime_start, op_start = {}, {}
    ranges = defaultdict(list)
    device = []
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            if name.startswith("cu"):
                runtime_start[e.correlation_id()] = e.start_ns()
            elif e.linked_correlation_id() == 0:
                op_start[e.correlation_id()] = e.start_ns()
            if name.startswith(PREFIX):
                ranges[name[len(PREFIX):]].append((e.start_ns(), e.end_ns()))
        elif e.device_type() == DeviceType.CUDA and not name.startswith(PREFIX) \
                and not e.is_user_annotation():
            device.append(e)
    acts = [(e.name()[:name_chars], e.start_ns(), e.end_ns(),
             runtime_start.get(e.correlation_id(), op_start.get(e.linked_correlation_id())))
            for e in device]
    return DeviceTrace(acts, {k: sorted(v) for k, v in ranges.items()}, window_s)
