"""Structured per-stage timing + counters (port of
``pslam_tpu/utils/trace.py``).

Named stages with count/total/max, a context-manager API, and optional
``torch.profiler.record_function`` spans, so each stage shows as a named
range in a ``torch.profiler`` trace. Used by the CLI app.
"""

from __future__ import annotations

import contextlib
import time


class StageTimers:
    def __init__(self, use_profiler_ranges: bool = False):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self.maxima: dict[str, float] = {}
        self.use_profiler_ranges = use_profiler_ranges

    @contextlib.contextmanager
    def stage(self, name: str):
        ctx = contextlib.nullcontext()
        if self.use_profiler_ranges:
            import torch.profiler

            ctx = torch.profiler.record_function(name)
        t0 = time.perf_counter()
        with ctx:
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
