"""Tracing / profiling hooks.

Counterpart of ``ragmeup_tpu/utils/profiling.py``. ``StageTimer`` collects
per-stage wall times (the pipeline already reports them per request in
``timings``); ``trace_stage`` wraps a stage in
``torch.profiler.record_function`` so a ``torch.profiler`` trace segments
by pipeline stage."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict


class StageTimer:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {k: {"total_s": self.totals[k], "count": self.counts[k],
                    "mean_ms": 1e3 * self.totals[k] / max(self.counts[k], 1)}
                for k in self.totals}


@contextlib.contextmanager
def trace_stage(name: str):
    """A ``torch.profiler`` range named ``name`` around the stage."""
    import torch
    with torch.profiler.record_function(name):
        yield
