"""Profiling helpers: named wall-clock segments and ``torch.profiler`` traces.

Counterpart of ``pointcloud_orientation_tpu/utils/profiling.py``:
:class:`StepTimer` accumulates host-clock segments (data, step, ...);
:func:`capture_trace` records a ``torch.profiler`` trace of a region (the
host and, where there is one, the card) as a Chrome trace
``<log_dir>/trace.json``, which is what ``--profile-dir`` of the training
CLI writes; :func:`trace_annotation` names a region in that trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch


class StepTimer:
    """Accumulate named wall-clock segments; read their averages at an
    epoch's end. Host clock: synchronise the device inside a segment that
    should include its work."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def track(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def averages(self) -> Dict[str, float]:
        return {k: self.totals[k] / max(self.counts[k], 1) for k in self.totals}

    def reset(self):
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def trace_annotation(name: str):
    """Name a region in the profiler's timeline (``record_function``)."""
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def capture_trace(log_dir: str):
    """Record a ``torch.profiler`` trace of the region: host activity, and
    the card's kernels when CUDA is available. Writes
    ``<log_dir>/trace.json`` (Chrome trace format: ``chrome://tracing`` or
    Perfetto) when the region ends, also when it raises."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
