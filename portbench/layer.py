"""The arithmetic of the per-layer readers (``metrics/<name>.py``), over
the context a traced run hands them:

- ``kind``: ``"train"`` or ``"serve"``, the end-to-end metric's side;
- ``trace``: :func:`.trace.reduce` of the traced segment;
- ``units``: the train steps or requests of the traced segment;
- ``flops``, ``window_s``: the model FLOPs the untraced window did, and its
  seconds; ``service_s`` (serving) each of its requests' service seconds;
- ``calls``: the hand-kernel calls the traced segment's work needs, by the
  port's wrapper, each its least seconds (:func:`.costs.kernel_calls`);
- ``launches``: the launches the port's counters saw in the segment, by
  wrapper.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .costs import PEAK_F32_PRODUCT_FLOPS


def idle_pct(ctx: Dict, kind: str) -> Optional[float]:
    """Share of the traced segment in which no kernel, copy or fill ran."""
    if ctx["kind"] != kind or ctx["trace"]["window_us"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["trace"]["busy_us"] / ctx["trace"]["window_us"])


def launches_per_unit(ctx: Dict, kind: str) -> Optional[float]:
    """Device kernels in the traced segment over its steps or requests."""
    if ctx["kind"] != kind or not ctx["units"]:
        return None
    return ctx["trace"]["kernels"] / ctx["units"]


def service_p95_ms(ctx: Dict) -> Optional[float]:
    """95th percentile of the untraced window's service times (call to
    result, the wait for the predictor left out)."""
    if ctx["kind"] != "serve" or not ctx["service_s"]:
        return None
    return float(np.percentile(np.asarray(ctx["service_s"]) * 1e3, 95))


def mfu(ctx: Dict, kind: str) -> Optional[float]:
    """The model's products over the untraced window at the 3xTF32 peak."""
    if ctx["kind"] != kind or ctx["window_s"] <= 0:
        return None
    return 100.0 * ctx["flops"] / ctx["window_s"] / PEAK_F32_PRODUCT_FLOPS


def roofline_pct(ctx: Dict, kind: str) -> Optional[float]:
    """The hand kernels' summed least time over their summed device time in
    the traced segment. Nothing to read where a wrapper's launches, as the
    counters saw them, differ from the calls the work needs by
    :func:`.costs.kernel_calls` (a hand kernel added, removed or called
    otherwise: ``costs.kernel_calls`` has to follow it first), or where a
    wrapper the work needs has no device time in the trace."""
    if ctx["kind"] != kind or not ctx["calls"]:
        return None
    launched = {w for w, n in ctx["launches"].items() if n}
    least = device = 0.0
    for wrapper in launched | set(ctx["calls"]):
        calls = ctx["calls"].get(wrapper, [])
        us = ctx["trace"]["wrapper_us"].get(wrapper, 0.0)
        if ctx["launches"].get(wrapper, 0) != len(calls) or us <= 0:
            return None
        least += sum(calls)
        device += us / 1e6
    return 100.0 * least / device
