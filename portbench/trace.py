"""The traced segment's reduction: device busy time as the union of the
kernel, copy and fill intervals, the device operations that took most
time, the longest idle gaps named by what the host was doing, and each
hand kernel's device time.

The hand kernels are found by the names of the port's CUDA kernels (the
``__global__`` functions of its ``csrc/``) in the trace, by wrapper.
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

# the port's wrapper -> the device kernels its launches run
KERNEL_NAMES = {
    "sa_group": ("sa_group_kernel", "sa_group_warp_kernel"),
    "sa_mlp_max": ("sa_mlp_max_kernel",),
    "sa_group_scatter": ("sa_scatter_kernel",),
    "fps": ("fps_kernel", "fps_global_kernel"),
    "ball_query": ("ball_warp_kernel", "ball_split_kernel"),
}
SEGMENT = "portbench.segment"
GAP_MIN_US = 5.0  # shorter gaps are the launch queue's own spacing
HOST_LOOKBACK_US = 20_000.0


_WRAPPER_OF = {k: wrapper for wrapper, names in KERNEL_NAMES.items() for k in names}


def wrapper_of(kernel_name: str) -> str:
    """The port's wrapper whose launch ran this device kernel (named in the
    trace as, say, ``void (anonymous namespace)::sa_mlp_max_kernel<float>(float
    const*, ...)``), or ''."""
    for word in re.findall(r"[A-Za-z_]\w*", kernel_name):
        if word in _WRAPPER_OF:
            return _WRAPPER_OF[word]
    return ""


def _union(intervals: List[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """Total covered length and the gaps between covered stretches."""
    total, gaps = 0.0, []
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            total += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total, gaps


def events(prof: torch.profiler.profile) -> List[Tuple[str, bool, bool, float, float]]:
    """The profiler's raw events as ``(name, on the device, a user
    annotation, start, end)``, times in microseconds; read from its
    results directly, which takes a twentieth of building its
    ``events()``."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.device_type() == cuda, e.is_user_annotation(), e.start_ns() / 1e3,
             e.end_ns() / 1e3) for e in prof.profiler.kineto_results.events()]


def profile(fn: Callable[[], None], device: torch.device) -> Tuple[Dict, Dict[str, int]]:
    """Run ``fn`` under the profiler inside the benchmark's annotation
    ``portbench.segment``: its :func:`reduce`, and the launches the port's
    counters saw, by wrapper."""
    from pointcloud_orientation_tpu_torch.ops import cuda_kernels as K

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    before = K.launch_counts()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(SEGMENT):
            fn()
    launches = {k: v - before[k] for k, v in K.launch_counts().items()}
    evts = events(prof)
    window = next((s, e) for n, dev, _, s, e in evts if n == SEGMENT and not dev)
    return reduce(evts, window), launches


def reduce(evts, window: Tuple[float, float]) -> Dict:
    """``evts`` (:func:`events`) of the traced segment, ``window`` its
    start and end (the span of the benchmark's own annotation). Returns
    ``busy_us``, ``window_us``, ``kernels`` (device kernel count),
    ``wrapper_us`` (device time by hand-kernel wrapper), ``device_ops``
    and ``idle_gaps`` (``[name, seconds]``, the ten largest)."""
    w0, w1 = window
    device, host = [], []
    for name, on_device, annotation, s, e in evts:
        if on_device:
            if not annotation:
                device.append((name, max(s, w0), min(e, w1)))
        else:
            host.append((name, s, e))
    device = [(n, s, e) for n, s, e in device if e > s]
    busy, gaps = _union([(s, e) for _, s, e in device])
    by_op: Dict[str, float] = defaultdict(float)
    wrapper_us: Dict[str, float] = defaultdict(float)
    kernels = 0
    for name, s, e in device:
        by_op[name] += e - s
        low = name.lower()
        if not (low.startswith("memcpy") or low.startswith("memset")):
            kernels += 1
        wrapper = wrapper_of(name)
        if wrapper:
            wrapper_us[wrapper] += e - s
    starts = [s for _, s, e in device]
    first, last = (min(starts), max(e for _, _, e in device)) if device else (w0, w0)
    gaps = [(w0, first)] + gaps + [(last, w1)]
    host = sorted((s, e, n) for n, s, e in host if n != SEGMENT)
    h_start = np.array([s for s, _, _ in host])
    h_end = np.array([e for _, e, _ in host])
    idle: Dict[str, float] = defaultdict(float)
    for gs, ge in gaps:
        if ge - gs < GAP_MIN_US:
            continue
        # the host operation that overlaps the gap longest names it (of equal
        # overlaps the later-starting, the innermost); operations that began
        # more than HOST_LOOKBACK_US before the gap are not searched
        lo, hi = np.searchsorted(h_start, [gs - HOST_LOOKBACK_US, ge])
        best = "(no host operation)"
        if hi > lo:
            ov = np.minimum(h_end[lo:hi], ge) - np.maximum(h_start[lo:hi], gs)
            k = hi - 1 - int(np.argmax(ov[::-1]))
            if ov[k - lo] > 0:
                best = host[k][2]
        idle[best] += (ge - gs) / 1e6
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_us": busy, "window_us": w1 - w0, "kernels": kernels,
        "wrapper_us": dict(wrapper_us),
        "device_ops": [[n[:160], us / 1e6] for n, us in top],
        "idle_gaps": [[n[:160], s] for n, s in sorted(idle.items(), key=lambda kv: -kv[1])[:10]],
    }
