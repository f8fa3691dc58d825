"""Reduction of a ``torch.profiler`` trace to what the metric readers use.

The arithmetic follows ``coolchic_tpu_torch/utils/profile_step.py``
(``_device_table``: device time summed by kernel from the GPU events alone,
so no operator counts twice) and adds the timeline: the union of the GPU
events' intervals is the device's busy time, and the gaps between them are
named by the innermost host operation running at each gap's midpoint.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

TOP = 10
# Host-side CUDA runtime calls name no layer: a gap is named by the operator above them.
RUNTIME_PREFIXES = ("cuda", "cu", "Activity Buffer", "ProfilerStep", "Memcpy", "Memset")


class TraceSummary:
    """What one traced window showed: device busy seconds, the window's
    length, device seconds and launches by kernel name, and idle seconds by
    what the host was doing."""

    def __init__(self, window_s: float, busy_s: float, kernels: Dict[str, Tuple[float, int]],
                 idle_by_host: Dict[str, float], n_gpu_events: int):
        self.window_s = window_s
        self.busy_s = busy_s
        self.kernels = kernels
        self.idle_by_host = idle_by_host
        self.n_gpu_events = n_gpu_events

    def device_s(self) -> float:
        """Summed device seconds of every GPU event."""
        return sum(s for s, _n in self.kernels.values())

    def breakdown(self) -> Dict[str, List]:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:TOP]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[name[:120], s] for name, (s, _n) in ops],
                "idle_gaps": [[name[:120], s] for name, s in gaps]}


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            if end > out[-1][1]:
                out[-1] = (out[-1][0], end)
        else:
            out.append((start, end))
    return out


def summarize(events, window_start_ns: int, window_end_ns: int) -> TraceSummary:
    """Reduce raw profiler events (``prof.profiler.kineto_results.events()``)
    to a ``TraceSummary`` of the window [start, end] (profiler clock, ns)."""
    from torch.autograd import DeviceType

    gpu, host = [], []
    kernels: Dict[str, List] = defaultdict(lambda: [0.0, 0])
    for e in events:
        start, dur = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if dur <= 0:
                continue
            gpu.append((start, start + dur))
            k = kernels[e.name()]
            k[0] += dur * 1e-9
            k[1] += 1
        elif dur > 0 and not e.name().startswith(RUNTIME_PREFIXES):
            host.append((start, start + dur, e.name()))
    busy = _merge([(max(s, window_start_ns), min(t, window_end_ns)) for s, t in gpu
                   if t > window_start_ns and s < window_end_ns])
    busy_s = sum(t - s for s, t in busy) * 1e-9

    host.sort()
    starts = [h[0] for h in host]
    idle: Dict[str, float] = defaultdict(float)
    edges = [window_start_ns] + [x for iv in busy for x in iv] + [window_end_ns]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        mid = (g0 + g1) // 2
        name = "host outside any operator"
        # The innermost operator covering the midpoint: the latest start before it
        # whose end lies beyond it (a bounded walk back; operators nest shallowly).
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 400, -1), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        idle[name] += (g1 - g0) * 1e-9
    return TraceSummary((window_end_ns - window_start_ns) * 1e-9, busy_s,
                        {k: (v[0], v[1]) for k, v in kernels.items()}, dict(idle), len(gpu))


class Tracer:
    """Profiles units of work of the window (``with tracer.window():``
    blocks). The first runs unprofiled; the second under the device's
    activity alone, which costs the host little, and gives ``summary`` (busy
    and window seconds, kernels); the third also under the host's operators,
    whose recording slows the host, and gives only the names of the idle
    gaps (``host_summary``). Later units run unprofiled. A disabled tracer
    never profiles."""

    PLAN = (None, "device", "host")

    def __init__(self, enabled: bool, device):
        self.enabled = enabled
        self.device = device
        self.units = 0
        self.summary: Optional[TraceSummary] = None
        self.host_summary: Optional[TraceSummary] = None
        self.reduce_s = 0.0

    @property
    def done(self) -> bool:
        return not self.enabled or self.units >= len(self.PLAN)

    @contextmanager
    def window(self):
        kind = self.PLAN[self.units] if not self.done else None
        self.units += 1
        if kind is None:
            yield False
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        cuda = self.device.type == "cuda"
        if not cuda:
            activities = [ProfilerActivity.CPU]
        elif kind == "device":
            activities = [ProfilerActivity.CUDA]
        else:
            activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        if cuda:
            torch.cuda.synchronize(self.device)
        with profile(activities=activities) as prof:
            # The profiler stamps host and device events on the wall clock (ns).
            start = time.time_ns()
            yield True
            if cuda:
                torch.cuda.synchronize(self.device)
            end = time.time_ns()
        t0 = time.perf_counter()
        summary = summarize(prof.profiler.kineto_results.events(), start, end)
        if kind == "device":
            self.summary = summary
        else:
            self.host_summary = summary
        self.reduce_s += time.perf_counter() - t0

    def breakdown(self) -> Dict[str, List]:
        """The device's top operations (device-only unit) and the longest idle
        gaps by host operator (host unit, whose timeline the recording slows)."""
        out = self.summary.breakdown()
        if self.host_summary is not None:
            out["idle_gaps"] = self.host_summary.breakdown()["idle_gaps"]
        return out
