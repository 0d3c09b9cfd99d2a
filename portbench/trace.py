"""The traced window: `torch.profiler` over it, reduced in memory (nothing
is written to disk) to what the per-layer readers and the result line use.

- `kernels`: (name, start, end) of every device activity (kernels,
  copies, sets) in seconds from the window's start;
- `busy_s`: the length of their union; `window_s`: the window's length;
- `device_ops`: the ten names with the most device time;
- `idle_gaps`: the ten longest stretches with nothing on the device, each
  named by the innermost host span of the harness (`probes.Recorder`)
  under its middle.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field


@dataclass
class Trace:
    window_s: float = 0.0
    kernels: list = field(default_factory=list)
    host_ranges: list = field(default_factory=list)
    busy_s: float = 0.0

    def device_seconds(self, match) -> float:
        """Device seconds of the activities whose name `match` accepts."""
        return sum(end - start for name, start, end in self.kernels if match(name))

    def device_ops(self, n: int = 10) -> list:
        by_name: dict = {}
        for name, start, end in self.kernels:
            by_name[name] = by_name.get(name, 0.0) + (end - start)
        return sorted(([k[:160], v] for k, v in by_name.items()), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        merged = _union(self.kernels)
        gaps, prev_end = [], 0.0
        for start, end in merged + [(self.window_s, self.window_s)]:
            if start > prev_end:
                gaps.append((prev_end, start))
            prev_end = max(prev_end, end)
        gaps.sort(key=lambda g: -(g[1] - g[0]))
        out = []
        for start, end in gaps[:n]:
            mid = 0.5 * (start + end)
            under = [(r_end - r_start, name) for name, r_start, r_end in self.host_ranges
                     if r_start <= mid <= r_end]
            out.append([min(under)[1] if under else "host: outside the harness's ranges",
                        end - start])
        return out


def _union(intervals) -> list:
    spans = sorted((start, end) for _, start, end in intervals)
    merged: list = []
    for start, end in spans:
        if merged and start <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], end))
        else:
            merged.append((start, end))
    return merged


@contextlib.contextmanager
def window(trace: Trace | None, spans: list | None = None):
    """Profile the block when `trace` is given, and fill it in on exit (the
    device is synchronised first, so every launch of the window is in);
    `spans` are the host spans (label, start_ns, end_ns) on the wall clock,
    the profiler's own."""
    import torch

    if trace is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        trace.window_s = time.perf_counter() - t0
    _reduce(prof, trace, spans or [])


def _reduce(prof, trace: Trace, spans: list) -> None:
    results = prof.profiler.kineto_results
    origin = results.trace_start_ns()
    device = []
    for e in results.events():
        if e.device_type().name == "CUDA" and not e.is_user_annotation():
            start = (e.start_ns() - origin) * 1e-9
            device.append((e.name(), start, start + e.duration_ns() * 1e-9))
    host = [(label, (s0 - origin) * 1e-9, (s1 - origin) * 1e-9) for label, s0, s1 in spans]
    if not device:
        raise RuntimeError("the profiler recorded no device activity in the window")
    trace.kernels = device
    trace.host_ranges = host
    trace.busy_s = sum(end - start for start, end in _union(device))
    trace.window_s = max(trace.window_s, max(end for _, _, end in device))
