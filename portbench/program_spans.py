"""The port's own spans (`wav2vec2_tpu_torch.utils.spans`, recorded while
the traced window's profiler runs), as the per-layer readers see them: the
spans of the window, on the trace's time axis.

`trace.py` puts the harness's spans (`probes.Recorder`, wall-clock ns) on
that axis as seconds from the profiler's start; the origin it used comes
back from any of them, since `run.recorder.spans[i]` and
`run.trace.host_ranges[i]` are the same span. Every reader here returns
None where there is nothing to read: an untraced run, a program without
spans (no `utils.spans`), or a window that recorded no such span.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

OUTSIDE = "outside the program"


@dataclass
class Span:
    name: str
    start: float  # seconds from the trace's origin
    end: float
    parent: int | None
    counts: dict
    device_s: float | None


def origin_ns(run) -> int | None:
    """The profiler's start on the wall clock, in ns, as `trace.py` used it."""
    if run.trace is None or run.recorder is None or not run.trace.host_ranges:
        return None
    _, start_ns, _ = run.recorder.spans[0]
    _, start_s, _ = run.trace.host_ranges[0]
    return start_ns - round(start_s * 1e9)


def window_spans(run, name: str | None = None) -> list[Span] | None:
    """The port's spans that started inside the traced window (of `name`
    alone, if given), oldest first; None where there are none."""
    origin = origin_ns(run)
    if origin is None:
        return None
    try:
        from wav2vec2_tpu_torch.utils import spans
    except ImportError:
        return None
    out = [Span(s.name, (s.start_ns - origin) * 1e-9, (s.end_ns - origin) * 1e-9, s.parent,
                dict(s.counts), s.device_s)
           for s in spans.snapshot() if s.start_ns >= origin and name in (None, s.name)]
    return out or None


def mean_ms(run, name: str) -> float | None:
    """Mean host milliseconds of a span `name` in the window."""
    found = window_spans(run, name)
    if not found:
        return None
    return 1e3 * sum(s.end - s.start for s in found) / len(found)


def _union(starts, ends) -> tuple[np.ndarray, np.ndarray]:
    """The union of intervals (starts, ends): sorted disjoint (starts, ends)."""
    starts, ends = np.asarray(starts, float), np.asarray(ends, float)
    if not len(starts):
        return starts, ends
    order = np.argsort(starts, kind="stable")
    starts, ends = starts[order], ends[order]
    new = np.ones(len(starts), bool)
    new[1:] = starts[1:] > np.maximum.accumulate(ends)[:-1]
    first = np.flatnonzero(new)
    return starts[first], np.maximum.reduceat(ends, first)


def _idle_in(busy, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Seconds of each [a, b] that the union `busy` does not cover."""
    starts, ends = busy
    if not len(starts):
        return b - a
    before = np.concatenate([[0.0], np.cumsum(ends - starts)])

    def covered(t):  # busy seconds before t
        k = np.searchsorted(starts, t, side="right")
        last = np.maximum(k - 1, 0)
        inside = np.clip(t - starts[last], 0.0, ends[last] - starts[last])
        return np.where(k > 0, before[last] + inside, 0.0)

    return (b - a) - (covered(b) - covered(a))


def idle_by_span(run) -> dict | None:
    """Seconds of the window with nothing on the device, by the port's
    outermost span open on the host at the time (`batching.prepare`,
    `batching.enqueue` with the forward inside it, `batching.copy_wait`,
    `batching.group`), and `OUTSIDE` for the rest."""
    found = window_spans(run)
    if not found:
        return None
    window = run.trace.window_s
    roots = [(min(max(s.start, 0.0), window), min(s.end, window), s.name)
             for s in found if s.parent is None]
    busy = _union([k[1] for k in run.trace.kernels], [k[2] for k in run.trace.kernels])
    a, b, names = (np.array([r[i] for r in roots]) for i in range(3))
    out: dict = {}
    for name, seconds in zip(names, _idle_in(busy, a, b)):
        out[str(name)] = out.get(str(name), 0.0) + float(seconds)
    # roots of one thread never overlap; those of two threads may, so what
    # lies outside them is the idle time less the idle time under their union
    under = float(_idle_in(busy, *_union(a, b)).sum())
    idle = window - float((busy[1] - busy[0]).sum())
    out[OUTSIDE] = max(idle - under, 0.0)
    return out
