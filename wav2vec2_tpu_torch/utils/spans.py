"""Spans: named stretches of the port's own work, recorded while a torch
profiler runs.

    with span("batching.prepare") as s:
        ...
        s.count(samples_total=n)

A span is off unless a `torch.profiler` profile is running in the process
(its process-wide flag, `torch.autograd.profiler._is_profiler_enabled`, is
read once a span: one attribute load; a torch without it falls back on
`torch.autograd._profiler_enabled()`, which reads True only on the thread
that started the profiler). Off, `span` returns one shared no-op
object: nothing is allocated or recorded and no CUDA event is made. So an
operator turns spans on with the profiler they already use, and a run
without one pays a flag test a span.

On, a span
- keeps (id, parent id, name, start_ns, end_ns, counts) in a bounded
  in-memory log, `CAP` spans; past it the oldest are dropped and counted in
  `LOG.dropped`;
- is a `torch.profiler.record_function` range of the same name, so the
  profiler's own trace holds it: `alignment_report --torch-profile DIR`
  writes it into DIR/perf_trace.json (the perf loop's forwards carry
  `forward.frontend`), and a profile around `BatchAligner.align_stream`
  holds every batch's spans;
- stamps its start and end with `time.time_ns()`, the wall clock that the
  profiler's own events are stamped on, inside its range: just after the
  profiler's own start stamp, so that the two lie microseconds apart;
- with `device=True`, records a timing event on the current CUDA stream at
  its start and one at its end; `snapshot()` turns them into `device_s`
  once both have completed.

The parent stack is per thread: spans of different threads never nest in
each other. `tally(**counts)` adds to the counts of the innermost span open
on the calling thread, so code below a span's opener can count inside it.
`snapshot()` returns the finished spans (oldest first) and keeps them;
`clear()` empties the log.

The spans of the port:

| Span | Opened by | Counts |
|---|---|---|
| `batching.prepare` | `BatchAligner._submit_entries`: on a CUDA device without a mesh the rows packed raw into pinned memory for K7 (`ops.normalize`), elsewhere host normalization and padding; the rows that fill the batch to its pow2 size | `samples_fill` (samples of the fill rows), `samples_total` (of the padded batch), `samples_real` (the utterances' own samples), `samples_card` (those of them that K7 normalizes on the card) |
| `batching.enqueue` | `BatchAligner.submit_padded_batch`, whole: host to device, forward, log-softmax, DP, evidence, the host copies' enqueue | `elems_fused` on the card (the encoder's GELUs in K6) |
| `forward.frontend` | `models.ctc_model.wav2vec2_forward`: the conv or mel frontend through the feature projection; device time on a CUDA device | `elems` (elements of the conv outputs; none for the mel frontend), `elems_fused` on the card (elements written by K6's launches, `ops.norm_gelu`) |
| `batching.copy_wait` | `parallel.batching._host_arrays`: the wait for a batch's host copies | — |
| `batching.group` | `BatchAligner.group_batch`: the per-row grouping | — |
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque

import torch
import torch.autograd.profiler as _autograd_profiler

CAP = 1 << 20


def _profiling_test():
    """The test that a profiler runs: the process-wide flag where this torch
    has it, else the per-thread one."""
    if hasattr(_autograd_profiler, "_is_profiler_enabled"):
        return lambda: _autograd_profiler._is_profiler_enabled
    return torch.autograd._profiler_enabled


profiling = _profiling_test()


class Span:
    """One recorded span; the object a `with span(...)` block gets."""

    __slots__ = ("id", "parent", "name", "start_ns", "end_ns", "counts", "device_s",
                 "_log", "_device", "_range", "_events")

    def __init__(self, log: SpanLog, name: str, device: bool, counts: dict):
        self.name = name
        self.counts = counts
        self.device_s = None
        self._log = log
        self._device = device
        self._events = None

    def count(self, **counts) -> None:
        self.counts.update(counts)

    def __enter__(self) -> Span:
        stack = self._log._stack()
        parent = stack[-1] if stack else None
        self.parent = parent.id if parent is not None else None
        self.id = next(self._log._ids)
        stack.append(self)
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self.start_ns = time.time_ns()
        if self._device:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            self._events = [start]
        return self

    def __exit__(self, *exc) -> bool:
        if self._events is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._events.append(end)
        self.end_ns = time.time_ns()
        self._range.__exit__(*exc)
        self._range = None
        self._log._stack().pop()
        self._log._append(self)
        return False

    def _resolve(self) -> None:
        if self._events is not None and all(e.query() for e in self._events):
            start, end = self._events
            self.device_s = start.elapsed_time(end) * 1e-3
            self._events = None


class _Off:
    """What `span` returns while no profiler runs: does nothing."""

    __slots__ = ()

    def __enter__(self) -> _Off:
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def count(self, **counts) -> None:
        pass


_OFF = _Off()


class SpanLog:
    """A bounded log of finished spans, `cap` at most."""

    def __init__(self, cap: int = CAP):
        self._spans: deque = deque(maxlen=cap)
        self.dropped = 0
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._local = threading.local()

    def span(self, name: str, device: bool = False, **counts):
        if not profiling():
            return _OFF
        return Span(self, name, device, counts)

    def tally(self, **counts) -> None:
        """Add `counts` to those of the innermost span open on this thread
        (nothing where none is open, or spans are off)."""
        if not profiling():
            return
        stack = self._stack()
        if stack:
            mine = stack[-1].counts
            for name, n in counts.items():
                mine[name] = mine.get(name, 0) + n

    def snapshot(self) -> list[Span]:
        with self._lock:
            spans = list(self._spans)
        for s in spans:
            s._resolve()
        return spans

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self.dropped = 0

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _append(self, s: Span) -> None:
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self.dropped += 1
            self._spans.append(s)


LOG = SpanLog()
span = LOG.span
tally = LOG.tally
snapshot = LOG.snapshot
clear = LOG.clear
