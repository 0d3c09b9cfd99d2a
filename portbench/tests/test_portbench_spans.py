"""The readers of the port's own spans (`program_spans.py` and the seven
metrics on it) on a hand-made traced run with known answers: the origin
recovered from the harness's spans, spans of an earlier window left out,
idle time split by the outermost span, and None where nothing was
recorded. On the card: a short traced `base.batch` run reports all seven,
is correct, and the frontend's device seconds stay within the busy ones."""

from __future__ import annotations

import sys
from types import SimpleNamespace

import pytest

from portbench import manifest, program_spans, run
from portbench.trace import Trace

NEW = ("prepare_ms.batch", "enqueue_ms.batch", "fill_share.batch", "frontend_share.batch",
       "copy_wait_ms.batch", "group_ms.batch", "idle_in_submit.batch")
ORIGIN = 1_790_000_000_000_000_000  # the profiler's start, ns on the wall clock


def _span(i, name, start_s, end_s, parent=None, device_s=None, **counts):
    return SimpleNamespace(id=i, parent=parent, name=name, start_ns=ORIGIN + round(start_s * 1e9),
                           end_ns=ORIGIN + round(end_s * 1e9), counts=counts, device_s=device_s)


SPANS = [
    # an earlier window's span: before this profiler started
    _span(90, "batching.prepare", -5.0, -4.9, samples_fill=3000, samples_total=4000),
    _span(1, "batching.prepare", 0.010, 0.014, samples_fill=1000, samples_total=4000),
    _span(3, "forward.frontend", 0.015, 0.018, parent=2, device_s=0.050),
    _span(2, "batching.enqueue", 0.014, 0.030),
    _span(4, "batching.prepare", 0.400, 0.406, samples_fill=0, samples_total=4000),
    _span(6, "forward.frontend", 0.407, 0.409, parent=5, device_s=0.030),
    _span(5, "batching.enqueue", 0.406, 0.420),
    _span(7, "batching.copy_wait", 0.300, 0.320),
    _span(8, "batching.group", 0.320, 0.330),
    _span(9, "batching.copy_wait", 0.600, 0.610),
    _span(10, "batching.group", 0.610, 0.630),
]
# device busy over [0.020, 0.300] and [0.410, 0.700] (two kernels overlap)
KERNELS = [("k", 0.020, 0.200), ("k", 0.150, 0.300), ("k", 0.410, 0.700)]
EXPECTED = {
    "prepare_ms.batch": 5.0,  # 4 and 6 ms
    "enqueue_ms.batch": 15.0,  # 16 and 14
    "copy_wait_ms.batch": 15.0,  # 20 and 10
    "group_ms.batch": 15.0,  # 10 and 20
    "fill_share.batch": 12.5,  # 1000 of 8000 samples
    "frontend_share.batch": 100.0 * 0.080 / 0.570,
    # idle under prepare 4 + 6 ms, under enqueue 6 + 4 ms, of 1 s
    "idle_in_submit.batch": 2.0,
}


def _view(harness_offset_s=0.005, traced=True):
    """A traced run whose harness span (a submit) lies `harness_offset_s`
    after the profiler's start."""
    start = ORIGIN + round(harness_offset_s * 1e9)
    recorder = SimpleNamespace(spans=[("portbench.submit", start, start + 30_000_000)],
                               batches=[], drain_s=[])
    trace = Trace(window_s=1.0, kernels=list(KERNELS),
                  host_ranges=[("portbench.submit", harness_offset_s, harness_offset_s + 0.03)],
                  busy_s=0.570)
    return run.RunView(None, None, trace if traced else None, recorder, {}, 1.0)


@pytest.fixture
def recorded(monkeypatch):
    from wav2vec2_tpu_torch.utils import spans

    made = list(SPANS)
    monkeypatch.setattr(spans, "snapshot", lambda: made)
    return made


def test_origin_recovered_from_the_harness_spans():
    assert program_spans.origin_ns(_view()) == ORIGIN
    assert program_spans.origin_ns(_view(harness_offset_s=12.345678912)) == ORIGIN


@pytest.mark.parametrize("name", NEW)
def test_each_reader_on_known_spans(recorded, name):
    assert manifest.reader(name)(_view()) == pytest.approx(EXPECTED[name], rel=1e-9)


def test_spans_of_the_window_on_its_axis(recorded):
    found = program_spans.window_spans(_view(), "batching.prepare")
    assert [(s.start, s.end) for s in found] == [
        pytest.approx((0.010, 0.014)), pytest.approx((0.400, 0.406))]
    assert [s.counts for s in found] == [{"samples_fill": 1000, "samples_total": 4000},
                                         {"samples_fill": 0, "samples_total": 4000}]


def test_idle_by_outermost_span(recorded):
    idle = program_spans.idle_by_span(_view())
    assert idle == pytest.approx({
        "batching.prepare": 0.010, "batching.enqueue": 0.010,
        "batching.copy_wait": 0.020, "batching.group": 0.010,
        program_spans.OUTSIDE: 1.0 - 0.570 - 0.050})


@pytest.mark.parametrize("name", NEW)
def test_none_without_spans(recorded, name):
    read = manifest.reader(name)
    recorded.clear()
    assert read(_view()) is None
    recorded.extend(SPANS[:1])  # an earlier window's only
    assert read(_view()) is None


@pytest.mark.parametrize("name", NEW)
def test_none_untraced_or_without_the_module(recorded, monkeypatch, name):
    import wav2vec2_tpu_torch.utils as utils

    read = manifest.reader(name)
    assert read(_view(traced=False)) is None
    no_harness = _view()
    no_harness.recorder.spans.clear()
    no_harness.trace.host_ranges.clear()
    assert read(no_harness) is None
    # a program without `utils.spans` (the parent of the change that added it)
    monkeypatch.delattr(utils, "spans")
    monkeypatch.setitem(sys.modules, "wav2vec2_tpu_torch.utils.spans", None)
    assert read(_view()) is None


@pytest.mark.cuda
def test_traced_base_batch_on_the_card(card):
    result, _ = run.run("base.batch", 3_000_000_019, 8.0, True)
    assert result["correct"], result["checks"]
    metrics = result["metrics"]
    assert all(metrics.get(name, {}).get("value") is not None for name in NEW), metrics
    # the frontend's device seconds within the window's busy seconds
    assert 0.0 < metrics["frontend_share.batch"]["value"] <= 100.0
