"""The reader of `norm_on_card.batch` on hand-made traced runs with known
answers: the share of the window's real samples that the port's
`batching.prepare` spans count as normalized on the card, earlier windows'
spans left out, and None where the spans carry no such counts (a program
before the counts existed) or nothing was recorded."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from portbench import manifest, run
from portbench.trace import Trace

ORIGIN = 1_790_000_000_000_000_000  # the profiler's start, ns on the wall clock


def _view(found, monkeypatch):
    from wav2vec2_tpu_torch.utils import spans

    recorder = SimpleNamespace(spans=[("portbench.submit", ORIGIN, ORIGIN + 10**7)],
                               batches=[], drain_s=[])
    trace = Trace(window_s=1.0, kernels=[("k", 0.0, 0.5)],
                  host_ranges=[("portbench.submit", 0.0, 0.01)], busy_s=0.5)
    made = [SimpleNamespace(id=i, parent=None, name=name, start_ns=ORIGIN + at_ns,
                            end_ns=ORIGIN + at_ns + 500, counts=counts, device_s=None)
            for i, (name, at_ns, counts) in enumerate(found, 1)]
    monkeypatch.setattr(spans, "snapshot", lambda: made)
    return run.RunView(None, None, trace, recorder, {}, 1.0)


PREPARE = "batching.prepare"


@pytest.mark.parametrize("found,want", [
    # every real sample through K7
    ([(PREPARE, 10, dict(samples_fill=0, samples_total=8, samples_real=6, samples_card=6)),
      (PREPARE, 20, dict(samples_fill=4, samples_total=16, samples_real=9, samples_card=9))],
     100.0),
    # the host path: none on the card
    ([(PREPARE, 10, dict(samples_fill=0, samples_total=8, samples_real=6, samples_card=0))],
     0.0),
    # an earlier window's span (before the profiler's start) is left out
    ([(PREPARE, -10**9, dict(samples_real=30, samples_card=0)),
      (PREPARE, 10, dict(samples_real=10, samples_card=10)),
      (PREPARE, 30, dict(samples_real=30, samples_card=0))], 25.0),
    # a program whose spans carry no such counts (the parent of this metric)
    ([(PREPARE, 10, dict(samples_fill=0, samples_total=8))], None),
    ([("batching.enqueue", 10, {})], None),
    ([], None),
])
def test_norm_on_card_reader(found, want, monkeypatch):
    got = manifest.reader("norm_on_card.batch")(_view(found, monkeypatch))
    assert got == (None if want is None else pytest.approx(want))


def test_none_untraced(monkeypatch):
    view = _view([(PREPARE, 10, dict(samples_real=6, samples_card=6))], monkeypatch)
    view.trace = None
    assert manifest.reader("norm_on_card.batch")(view) is None
