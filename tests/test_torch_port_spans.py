"""The port's spans (`wav2vec2_tpu_torch.utils.spans`) on the batch path, on
the CPU with the port's own random weights (no JAX).

Outside a profiler `align_stream` records nothing. Under `torch.profiler`
every batch gets one `batching.prepare`, `batching.enqueue`,
`forward.frontend` (inside the enqueue), `batching.copy_wait` and
`batching.group`, in the stream's order (submits and drains first in,
first out); the prepare span's counts are the bucket arithmetic of the
utterances' lengths; the words are those of an untraced run; each span
starts within 1 ms of its own `record_function` range in the profiler's
events (one clock; checked in a fresh interpreter, where no thread left
by another test can hold the GIL between the two stamps, on the best of
five traced runs, so that one run preempted on a loaded host does not
decide it). Past its cap the log drops its oldest spans and counts
them. The profiler test is process-wide: a span opened on another thread
records too.
"""

import dataclasses
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from wav2vec2_tpu_torch import BatchAligner
from wav2vec2_tpu_torch.config import Wav2Vec2ModelConfig
from wav2vec2_tpu_torch.models.params import init_params, params_from_jax
from wav2vec2_tpu_torch.utils import spans

CONFIG = dict(
    model_type="wav2vec2",
    hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
    intermediate_size=64, conv_dim=[16, 16], conv_kernel=[10, 3],
    conv_stride=[5, 2], num_conv_pos_embeddings=16,
    num_conv_pos_embedding_groups=4, pad_token_id=0, vocab_size=32,
    do_stable_layer_norm=False, feat_extract_norm="group", conv_bias=False,
)
VOCAB = {"<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3, "|": 4}
for _i, _c in enumerate("ETAONIHSRDLUMWCFGYPBVKXJQZ"):
    VOCAB[_c] = 5 + _i
WORDS = ["THE", "QUICK", "BROWN", "FOX", "JUMPS", "OVER", "LAZY", "DOG"]
# with audio_multiple 1000 (pow2) and max_batch 4: three rows in the 1000
# bucket (one fill row), four in 2000, four in 4000 then one (no fill)
LENGTHS = [1800, 900, 3500, 1900, 3100, 800, 1700, 2600, 1200, 3900, 700, 3300]
STREAM = dict(audio_multiple=1000, max_batch=4, max_in_flight=1)
NAMES = ("batching.prepare", "batching.enqueue", "forward.frontend",
         "batching.copy_wait", "batching.group")


def _aligner():
    cfg = Wav2Vec2ModelConfig.from_dict(CONFIG)
    params = params_from_jax(init_params(cfg, seed=3))
    return BatchAligner(cfg, params, VOCAB, compute_dtype="float32", device="cpu")


@pytest.fixture(scope="module")
def aligner():
    return _aligner()


def _items():
    rng = np.random.default_rng(5)
    return [(rng.normal(size=n).astype(np.float32),
             " ".join(rng.choice(WORDS, size=1 + n // 1500))) for n in LENGTHS]


def _words(aligner):
    return {i: [dataclasses.asdict(w) for w in out.words]
            for i, out in aligner.align_stream(_items(), **STREAM)}


def _batch_shapes():
    """(pad, rows, real rows) of each batch, from the lengths alone: pow2
    buckets of 1000 samples, 4 rows at most, the rows of a partial batch
    filled to the next power of two."""
    buckets: dict = {}
    for n in LENGTHS:
        pad = 1000
        while pad < n:
            pad *= 2
        buckets.setdefault(pad, []).append(n)
    out = []
    for pad, lens in buckets.items():
        for i in range(0, len(lens), 4):
            real = len(lens[i:i + 4])
            out.append((pad, 1 << (real - 1).bit_length(), real))
    return out


def _expected_batches():
    """(samples_fill, samples_total) of each batch (`_batch_shapes`)."""
    return sorted(((rows - real) * pad, rows * pad) for pad, rows, real in _batch_shapes())


def _frontend_elems(rows, pad):
    """Elements of a batch's conv outputs: [rows, 16, T] after each conv."""
    t, total = pad, 0
    for k, s in zip(CONFIG["conv_kernel"], CONFIG["conv_stride"]):
        t = (t - k) // s + 1
        total += rows * 16 * t
    return total


def _trace(aligner):
    """The spans and the profiler's events of one traced stream, and its
    words."""
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm-up"):
            pass
        words = _words(aligner)
    recorded = spans.snapshot()
    spans.clear()
    events = [(e.name(), e.start_ns()) for e in prof.profiler.kineto_results.events()
              if e.name() in NAMES]
    return recorded, events, words


@pytest.fixture(scope="module")
def traced(aligner):
    return _trace(aligner)


CLOCK_RUNS = 5


def _clock_offsets() -> dict:
    """Per span name, for each of `CLOCK_RUNS` traced streams: how many
    spans and profiler ranges it had, and the largest |span start − range
    start| in ns (an untraced stream first, so that nothing is done for the
    first time)."""
    aligner = _aligner()
    _words(aligner)
    out = {name: [] for name in NAMES}
    for _ in range(CLOCK_RUNS):
        recorded, events, _ = _trace(aligner)
        for name in NAMES:
            mine = sorted(s.start_ns for s in recorded if s.name == name)
            theirs = sorted(t for n, t in events if n == name)
            out[name].append([len(mine), len(theirs),
                              max(abs(a - b) for a, b in zip(mine, theirs))])
    return out


def test_off_records_nothing(aligner, monkeypatch):
    made = []

    class Counted(spans.Span):
        __slots__ = ()

        def __init__(self, *args):
            made.append(args[1])
            super().__init__(*args)

    monkeypatch.setattr(spans, "Span", Counted)
    spans.clear()
    _words(aligner)
    assert spans.snapshot() == [] and made == []
    assert spans.span("batching.prepare", samples_total=0) is spans.span("x")


def test_one_span_of_each_a_batch(traced):
    recorded, _, _ = traced
    named = {name: [s for s in recorded if s.name == name] for name in NAMES}
    assert {len(found) for found in named.values()} == {len(_expected_batches())}
    for s in recorded:
        assert s.start_ns <= s.end_ns
        assert (s.parent is None) == (s.name != "forward.frontend"), s.name
    # submits and drains are first in, first out: batch i is the i-th of each
    for prepare, enq, front, wait, group in zip(*named.values()):
        assert front.parent == enq.id
        assert front.device_s is None  # no CUDA device
        assert enq.start_ns <= front.start_ns <= front.end_ns <= enq.end_ns
        assert prepare.end_ns <= enq.start_ns <= enq.end_ns <= wait.start_ns
        assert wait.end_ns <= group.start_ns


def test_counts_are_the_bucket_arithmetic(traced):
    recorded, _, _ = traced
    got = [(s.counts["samples_fill"], s.counts["samples_total"])
           for s in recorded if s.name == "batching.prepare"]
    assert sorted(got) == sorted(_expected_batches())
    # the frontend's conv outputs, [rows, 16, T] after each conv of a batch
    # of rows x pad samples; none of them in K6 on the CPU
    want = sorted(_frontend_elems(rows, pad) for pad, rows, _ in _batch_shapes())
    got = sorted(s.counts["elems"] for s in recorded if s.name == "forward.frontend")
    assert got == want
    assert all("elems_fused" not in s.counts for s in recorded)
    assert all(s.counts == {} for s in recorded
               if s.name not in ("batching.prepare", "forward.frontend"))


def test_words_identical_traced_or_not(aligner, traced):
    _, _, words = traced
    assert _words(aligner) == words


def test_spans_on_the_profilers_clock():
    root = Path(__file__).resolve().parents[1]
    run = subprocess.run([sys.executable, __file__], cwd=root, capture_output=True, text=True,
                         timeout=120, env={**os.environ, "PYTHONPATH": str(root)})
    assert run.returncode == 0, run.stderr[-2000:]
    offsets = json.loads(run.stdout.strip().splitlines()[-1])
    for name in NAMES:
        runs = offsets[name]
        assert len(runs) == CLOCK_RUNS, name
        for n_mine, n_theirs, _ in runs:
            assert n_mine == n_theirs > 0, name
        # a span on another clock is off by far more on every run; one
        # preempted run (the host loaded by other test workers) is not
        best = min(worst for _, _, worst in runs)
        assert best <= 1_000_000, (name, [worst for _, _, worst in runs])


def test_log_drops_the_oldest_past_its_cap():
    log = spans.SpanLog(cap=4)
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(7):
            with log.span("s", n=i) as s:
                s.count(i=i)
                with log.span("inner"):
                    pass
    kept = log.snapshot()
    assert log.dropped == 10
    assert [(s.name, s.counts) for s in kept] == [
        ("inner", {}), ("s", {"n": 5, "i": 5}), ("inner", {}), ("s", {"n": 6, "i": 6})]
    assert kept[0].parent == kept[1].id and kept[1].parent is None
    log.clear()
    assert log.snapshot() == [] and log.dropped == 0


def test_the_profiler_test_is_process_wide():
    # the module flag the spans read; without it they would record on the
    # profiler's own thread only, and the serve workers' spans would be lost
    assert isinstance(torch.autograd.profiler._is_profiler_enabled, bool)
    log = spans.SpanLog()

    def work():
        with log.span("worker"):
            pass

    worker = threading.Thread(target=work)
    assert not spans.profiling()
    with profile(activities=[ProfilerActivity.CPU]):
        assert spans.profiling()
        worker.start()
        worker.join()
    assert not spans.profiling()
    assert [s.name for s in log.snapshot()] == ["worker"]


if __name__ == "__main__":
    print(json.dumps(_clock_offsets()))
