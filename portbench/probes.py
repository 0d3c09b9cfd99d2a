"""Wrappers around calls into the port, installed by the harness.

- `Capture` (every run): keeps, for each utterance the window grouped (its
  first time in the window), the log-probs the DP was given (a device copy
  of the row), what the timed path handed its word grouping — the path and
  the four evidence vectors, copied off the host buffers the port filled —
  and the words it returned; and the words of every later grouping of it.
  The key is (transcript words, frames). After the window the check judges
  a seeded sample of these.
- `Recorder` (the traced run only): the shapes of each batch, the host time
  of each drain, and a host span (wall clock, the profiler's clock) around
  each submit, drain and tokenization, so that the trace names what the
  host was doing while the device sat idle.
"""

from __future__ import annotations

import contextlib
import threading
import time

import numpy as np


class _Patches:
    def __init__(self):
        self._undo = []

    def set(self, owner, name, value):
        self._undo.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    def restore(self):
        while self._undo:
            owner, name, value = self._undo.pop()
            setattr(owner, name, value)


class Capture:
    """Inputs and output of the word grouping, first occurrence of each key
    inside the window."""

    def __init__(self):
        self.got: dict = {}
        self.log_probs: dict = {}  # the DP's input of each key, on the device
        self.outputs: dict = {}  # every grouping's words, by key, in the window
        self.active = False
        self._lock = threading.Lock()
        self._patches = _Patches()
        self._batch_lp = threading.local()

    def install(self, aligner):
        from wav2vec2_tpu_torch.ops import viterbi_cuda
        from wav2vec2_tpu_torch.parallel import batching

        self._patches.set(batching, "group_into_words", self._wrap(batching.group_into_words))
        batch_dp = viterbi_cuda.viterbi_batch

        def dp(log_probs, *args, **kwargs):
            self._batch_lp.value = log_probs
            return batch_dp(log_probs, *args, **kwargs)

        self._patches.set(viterbi_cuda, "viterbi_batch", dp)
        submit = aligner._submit_entries

        def submit_entries(entries, *args, **kwargs):
            handles = submit(entries, *args, **kwargs)
            if self.active:
                lp = self._batch_lp.value
                for i, (audio, seq) in enumerate(entries):
                    t = aligner.cfg.conv_output_length(len(audio))
                    key = (tuple(seq.normalized_words), t)
                    with self._lock:
                        if key not in self.log_probs:
                            self.log_probs[key] = lp[i, :t].clone()
            return handles

        self._patches.set(aligner, "_submit_entries", submit_entries)

    def restore(self):
        self._patches.restore()

    def _wrap(self, group):
        def grouped(path, tokens, chars, expected_words, evidence, *args, **kwargs):
            words = group(path, tokens, chars, expected_words, evidence, *args, **kwargs)
            if self.active:
                key = (tuple(expected_words), len(path))
                out = [(w.word, w.start_ms, w.end_ms, w.confidence) for w in words]
                with self._lock:
                    self.outputs.setdefault(key, []).append(out)
                if key not in self.got:
                    kept = dict(
                        path=np.array(path, np.int64),
                        emit_lp=np.array(evidence.emit_lp, np.float32),
                        margin=np.array(evidence.margin, np.float32),
                        blank_prob=np.array(evidence.blank_prob, np.float64),
                        entropy=np.array(evidence.entropy, np.float32),
                        tokens=list(tokens), chars=list(chars),
                        words=out)
                    with self._lock:
                        kept["log_probs"] = self.log_probs.get(key)
                        self.got.setdefault(key, kept)
            return words

        return grouped


class Recorder:
    """What the traced window drove, call by call."""

    def __init__(self):
        self.batches = []      # each batch's padded rows and shape, and its real rows' lengths
        self.drain_s = []      # host seconds of each group_batch
        self.spans = []        # (label, start_ns, end_ns) on the wall clock
        self.active = False
        self._patches = _Patches()

    def install(self, aligner):
        rec = self

        def ranged(label, fn, note=None):
            def call(*args, **kwargs):
                if not rec.active:
                    return fn(*args, **kwargs)
                if note is not None:
                    note(*args, **kwargs)
                start = time.time_ns()
                try:
                    return fn(*args, **kwargs)
                finally:
                    rec.spans.append((label, start, time.time_ns()))
            return call

        def note_batch(entries, n_pad, s_pad, max_batch, pad_batch):
            b = len(entries)
            b_pad = min(max_batch, 1 << (b - 1).bit_length()) if pad_batch else b
            rec.batches.append(dict(rows=b_pad, n_pad=int(n_pad), s_pad=int(s_pad),
                                    audio_lens=[len(a) for a, _ in entries],
                                    s_lens=[len(seq.tokens) for _, seq in entries]))

        self._patches.set(aligner, "_submit_entries",
                          ranged("portbench.submit", aligner._submit_entries, note_batch))
        group = aligner.group_batch

        def timed_group(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return group(*args, **kwargs)
            finally:
                if rec.active:
                    rec.drain_s.append(time.perf_counter() - t0)

        self._patches.set(aligner, "group_batch", ranged("portbench.drain", timed_group))
        self._patches.set(aligner, "_tokenize", ranged("portbench.tokenize", aligner._tokenize))

    def restore(self):
        self._patches.restore()


@contextlib.contextmanager
def installed(*probes):
    try:
        yield
    finally:
        for probe in probes:
            probe.restore()
