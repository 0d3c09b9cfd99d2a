"""`stream`: a closed loop through `BatchAligner.align_stream` (the CLI's
path). The pool is fed pass after pass, each in its own order (the same for
every seed, `generate.cycle_order`), until the window's
seconds are up; then the feed ends and the stream submits what it still
holds. What it yields to the caller is kept for the check. `batch_rtf` is the audio of every utterance fed over the time from
the window's start until the last of them was aligned, so a stall at the
end of the window counts, and so does the work in flight at its close.
"""

from __future__ import annotations

import time

from .. import generate
from . import Driver


class StreamDriver(Driver):
    def setup(self):
        from wav2vec2_tpu_torch.parallel.batching import BatchAligner

        ctx = self.ctx
        self.aligner = BatchAligner(ctx.model_cfg, ctx.params, ctx.vocab,
                                    compute_dtype=ctx.dtype, device=ctx.device)
        self.pool = generate.items(self.mix, ctx.seed, ctx.device)
        for _ in self.aligner.align_stream(((it.audio, it.transcript) for it in self.pool),
                                           **self.mix["stream"]):
            pass
        ctx.sync()

    def window(self, seconds: float) -> dict:
        fed: list[int] = []
        n = len(self.pool)
        t0 = time.perf_counter()
        deadline = t0 + seconds

        def feed():
            cycle = 0
            while True:
                for i in generate.cycle_order(n, cycle):
                    if time.perf_counter() >= deadline:
                        return
                    fed.append(int(i))
                    yield self.pool[i].audio, self.pool[i].transcript
                cycle += 1

        self._yielded = []
        for idx, out in self.aligner.align_stream(feed(), **self.mix["stream"]):
            self._yielded.append((fed[idx], out))
        done = len(self._yielded)
        self.ctx.sync()
        measured = time.perf_counter() - t0
        audio_s = sum(len(self.pool[i].audio) for i in fed) / generate.SAMPLE_RATE
        self.stats = dict(utterances=done, fed=len(fed), audio_s=audio_s, measured_s=measured)
        return dict(attempted=len(fed), failed=len(fed) - done,
                    metrics={"batch_rtf": audio_s / measured})

    def answers(self, judged: dict) -> dict:
        """{key: [words]}: every answer the window yielded for a judged item,
        in order."""
        keys = {i: self.key(self.pool[i]) for i in {i for i, _ in self._yielded}}
        out: dict = {}
        for i, result in self._yielded:
            if keys[i] in judged:
                out.setdefault(keys[i], []).append(
                    [(w.word, w.start_ms, w.end_ms, w.confidence) for w in result.words])
        return out

    def close(self):
        del self.aligner


ENTRY = StreamDriver
