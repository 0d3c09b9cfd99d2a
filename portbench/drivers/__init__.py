"""The entries a mix can drive, one module each, found by the mix's
`entry`: `drivers/<entry>.py` defines `ENTRY`, a `Driver` that is set up
once and then run for a measured window. A later entry is a new file.

A driver has `setup()`, `window(seconds)` (returns `attempted`, `failed`
and the cell's end-to-end metrics other than `setup_s`), `close()`, the
`pool` of items it drew, `stats` (printed on an earlier line), the
`aligner` that the harness's probes wrap, and `answers(judged)`: what the
window handed its caller for each judged item. After the window, `sample`
draws the items the check judges from those the window grouped: the
longest of them, and a seeded draw of the others.
"""

from __future__ import annotations

import importlib

import numpy as np

from .. import generate
from ..reference.forward import frames
from ..reference.text import tokenize


def load(entry: str):
    """The `Driver` class of `drivers/<entry>.py`."""
    return importlib.import_module(f"{__name__}.{entry}").ENTRY


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.mix = ctx.mix
        self.pool: list[generate.Item] = []
        self.stats: dict = {}

    def key(self, item: generate.Item) -> tuple:
        seq = tokenize(item.transcript, self.ctx.vocab, self.ctx.blank_id, self.ctx.word_sep_id)
        return tuple(seq.normalized_words), frames(len(item.audio), self.ctx.cfg)

    def sample(self, grouped) -> dict:
        """{key: item} of the items to judge, among the pool's items whose
        key is in `grouped`: the longest, and a seeded draw of the others,
        `check_items` in all."""
        cand = [i for i, it in enumerate(self.pool) if self.key(it) in grouped]
        if not cand:
            return {}
        n = min(int(self.mix["check_items"]), len(cand))
        longest = max(cand, key=lambda i: len(self.pool[i].audio))
        rng = np.random.default_rng([self.ctx.seed % 2**64, 7])
        others = [cand[j] for j in rng.permutation(len(cand)) if cand[j] != longest][: n - 1]
        return {self.key(self.pool[i]): self.pool[i] for i in [longest, *others]}
