"""Phoneme-level (unit) grouping: path spans → per-token timing units.

The reference models phoneme-CTC support as *switchable grouping behavior*
behind the `WordGrouper` trait while Viterbi stays token-agnostic
(src/pipeline/traits.rs WordGrouper there; its design notes say "phoneme
grouping would emit timing units for non-blank, non-separator token
transitions" — no phoneme-mode builder API was committed there; this module
is that mode, realized). Carried over from
`wav2vec2_tpu.align.grouping.phoneme`.

Semantics: each maximal run of frames the Viterbi path spends in one
non-blank, non-separator CTC state becomes one unit. Runs are per *state*,
not per vocab id — a doubled phoneme in the transcript ("t t") occupies two
states and yields two units, exactly as CTC emits it. Boundaries are the
raw frame interval [first, last+1) × frame_stride_ms with no blank
expansion (phoneme units are reported tight; word-style blank expansion
policies model orthographic words, not phones). Confidence is the geometric
mean of the per-frame emission posteriors over the run (exp of the mean
emit_lp) — the same acoustic evidence stream the word path uses
(FrameEvidence.emit_lp), without the word-level calibration table
(calibrated on words, meaningless for phones).
"""

from __future__ import annotations

import math

import numpy as np

from ...config import AlignerHyperParams
from ...types import TokenSequence, WordConfidenceStats, WordTiming
from .confidence import quality_confidence_score
from .path_to_words import FrameEvidence


def group_into_phonemes(
    path_states: np.ndarray,
    token_sequence: TokenSequence,
    evidence: FrameEvidence,
    blank_id: int,
    word_sep_id: int,
    frame_stride_ms: float,
) -> list[WordTiming]:
    """path_states [t_len] (state indices) → one WordTiming per emitted
    phone, `word` holding the token's symbol (TokenSequence.chars)."""
    tokens = token_sequence.tokens
    chars = token_sequence.chars
    t_len = int(np.asarray(path_states).shape[0])
    units: list[WordTiming] = []
    hp = AlignerHyperParams()

    run_state = -1
    run_start = 0

    def flush(end_frame: int) -> None:
        if run_state < 0:
            return
        tok = tokens[run_state]
        if tok == blank_id or tok == word_sep_id:
            return
        n = end_frame - run_start
        sym = chars[run_state]
        start_ms = int(round(run_start * frame_stride_ms))
        # a unit occupies >= 1 frame; keep end > start even when a sub-ms
        # frame stride (toy geometries) would round both to the same ms
        end_ms = max(int(round(end_frame * frame_stride_ms)), start_ms + 1)
        # per-FRAME acoustic stats over the run (unlike words, whose stats
        # accumulate one sample per new-state entry: a phoneme unit IS one
        # state, so its frames are the natural sample set). No word-level
        # calibration: the 8-knot map was fit on words.
        lps = evidence.emit_lp[run_start:end_frame].astype(np.float64)
        margins = evidence.margin[run_start:end_frame].astype(np.float64)
        mean_logp = float(lps.mean()) if n else None
        # unit confidence stays the f64 geometric mean (unchanged
        # behavior); the STATS field carries the f32-cast value like the
        # word path's types
        conf = (min(max(math.exp(mean_logp), 0.0), 1.0) if n else None)
        geo = (min(max(math.exp(float(np.float32(mean_logp))), 0.0), 1.0)
               if n else None)
        stats = WordConfidenceStats(
            mean_logp=mean_logp,
            geo_mean_prob=geo,
            min_logp=float(lps.min()) if n else None,
            p10_logp=float(np.percentile(lps.astype(np.float32), 10.0))
            if n else None,
            mean_margin=float(margins.mean()) if n else None,
            coverage_frame_count=n,
        )
        stats.quality_confidence = quality_confidence_score(stats, hp)
        units.append(
            WordTiming(
                word=sym if sym is not None else str(tok),
                start_ms=start_ms,
                end_ms=end_ms,
                confidence=conf,
                confidence_stats=stats,
            )
        )

    for t in range(t_len):
        s = int(path_states[t])
        if s != run_state:
            flush(t)
            run_state = s
            run_start = t
    flush(t_len)
    return units
