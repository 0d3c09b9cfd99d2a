"""Word grouping: Viterbi path → word timings.

Carried over from `wav2vec2_tpu.align.grouping` (the Python path, which is
that package's behavioural oracle; its native C++ engine is bit-identical
to it and is not carried over). Three blocks: (1) collect raw words from
the path, (2) expand blanks with every policy and select the best
candidate, (3) confidence scoring and ms conversion with the
[start_ms, end_ms) contract (start_ms = start_frame·stride,
end_ms = (end_frame+1)·stride).

Grouping consumes per-frame evidence vectors (emission log-prob along the
path, top-2 margin, blank probability) that the port computes on the
device next to the log-softmax (ops/evidence.py), so the [T, V] log-prob
matrix never has to leave the card.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from ...config import AlignerHyperParams
from ...types import WordTiming
from . import blank_expansion, candidate_selector, path_to_words
from .confidence import calibrate_quality_confidence, quality_confidence_score
from .path_to_words import FrameEvidence, RawWord

_DEFAULT_HP = AlignerHyperParams()


@dataclass
class ProfiledWordGroupingOutput:
    words: list[WordTiming]
    conf_ms: float
    collect_ms: float
    expand_select_ms: float


def frame_evidence_from_log_probs(
    log_probs: np.ndarray,
    tokens: Sequence[int],
    path_states: Sequence[int],
    blank_id: int,
) -> FrameEvidence:
    """Host-side construction of the per-frame evidence vectors (f32
    semantics of the reference's row scans)."""
    lp = np.asarray(log_probs, dtype=np.float32)
    t_len = lp.shape[0]
    states = np.asarray(path_states, dtype=np.int64)
    tok = np.asarray(tokens, dtype=np.int64)

    emit_lp = lp[np.arange(t_len), tok[states[:t_len]]]
    if lp.shape[1] >= 2:
        top2 = np.partition(lp, -2, axis=1)[:, -2:]
        margin = top2[:, 1] - top2[:, 0]
        margin = np.where(np.isfinite(top2).all(axis=1), margin, np.float32(0.0))
    else:
        margin = np.zeros(t_len, dtype=np.float32)
    blank_prob = np.exp(lp[:, blank_id]).astype(np.float64)
    probs = np.exp(lp)
    entropy = (-(probs * lp).sum(axis=1)).astype(np.float32)
    return FrameEvidence(
        emit_lp=emit_lp.astype(np.float32),
        margin=margin.astype(np.float32),
        blank_prob=blank_prob,
        entropy=entropy,
    )


def group_into_words(
    path: Sequence[tuple[int, int]] | np.ndarray,
    tokens: Sequence[int],
    chars: Sequence[Optional[str]],
    expected_words: Sequence[str],
    evidence: FrameEvidence,
    blank_id: int,
    word_sep_id: int,
    stride_ms: float,
    hp: AlignerHyperParams = _DEFAULT_HP,
) -> list[WordTiming]:
    return group_into_words_profiled(
        path, tokens, chars, expected_words, evidence, blank_id, word_sep_id,
        stride_ms, hp,
    ).words


def group_into_words_profiled(
    path: Sequence[tuple[int, int]] | np.ndarray,
    tokens: Sequence[int],
    chars: Sequence[Optional[str]],
    expected_words: Sequence[str],
    evidence: FrameEvidence,
    blank_id: int,
    word_sep_id: int,
    stride_ms: float,
    hp: AlignerHyperParams = _DEFAULT_HP,
) -> ProfiledWordGroupingOutput:
    """`path` is a list of (state, frame) pairs, or a 1-D array of states
    indexed by frame (what the batch drains pass)."""
    if isinstance(path, np.ndarray):
        path = [(int(s), t) for t, s in enumerate(path)]

    # --- Block 1: collect raw words from the Viterbi path ---
    t0 = time.perf_counter()
    raw = path_to_words.collect(
        path, tokens, chars, expected_words, evidence, blank_id, word_sep_id
    )
    collect_ms = (time.perf_counter() - t0) * 1000.0
    if not raw:
        return ProfiledWordGroupingOutput([], 0.0, collect_ms, 0.0)

    # --- Block 2: expand with every policy + select the best candidate ---
    t0 = time.perf_counter()
    first_frame = path[0][1] if path else 0
    last_frame = path[-1][1] if path else 0
    candidates = [
        (pc, blank_expansion.expand_with_policy(raw, first_frame, last_frame, pc))
        for pc in hp.expansion_policies
    ]
    chosen = candidate_selector.select_best(raw, candidates, evidence, hp)
    if chosen is not None:
        expanded = chosen.words
    else:
        expanded = blank_expansion.expand_with_policy(
            raw, first_frame, last_frame, hp.expansion_policies[0]
        )
    expand_select_ms = (time.perf_counter() - t0) * 1000.0

    # --- Block 3: confidence scoring + ms conversion ---
    t0 = time.perf_counter()
    words: list[WordTiming] = []
    for w in expanded:
        # [start_ms, end_ms): truncate toward zero like the Rust `as u64`
        start_ms = int(w.start_frame * stride_ms)
        end_ms = int((w.end_frame + 1) * stride_ms)
        qc = quality_confidence_score(w.confidence_stats, hp)
        cc = calibrate_quality_confidence(qc, hp) if qc is not None else None
        w.confidence_stats.quality_confidence = qc
        w.confidence_stats.calibrated_confidence = cc
        words.append(
            WordTiming(
                word=w.word,
                start_ms=start_ms,
                end_ms=end_ms,
                confidence=cc,
                confidence_stats=w.confidence_stats,
            )
        )
    conf_ms = (time.perf_counter() - t0) * 1000.0

    return ProfiledWordGroupingOutput(words, conf_ms, collect_ms, expand_select_ms)


__all__ = [
    "FrameEvidence",
    "ProfiledWordGroupingOutput",
    "RawWord",
    "frame_evidence_from_log_probs",
    "group_into_words",
    "group_into_words_profiled",
]
