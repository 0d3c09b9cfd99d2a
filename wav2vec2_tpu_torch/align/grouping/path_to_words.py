"""Phase 1: walk the Viterbi path and group character frames into words.

Behavioral contract from the Rust reference, src/alignment/grouping/path_to_words.rs:43-339:

- blank frames are skipped (only update prev_state);
- separator frames flush the current word ONLY if it matches the next
  expected word case-insensitively (guard against malformed flushes,
  path_to_words.rs:8-15,59-84); otherwise keep accumulating;
- character frames set tight start/end boundaries, count coverage, and on
  NEW-STATE ENTRY only accumulate emission log-prob + top-2 margin of that
  frame (path_to_words.rs:87-102) — per-emission accumulation makes
  confidence stable across long state holds;
- a final flush after the loop catches the last word.

Stats (path_to_words.rs:283-339): mean_logp (f32 sequential sum),
geo_mean_prob = f32(max(exp(f64(mean_logp)), f32::MIN_POSITIVE)), min_logp,
p10_logp (linear-interpolated percentile in f32), mean_margin (f32 mean).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from ...types import WordConfidenceStats

logger = logging.getLogger(__name__)

F32_MIN_POSITIVE = float(np.finfo(np.float32).tiny)  # f32::MIN_POSITIVE


@dataclass
class FrameEvidence:
    """Per-frame acoustic evidence — the only thing grouping needs from the
    [T, V] log-prob matrix (all computable on device; see grouping/__init__).

    emit_lp[t]   = log_probs[t, tokens[path_state[t]]]  (f32)
    margin[t]    = top-2 margin of log_probs[t, :]      (f32, 0 if non-finite)
    blank_prob[t]= f64(exp(f32 log_probs[t, blank_id])) (candidate_selector.rs:236-240)
    """

    emit_lp: np.ndarray
    margin: np.ndarray
    blank_prob: np.ndarray
    entropy: Optional[np.ndarray] = None  # per-frame token entropy (nats)

    @property
    def t_len(self) -> int:
        return int(self.emit_lp.shape[0])


@dataclass
class RawWord:
    """Word with frame-level boundaries before blank expansion
    (reference: grouping/mod.rs:12-19)."""

    word: str
    start_frame: int
    end_frame: int
    confidence: Optional[float] = None
    confidence_stats: WordConfidenceStats = field(default_factory=WordConfidenceStats)

    def copy(self) -> "RawWord":
        from dataclasses import replace

        return RawWord(
            word=self.word,
            start_frame=self.start_frame,
            end_frame=self.end_frame,
            confidence=self.confidence,
            confidence_stats=replace(self.confidence_stats),
        )


def _matches_expected_word(
    cur_word: str, expected_words: Sequence[str], produced_words: int
) -> bool:
    """Case-insensitive completion check (path_to_words.rs:8-15); permissive
    when the expected word cannot be inferred."""
    if produced_words < len(expected_words):
        return cur_word.lower() == expected_words[produced_words].lower()
    return True


def collect(
    path: Sequence[tuple[int, int]],
    tokens: Sequence[int],
    chars: Sequence[Optional[str]],
    expected_words: Sequence[str],
    evidence: FrameEvidence,
    blank_id: int,
    word_sep_id: int,
) -> list[RawWord]:
    """Per-step transliteration of the reference loop
    (path_to_words.rs:201-244). Benchmarked against a numpy event-walk
    variant: at LibriSpeech sizes (T ≤ ~1750) the plain loop wins — array
    construction overhead exceeds the saved iterations — so the simple,
    reference-faithful form stays."""
    words: list[RawWord] = []
    cur_word: list[str] = []
    start_frame: Optional[int] = None
    end_frame = 0
    emission_lp_accum: list[np.float32] = []
    emission_margin_accum: list[np.float32] = []
    coverage_frame_count = 0
    prev_state: Optional[int] = None

    words_from_chars = _reconstruct_words_from_chars(chars)
    if list(words_from_chars) != list(expected_words):
        logger.warning(
            "grouping: normalized transcript words differ from char stream words: "
            "expected=%r from_chars=%r", list(expected_words), words_from_chars,
        )

    def flush() -> None:
        nonlocal start_frame, coverage_frame_count
        if not cur_word:
            return
        stats = _build_confidence_stats(
            emission_lp_accum, emission_margin_accum, coverage_frame_count
        )
        confidence = stats.geo_mean_prob
        if confidence is None:
            logger.warning(
                "grouping: invalid word confidence (no covered frames): word=%s",
                "".join(cur_word),
            )
        words.append(
            RawWord(
                word="".join(cur_word),
                start_frame=start_frame if start_frame is not None else end_frame,
                end_frame=end_frame,
                confidence=confidence,
                confidence_stats=stats,
            )
        )
        cur_word.clear()
        start_frame = None
        emission_lp_accum.clear()
        emission_margin_accum.clear()
        coverage_frame_count = 0

    for s, frame in path:
        tid = tokens[s]
        if tid == blank_id:
            prev_state = s
            continue
        if tid == word_sep_id:
            if cur_word and not _matches_expected_word(
                "".join(cur_word), expected_words, len(words)
            ):
                prev_state = s
                continue
            flush()
            prev_state = s
            continue
        c = chars[s]
        if c is not None:
            is_new_state = prev_state != s
            if start_frame is None:
                start_frame = frame
            end_frame = frame
            coverage_frame_count += 1
            if is_new_state:
                emission_lp_accum.append(np.float32(evidence.emit_lp[frame]))
                emission_margin_accum.append(np.float32(evidence.margin[frame]))
                cur_word.append(c)
        prev_state = s

    flush()
    return words


def _reconstruct_words_from_chars(chars: Sequence[Optional[str]]) -> list[str]:
    words: list[str] = []
    cur: list[str] = []
    for c in chars:
        if c is None:
            continue
        if c == "|":
            if cur:
                words.append("".join(cur))
                cur = []
            continue
        cur.append(c)
    if cur:
        words.append("".join(cur))
    return words


def _build_confidence_stats(
    emission_lp_accum: list[np.float32],
    emission_margin_accum: list[np.float32],
    coverage_frame_count: int,
) -> WordConfidenceStats:
    if not emission_lp_accum:
        return WordConfidenceStats(coverage_frame_count=coverage_frame_count)

    # f32 sequential accumulation, matching Rust `.iter().sum::<f32>()`
    acc = np.float32(0.0)
    for v in emission_lp_accum:
        acc = np.float32(acc + v)
    mean_logp = np.float32(acc / np.float32(len(emission_lp_accum)))

    sorted_lps = sorted(emission_lp_accum)
    min_logp = sorted_lps[0]
    p10_logp = _percentile_sorted(sorted_lps, 0.10)

    if emission_margin_accum:
        macc = np.float32(0.0)
        for v in emission_margin_accum:
            macc = np.float32(macc + v)
        mean_margin = float(np.float32(macc / np.float32(len(emission_margin_accum))))
    else:
        mean_margin = None

    # geo_mean = f32(max(exp(f64 mean_logp), f32::MIN_POSITIVE))
    geo_mean_prob = float(
        np.float32(max(np.exp(np.float64(mean_logp)), F32_MIN_POSITIVE))
    )

    return WordConfidenceStats(
        mean_logp=float(mean_logp),
        geo_mean_prob=geo_mean_prob,
        min_logp=float(min_logp),
        p10_logp=float(p10_logp),
        mean_margin=mean_margin,
        coverage_frame_count=coverage_frame_count,
    )


def _percentile_sorted(sorted_values: list[np.float32], percentile: float) -> np.float32:
    """Linear-interpolated percentile over a sorted list, f32 arithmetic
    (path_to_words.rs:320-339)."""
    if not sorted_values:
        return np.float32(0.0)
    if len(sorted_values) == 1:
        return sorted_values[0]
    clamped = np.float32(min(max(percentile, 0.0), 1.0))
    max_index = np.float32(len(sorted_values) - 1)
    rank = np.float32(clamped * max_index)
    lower = int(np.floor(rank))
    upper = int(np.ceil(rank))
    if lower == upper:
        return sorted_values[lower]
    weight = np.float32(rank - np.float32(lower))
    return np.float32(
        sorted_values[lower] * (np.float32(1.0) - weight)
        + sorted_values[upper] * weight
    )
