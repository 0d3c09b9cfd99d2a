"""Core I/O types of the alignment framework.

Mirrors the Rust reference, src/types.rs:1-52 (AlignmentInput, WordTiming,
WordConfidenceStats, AlignmentOutput, TokenSequence) with the same field
semantics, including the `[start_ms, end_ms)` half-open interval contract.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class AlignmentInput:
    """One utterance to align.

    `normalized` caches pre-normalized (zero-mean/unit-variance) audio so
    benchmark repeats skip normalization (reference: types.rs:6-7).
    """

    sample_rate_hz: int
    samples: np.ndarray  # float32 [N]
    transcript: str
    normalized: Optional[np.ndarray] = None  # float32 [N]


@dataclass
class WordConfidenceStats:
    """Per-word acoustic confidence statistics (reference: types.rs:24-38)."""

    mean_logp: Optional[float] = None
    geo_mean_prob: Optional[float] = None
    quality_confidence: Optional[float] = None
    calibrated_confidence: Optional[float] = None
    min_logp: Optional[float] = None
    p10_logp: Optional[float] = None
    mean_margin: Optional[float] = None
    coverage_frame_count: int = 0
    boundary_confidence: Optional[float] = None


@dataclass
class WordTiming:
    """One aligned word. Millisecond interval is [start_ms, end_ms)
    (start inclusive / end exclusive) — reference types.rs:11-22."""

    word: str
    start_ms: int
    end_ms: int
    confidence: Optional[float] = None
    confidence_stats: WordConfidenceStats = field(default_factory=WordConfidenceStats)


@dataclass
class UtteranceFrameStats:
    """Utterance-level frame statistics the reference's report declares but
    never fills (ConfidenceMetrics.blank_frame_ratio / token_entropy_mean,
    report.rs:84-86) — computed on device here."""

    blank_frame_ratio: Optional[float] = None
    token_entropy_mean: Optional[float] = None


@dataclass
class AlignmentOutput:
    words: list[WordTiming] = field(default_factory=list)
    frame_stats: Optional[UtteranceFrameStats] = None


@dataclass
class TokenSequence:
    """Blank-interleaved CTC state sequence (reference: types.rs:45-52).

    `tokens[s]` is the vocab id of state s; `chars[s]` is None for blanks,
    '|' for word separators, and the emitted character otherwise.
    `normalized_words` is the transcript normalized with the same logic that
    produced the chars.
    """

    tokens: list[int] = field(default_factory=list)
    chars: list[Optional[str]] = field(default_factory=list)
    normalized_words: list[str] = field(default_factory=list)
