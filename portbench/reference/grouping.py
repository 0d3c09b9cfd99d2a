"""Word grouping of the plain reference: a path and per-frame evidence →
word timings.

A frozen copy of the port's Python grouping path (the behavioural oracle
that its native engine is held to bit for bit): collect the raw words
from the path, expand blanks with each policy and select the best
candidate, then score confidence and convert to the [start_ms, end_ms)
contract. Word units only. It imports nothing of the port; the types and
hyperparameters it needs are copied here with the defaults the port
uses.
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass, field, replace
from typing import Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)


@dataclass
class WordConfidenceStats:
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
    word: str
    start_ms: int
    end_ms: int
    confidence: Optional[float] = None
    confidence_stats: WordConfidenceStats = field(default_factory=WordConfidenceStats)


@dataclass(frozen=True)
class ExpansionPolicyConfig:
    name: str
    max_left_expansion_frames: int
    max_right_pullback_frames: int
    min_interior_silence_frames: int


@dataclass
class AlignerHyperParams:
    expansion_policies: tuple[ExpansionPolicyConfig, ...] = (
        ExpansionPolicyConfig("balanced", 12, 6, 4),
        ExpansionPolicyConfig("conservative_start", 10, 2, 6),
        ExpansionPolicyConfig("aggressive_tail", 16, 4, 2),
    )
    weight_boundary_confidence: float = 3.2
    weight_boundary_shift: float = 0.8
    weight_pause_plausibility: float = 1.3
    large_gap_threshold_frames: int = 8
    overlap_penalty_per_frame: float = 12.0
    near_collapse_penalty: float = 4.0
    weight_geo_mean: float = 0.40
    weight_margin: float = 0.30
    weight_p10: float = 0.20
    weight_boundary: float = 0.10
    calibration_knots: tuple[tuple[float, float], ...] = (
        (0.00, 0.02), (0.20, 0.12), (0.35, 0.28), (0.50, 0.50),
        (0.65, 0.72), (0.80, 0.88), (0.95, 0.97), (1.00, 0.99),
    )


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


def expand_with_policy(
    words: Sequence[RawWord],
    first_frame: int,
    last_frame: int,
    policy: ExpansionPolicyConfig,
) -> list[RawWord]:
    """Returns a fresh candidate list (the reference clones raw words per
    candidate, grouping/mod.rs:97); inputs are never mutated."""
    out = [w.copy() for w in words]
    if not out:
        return out

    for i in range(len(out) - 1):
        prev_end = out[i].end_frame
        next_start = out[i + 1].start_frame
        if next_start <= prev_end + 1:
            continue
        gap = next_start - prev_end - 1
        min_silence = min(policy.min_interior_silence_frames, gap)
        absorb_budget = gap - min_silence
        left_take = min(absorb_budget, policy.max_left_expansion_frames)
        right_take = min(
            max(absorb_budget - left_take, 0), policy.max_right_pullback_frames
        )
        out[i].end_frame = prev_end + left_take
        out[i + 1].start_frame = next_start - right_take

    return out


def quality_confidence_score(
    stats: WordConfidenceStats, hp: AlignerHyperParams
) -> Optional[float]:
    if stats.geo_mean_prob is None:
        return None
    geo = float(np.float32(stats.geo_mean_prob))

    weighted_sum = 0.0
    total_weight = 0.0

    weighted_sum += hp.weight_geo_mean * geo
    total_weight += hp.weight_geo_mean

    if stats.mean_margin is not None:
        margin_score = _sigmoid((float(np.float32(stats.mean_margin)) - 1.0) / 1.5)
        weighted_sum += hp.weight_margin * margin_score
        total_weight += hp.weight_margin

    if stats.p10_logp is not None:
        p10_prob = min(max(math.exp(float(np.float32(stats.p10_logp))), 0.0), 1.0)
        weighted_sum += hp.weight_p10 * p10_prob
        total_weight += hp.weight_p10

    boundary_score = (
        float(np.float32(stats.boundary_confidence))
        if stats.boundary_confidence is not None
        else 0.5
    )
    weighted_sum += hp.weight_boundary * min(max(boundary_score, 0.0), 1.0)
    total_weight += hp.weight_boundary

    if total_weight <= 0.0:
        return None
    return float(np.float32(min(max(weighted_sum / total_weight, 0.0), 1.0)))


def _sigmoid(x: float) -> float:
    return 1.0 / (1.0 + math.exp(-x))


def calibrate_quality_confidence(score: float, hp: AlignerHyperParams) -> float:
    knots = hp.calibration_knots
    x = min(max(float(np.float32(score)), 0.0), 1.0)
    for (x0, y0), (x1, y1) in zip(knots, knots[1:]):
        if x <= x1:
            t = 0.0 if abs(x1 - x0) < np.finfo(np.float64).eps else (x - x0) / (x1 - x0)
            return float(np.float32(min(max(y0 + t * (y1 - y0), 0.0), 1.0)))
    return 0.99


@dataclass
class ScoreBreakdown:
    boundary_confidence_term: float
    boundary_shift_penalty: float
    pause_penalty: float
    total_score: float


@dataclass
class SelectedCandidate:
    policy: ExpansionPolicyConfig
    words: list[RawWord]
    score: ScoreBreakdown


def select_best(
    raw_words: Sequence[RawWord],
    candidates: Sequence[tuple[ExpansionPolicyConfig, list[RawWord]]],
    evidence: FrameEvidence,
    hp: AlignerHyperParams,
) -> Optional[SelectedCandidate]:
    best: Optional[SelectedCandidate] = None
    balanced_name = hp.expansion_policies[0].name

    for policy, words in candidates:
        score, per_word_bc = _score_candidate(raw_words, words, evidence, hp)
        for word, bc in zip(words, per_word_bc):
            word.confidence_stats.boundary_confidence = bc

        if best is None:
            should_replace = True
        elif score.total_score > best.score.total_score + 1e-6:
            should_replace = True
        elif (
            abs(score.total_score - best.score.total_score) <= 1e-6
            and policy.name == balanced_name
            and best.policy.name != balanced_name
        ):
            should_replace = True
        else:
            should_replace = False

        if should_replace:
            best = SelectedCandidate(policy=policy, words=words, score=score)

    return best


def _score_candidate(
    raw_words: Sequence[RawWord],
    candidate_words: Sequence[RawWord],
    evidence: FrameEvidence,
    hp: AlignerHyperParams,
) -> tuple[ScoreBreakdown, list[Optional[float]]]:
    if not raw_words or len(raw_words) != len(candidate_words):
        return (
            ScoreBreakdown(0.0, 1_000_000.0, 1_000_000.0, -2_000_000.0),
            [],
        )

    n = float(len(raw_words))
    mean_blank_prob, per_word_bc = _compute_boundary_evidence(
        raw_words, candidate_words, evidence
    )

    shift_sum = 0.0
    for raw, cand in zip(raw_words, candidate_words):
        start_shift = float(abs(cand.start_frame - raw.start_frame))
        end_shift = float(abs(cand.end_frame - raw.end_frame))
        conf_weight = 0.75 + float(
            np.float32(raw.confidence) if raw.confidence is not None else 0.0
        )
        shift_sum += conf_weight * (start_shift + end_shift)
    boundary_shift_penalty = shift_sum / n

    pause_penalty = 0.0
    gap_count = 0
    for i in range(len(raw_words) - 1):
        raw_gap = raw_words[i + 1].start_frame - raw_words[i].end_frame - 1
        cand_gap = candidate_words[i + 1].start_frame - candidate_words[i].end_frame - 1
        gap_count += 1
        if cand_gap < 0:
            pause_penalty += float(-cand_gap) * hp.overlap_penalty_per_frame
        if raw_gap >= hp.large_gap_threshold_frames:
            collapsed = float(max(raw_gap - cand_gap, 0))
            pause_penalty += collapsed
            if cand_gap <= 1:
                pause_penalty += hp.near_collapse_penalty
    if gap_count > 0:
        pause_penalty /= float(gap_count)

    total_score = (
        hp.weight_boundary_confidence * mean_blank_prob
        - hp.weight_boundary_shift * boundary_shift_penalty
        - hp.weight_pause_plausibility * pause_penalty
    )
    return (
        ScoreBreakdown(
            boundary_confidence_term=mean_blank_prob,
            boundary_shift_penalty=boundary_shift_penalty,
            pause_penalty=pause_penalty,
            total_score=total_score,
        ),
        per_word_bc,
    )


def _compute_boundary_evidence(
    raw_words: Sequence[RawWord],
    candidate_words: Sequence[RawWord],
    evidence: FrameEvidence,
) -> tuple[float, list[Optional[float]]]:
    """Mean blank probability over all frames absorbed by the expansion,
    globally and per word (candidate_selector.rs:186-234). blank_prob is the
    f64-widened f32 exp, matching blank_prob_at_frame (:236-240)."""
    if not candidate_words:
        return 0.0, []

    t_len = evidence.t_len
    blank_sum = 0.0
    count = 0
    per_word_sum = [0.0] * len(candidate_words)
    per_word_count = [0] * len(candidate_words)

    def absorb(frames: range, idx: int) -> None:
        nonlocal blank_sum, count
        for frame in frames:
            if 0 <= frame < t_len:
                bp = float(evidence.blank_prob[frame])
                blank_sum += bp
                count += 1
                per_word_sum[idx] += bp
                per_word_count[idx] += 1

    for idx, (raw, cand) in enumerate(zip(raw_words, candidate_words)):
        if cand.start_frame < raw.start_frame:
            absorb(range(cand.start_frame, raw.start_frame), idx)
        if cand.end_frame > raw.end_frame:
            absorb(range(raw.end_frame + 1, cand.end_frame + 1), idx)

    per_word_bc: list[Optional[float]] = [
        float(np.float32(s / c)) if c else None
        for s, c in zip(per_word_sum, per_word_count)
    ]
    if count == 0:
        return 0.0, per_word_bc
    return blank_sum / count, per_word_bc


def frame_evidence_from_log_probs(log_probs, tokens, path_states, blank_id) -> FrameEvidence:
    """Per-frame evidence from [T, V] log-probs along a path (f32)."""
    lp = np.asarray(log_probs, dtype=np.float32)
    t_len = lp.shape[0]
    states = np.asarray(path_states, dtype=np.int64)
    tok = np.asarray(tokens, dtype=np.int64)
    emit_lp = lp[np.arange(t_len), tok[states[:t_len]]]
    top2 = np.partition(lp, -2, axis=1)[:, -2:]
    margin = top2[:, 1] - top2[:, 0]
    margin = np.where(np.isfinite(top2).all(axis=1), margin, np.float32(0.0))
    blank_prob = np.exp(lp[:, blank_id]).astype(np.float64)
    probs = np.exp(lp)
    entropy = (-(probs * lp).sum(axis=1)).astype(np.float32)
    return FrameEvidence(emit_lp=emit_lp.astype(np.float32), margin=margin.astype(np.float32),
                         blank_prob=blank_prob, entropy=entropy)


def group_into_words(path_states, tokens, chars, expected_words, evidence: FrameEvidence,
                     blank_id: int, word_sep_id: int, stride_ms: float,
                     hp: AlignerHyperParams | None = None) -> list[WordTiming]:
    """Path states [T] (state of frame t) → word timings."""
    hp = hp or AlignerHyperParams()
    path = [(int(s), t) for t, s in enumerate(path_states)]
    raw = collect(path, tokens, chars, expected_words, evidence, blank_id, word_sep_id)
    if not raw:
        return []
    first_frame = path[0][1] if path else 0
    last_frame = path[-1][1] if path else 0
    candidates = [(pc, expand_with_policy(raw, first_frame, last_frame, pc))
                  for pc in hp.expansion_policies]
    chosen = select_best(raw, candidates, evidence, hp)
    expanded = (chosen.words if chosen is not None
                else expand_with_policy(raw, first_frame, last_frame, hp.expansion_policies[0]))
    words = []
    for w in expanded:
        start_ms = int(w.start_frame * stride_ms)
        end_ms = int((w.end_frame + 1) * stride_ms)
        qc = quality_confidence_score(w.confidence_stats, hp)
        cc = calibrate_quality_confidence(qc, hp) if qc is not None else None
        w.confidence_stats.quality_confidence = qc
        w.confidence_stats.calibrated_confidence = cc
        words.append(WordTiming(word=w.word, start_ms=start_ms, end_ms=end_ms, confidence=cc,
                                confidence_stats=w.confidence_stats))
    return words
