"""Phase 3: score each expansion policy's candidate and pick the best.

Exact scoring from the Rust reference, src/alignment/grouping/candidate_selector.rs:

    total = 3.2 · mean_blank_prob_over_absorbed_frames
          − 0.8 · conf_weighted_mean_boundary_shift
          − 1.3 · pause_penalty                       (weights :4-9)

- boundary shift per word: (0.75 + raw.confidence) · (|Δstart| + |Δend|),
  averaged over words (:91-101);
- pause penalty per gap: overlap × 12/frame; for raw gaps ≥ 8 frames, add
  collapsed frame count and +4 when the candidate gap ≤ 1 (near-collapse);
  averaged over gaps (:103-126);
- candidates with mismatched word counts score −2e6 (:75-85);
- ties (≤ 1e-6) prefer the balanced policy (:43-54);
- per-word boundary_confidence = mean blank prob over frames that word
  absorbed (f64 mean → f32, :186-234) is written into every candidate's
  stats before selection.

All accumulation in f64 like the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from ...config import AlignerHyperParams, ExpansionPolicyConfig
from .path_to_words import FrameEvidence, RawWord


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
