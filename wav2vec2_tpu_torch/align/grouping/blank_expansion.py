"""Phase 2: expand word boundaries into adjacent blank gaps.

Exact arithmetic from the Rust reference, src/alignment/grouping/blank_expansion.rs:89-118:
per inter-word gap (gap = next_start - prev_end - 1, skipped when ≤ 0):

    min_silence = min(policy.min_interior_silence_frames, gap)
    absorb      = gap - min_silence
    left_take   = min(absorb, policy.max_left_expansion_frames)
    right_take  = min(absorb - left_take, policy.max_right_pullback_frames)
    prev.end   += left_take
    next.start -= right_take

Leading and trailing silence are never attributed to words
(blank_expansion.rs:81-83). Policy budgets (balanced 12/6/4,
conservative_start 10/2/6, aggressive_tail 16/4/2) live in
AlignerHyperParams.expansion_policies.
"""

from __future__ import annotations

from typing import Sequence

from ...config import ExpansionPolicyConfig
from .path_to_words import RawWord


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
