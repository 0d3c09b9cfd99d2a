"""Transcript → blank-interleaved CTC state sequence, for the reference.

A frozen copy of the port's case-aware tokenization (word units): the
transcript takes the vocab's case, characters outside the vocab are
dropped, a word with none left is skipped; the sequence is a leading
blank, then per character (char, blank) and between words (sep, blank).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class TokenSequence:
    tokens: list[int] = field(default_factory=list)
    chars: list[Optional[str]] = field(default_factory=list)
    normalized_words: list[str] = field(default_factory=list)


def tokenize(transcript: str, vocab: dict[str, int], blank_id: int,
             word_sep_id: int) -> TokenSequence:
    letters = [c for c in vocab if c.isalpha()]
    upper_only = any(c.isupper() for c in letters) and not any(c.islower() for c in letters)
    cleaned = transcript.upper() if upper_only else transcript.lower()
    seq = TokenSequence(tokens=[blank_id], chars=[None])
    for word in cleaned.split():
        kept = [c for c in word if c in vocab]
        if not kept:
            continue
        if seq.normalized_words:
            seq.tokens += [word_sep_id, blank_id]
            seq.chars += ["|", None]
        for c in kept:
            seq.tokens += [vocab[c], blank_id]
            seq.chars += [c, None]
        seq.normalized_words.append("".join(kept))
    return seq
