"""Transcript → blank-interleaved CTC state sequence.

Behavioral contract from the Rust reference, src/alignment/tokenization.rs:63-116:

- Vocab casing detection (tokenization.rs:5-26): if the vocab's alphabetic
  chars are uppercase-only, the transcript is uppercased; otherwise (lowercase
  or mixed) it is lowercased.
- Per word, characters not in the vocab are silently dropped; words with no
  known characters are skipped entirely (tokenization.rs:37-47).
- Sequence shape: leading blank always; per emitted char `⟨c, blank⟩`; between
  words `⟨sep, blank⟩` (tokenization.rs:48-59). Example for "ab":
  [blank, a, blank, b, blank].
- Parallel `chars` array: None for blanks, '|' for separators, the char
  otherwise. `normalized_words` must equal the words rebuilt from `chars`
  (tokenization.rs:86-90 contract).
"""

from __future__ import annotations

from typing import Optional

from ..types import TokenSequence


def _vocab_casing(vocab: dict[str, int]) -> tuple[bool, bool]:
    has_upper = False
    has_lower = False
    for c in vocab:
        if c.isalpha():
            if c.isupper():
                has_upper = True
            if c.islower():
                has_lower = True
    return has_upper, has_lower


def normalize_transcript_case(transcript: str, vocab: dict[str, int]) -> str:
    has_upper, has_lower = _vocab_casing(vocab)
    if has_upper and not has_lower:
        return transcript.upper()
    return transcript.lower()


def _emit_word(
    word: str,
    vocab: dict[str, int],
    word_sep_id: int,
    blank_id: int,
    tokens: list[int],
    chars: list[Optional[str]],
    normalized_words: list[str],
) -> None:
    emitted: list[tuple[str, int]] = []
    normalized_word_chars: list[str] = []
    for c in word:
        token_id = vocab.get(c)
        if token_id is not None:
            emitted.append((c, token_id))
            normalized_word_chars.append(c)
    if not emitted:
        return
    if normalized_words:
        tokens.append(word_sep_id)
        chars.append("|")
        tokens.append(blank_id)
        chars.append(None)
    for c, token_id in emitted:
        tokens.append(token_id)
        chars.append(c)
        tokens.append(blank_id)
        chars.append(None)
    normalized_words.append("".join(normalized_word_chars))


def build_token_sequence_case_aware(
    transcript: str,
    vocab: dict[str, int],
    blank_id: int,
    word_sep_id: int,
) -> TokenSequence:
    cleaned = normalize_transcript_case(transcript, vocab)
    tokens: list[int] = [blank_id]
    chars: list[Optional[str]] = [None]
    normalized_words: list[str] = []

    for word in cleaned.split():
        _emit_word(word, vocab, word_sep_id, blank_id, tokens, chars, normalized_words)

    assert normalized_words == rebuild_words_from_chars(chars), (
        "tokenization normalization contract violated"
    )
    return TokenSequence(tokens=tokens, chars=chars, normalized_words=normalized_words)


def rebuild_words_from_chars(chars: list[Optional[str]]) -> list[str]:
    """Reconstruct words from the char stream ('|' flushes, None skipped) —
    reference tokenization.rs:99-116."""
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


def build_token_sequence_phoneme(
    transcript: str,
    vocab: dict[str, int],
    blank_id: int,
    word_sep_id: int,
) -> TokenSequence:
    """Phoneme-CTC tokenization: the transcript is WHITESPACE-SEPARATED
    phoneme symbols (possibly multi-codepoint, e.g. "ɛ̃" or "tʃ"), each
    looked up in the vocab verbatim — no casing normalization, no per-char
    splitting (the word path's single-char vocab contract does not apply to
    phoneme vocabs). Unknown symbols are dropped, mirroring the word
    tokenizer's unknown-char rule. A literal "|" symbol (or the symbol
    mapping to word_sep_id) emits a word separator state, letting phoneme
    transcripts keep word boundaries.

    Sequence shape matches the word path (leading blank, ⟨sym, blank⟩ per
    emission, ⟨sep, blank⟩ at boundaries) so every Viterbi backend and the
    evidence extractor work unchanged; `chars[s]` holds the full symbol.
    `normalized_words` contains one entry per emitted phoneme (each unit is
    its own report row; rebuild_words_from_chars does not apply to
    multi-codepoint symbols).
    """
    tokens: list[int] = [blank_id]
    chars: list[Optional[str]] = [None]
    normalized_words: list[str] = []

    emitted_any = False
    for sym in transcript.split():
        token_id = vocab.get(sym)
        if token_id is None:
            continue
        if sym == "|" or token_id == word_sep_id:
            if emitted_any and tokens[-2] != word_sep_id:
                tokens.append(word_sep_id)
                chars.append("|")
                tokens.append(blank_id)
                chars.append(None)
            continue
        tokens.append(token_id)
        chars.append(sym)
        tokens.append(blank_id)
        chars.append(None)
        normalized_words.append(sym)
        emitted_any = True
    return TokenSequence(tokens=tokens, chars=chars, normalized_words=normalized_words)
