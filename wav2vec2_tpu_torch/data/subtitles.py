"""Subtitle output (SRT / WebVTT) from word timings.

Beyond-parity formatter (the reference emits json/textgrid/perf only,
text_grid_report_formatter.rs:7-141): forced-alignment word boundaries map
directly onto caption cues, which is a primary consumer of this kind of
tool. Cue-building follows common captioning practice: break on long
inter-word gaps, line-length and duration caps; cue times snap to the
first/last word's boundaries (the `[start, end)` ms contract of
WordTiming, types.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Sequence

from ..types import WordTiming


@dataclass
class Cue:
    start_ms: int
    end_ms: int
    text: str


def words_to_cues(
    words: Sequence[WordTiming],
    max_chars: int = 42,
    max_gap_ms: int = 1000,
    max_duration_ms: int = 5000,
) -> list[Cue]:
    """Group word timings into subtitle cues.

    A new cue starts when adding the next word would exceed `max_chars`
    (one line of ~42 chars, the common broadcast guideline), when the gap
    since the previous word exceeds `max_gap_ms` (silence = caption
    boundary), or when the cue would span more than `max_duration_ms`.
    """
    cues: list[Cue] = []
    cur: list[WordTiming] = []

    def _flush():
        if cur:
            cues.append(Cue(
                start_ms=cur[0].start_ms,
                end_ms=cur[-1].end_ms,
                text=" ".join(w.word for w in cur),
            ))
            cur.clear()

    for w in words:
        if cur:
            text_len = len(" ".join(x.word for x in cur)) + 1 + len(w.word)
            gap = w.start_ms - cur[-1].end_ms
            dur = w.end_ms - cur[0].start_ms
            if text_len > max_chars or gap > max_gap_ms or dur > max_duration_ms:
                _flush()
        cur.append(w)
    _flush()
    return cues


def _timestamp(ms: int, sep: str) -> str:
    h, rem = divmod(max(ms, 0), 3_600_000)
    m, rem = divmod(rem, 60_000)
    s, milli = divmod(rem, 1000)
    return f"{h:02d}:{m:02d}:{s:02d}{sep}{milli:03d}"


def format_srt(cues: Sequence[Cue]) -> str:
    blocks = []
    for i, c in enumerate(cues, 1):
        blocks.append(
            f"{i}\n{_timestamp(c.start_ms, ',')} --> "
            f"{_timestamp(c.end_ms, ',')}\n{c.text}\n"
        )
    return "\n".join(blocks)


def format_vtt(cues: Sequence[Cue]) -> str:
    blocks = ["WEBVTT\n"]
    for c in cues:
        blocks.append(
            f"{_timestamp(c.start_ms, '.')} --> "
            f"{_timestamp(c.end_ms, '.')}\n{c.text}\n"
        )
    return "\n".join(blocks)


def write_subtitles(
    audio_path: str | Path,
    words: Sequence[WordTiming],
    fmt: str,
    suffix: str = "",
    **cue_kwargs,
) -> Path:
    """Write `<audio stem><suffix>.{srt,vtt}` next to the audio file (the
    textgrid formatter's placement contract)."""
    if fmt not in ("srt", "vtt"):
        raise ValueError(f"unknown subtitle format: {fmt!r}")
    cues = words_to_cues(words, **cue_kwargs)
    audio_path = Path(audio_path)
    out = audio_path.with_name(f"{audio_path.stem}{suffix}.{fmt}")
    out.write_text(format_srt(cues) if fmt == "srt" else format_vtt(cues))
    return out
