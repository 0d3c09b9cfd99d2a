"""Praat TextGrid reading/writing.

Writer mirrors the reference's 3-tier output
(src/bin/alignment_report/text_grid_report_formatter.rs:7-141):
`words`, `words-confidence` (2-decimal text), and a single-interval
`transcript` tier; words are sorted, clamped to the audio duration, forced
monotone non-overlapping via a running `last_end_ms`, and empty intervals
dropped.

Parser is the hand-rolled long-format line parser the reference uses as its
fallback (alignment_report.rs:1188-1403): extracts interval tiers by name,
tolerant of whitespace variations.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Sequence

from ..types import WordTiming


@dataclass
class TextGridInterval:
    xmin: float
    xmax: float
    text: str


@dataclass
class TextGridTier:
    name: str
    xmin: float
    xmax: float
    intervals: list[TextGridInterval] = field(default_factory=list)


@dataclass
class TextGridFile:
    xmin: float
    xmax: float
    tiers: list[TextGridTier] = field(default_factory=list)

    def tier(self, name: str) -> Optional[TextGridTier]:
        for t in self.tiers:
            if t.name == name:
                return t
        return None


def _ms_to_sec(ms: int) -> float:
    return ms / 1000.0


def build_textgrid(
    transcript: str,
    words: Sequence[WordTiming],
    duration_ms: int,
) -> TextGridFile:
    max_word_end = max((w.end_ms for w in words), default=0)
    total_ms = max(duration_ms, max_word_end, 1)
    xmax = _ms_to_sec(total_ms)

    sorted_words = sorted(words, key=lambda w: (w.start_ms, w.end_ms))
    word_ints: list[TextGridInterval] = []
    conf_ints: list[TextGridInterval] = []
    last_end_ms = 0
    for w in sorted_words:
        start_ms = max(min(w.start_ms, total_ms), last_end_ms)
        end_ms = min(w.end_ms, total_ms)
        if end_ms <= start_ms:
            continue
        word_ints.append(
            TextGridInterval(_ms_to_sec(start_ms), _ms_to_sec(end_ms), w.word)
        )
        conf_text = f"{w.confidence:.2f}" if w.confidence is not None else ""
        conf_ints.append(
            TextGridInterval(_ms_to_sec(start_ms), _ms_to_sec(end_ms), conf_text)
        )
        last_end_ms = end_ms

    tg = TextGridFile(xmin=0.0, xmax=xmax)
    tg.tiers.append(TextGridTier("words", 0.0, xmax, word_ints))
    tg.tiers.append(TextGridTier("words-confidence", 0.0, xmax, conf_ints))
    transcript_text = transcript.strip()
    if transcript_text:
        tg.tiers.append(
            TextGridTier(
                "transcript", 0.0, xmax,
                [TextGridInterval(0.0, xmax, transcript_text)],
            )
        )
    return tg


def write_textgrid_file(tg: TextGridFile, path: str | Path) -> None:
    """Serialize in Praat long text format."""
    lines = [
        'File type = "ooTextFile"',
        'Object class = "TextGrid"',
        "",
        f"xmin = {tg.xmin} ",
        f"xmax = {tg.xmax} ",
        "tiers? <exists> ",
        f"size = {len(tg.tiers)} ",
        "item []: ",
    ]
    for i, tier in enumerate(tg.tiers, start=1):
        lines += [
            f"    item [{i}]:",
            '        class = "IntervalTier" ',
            f'        name = "{tier.name}" ',
            f"        xmin = {tier.xmin} ",
            f"        xmax = {tier.xmax} ",
            f"        intervals: size = {len(tier.intervals)} ",
        ]
        for j, iv in enumerate(tier.intervals, start=1):
            text = iv.text.replace('"', '""')
            lines += [
                f"        intervals [{j}]:",
                f"            xmin = {iv.xmin} ",
                f"            xmax = {iv.xmax} ",
                f'            text = "{text}" ',
            ]
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text("\n".join(lines) + "\n")


def write_textgrid(
    audio_path: str | Path,
    transcript: str,
    words: Sequence[WordTiming],
    duration_ms: int,
    suffix: str = "",
) -> Path:
    """Write `<audio stem><suffix>.TextGrid` next to the audio file
    (text_grid_report_formatter.rs:7-141 contract)."""
    audio_path = Path(audio_path)
    out_path = audio_path.with_name(f"{audio_path.stem}{suffix}.TextGrid")
    tg = build_textgrid(transcript, words, duration_ms)
    write_textgrid_file(tg, out_path)
    return out_path


_NUM_RE = re.compile(r"(?:xmin|xmax)\s*=\s*([-\d.eE+]+)")
_NAME_RE = re.compile(r'name\s*=\s*"(.*)"\s*$')
_CLASS_RE = re.compile(r'class\s*=\s*"(.*)"\s*$')
_TEXT_RE = re.compile(r'text\s*=\s*"(.*)"\s*$')
_SIZE_RE = re.compile(r"size\s*=\s*(\d+)")


def parse_textgrid_file(path: str | Path) -> TextGridFile:
    """Tolerant long-format parser (the reference's fallback line parser,
    alignment_report.rs:1188-1403)."""
    text = Path(path).read_text(errors="replace")
    return parse_textgrid_text(text)


def parse_textgrid_text(text: str) -> TextGridFile:
    lines = [ln.strip() for ln in text.splitlines()]
    tg = TextGridFile(xmin=0.0, xmax=0.0)

    tier: Optional[TextGridTier] = None
    tier_class = ""
    cur: Optional[dict] = None
    in_item = False
    header_bounds: list[float] = []

    def flush_interval():
        nonlocal cur
        if (
            cur is not None
            and tier is not None
            and tier_class.lower() == "intervaltier"
            and "xmin" in cur
            and "xmax" in cur
        ):
            tier.intervals.append(
                TextGridInterval(cur["xmin"], cur["xmax"], cur.get("text", ""))
            )
        cur = None

    for ln in lines:
        if ln.startswith("item ["):
            flush_interval()
            if ln.replace(" ", "").startswith("item[]"):
                in_item = False
                continue
            if tier is not None:
                tg.tiers.append(tier)
            tier = TextGridTier("", 0.0, 0.0)
            tier_class = ""
            in_item = True
            continue
        if ln.startswith("intervals [") or ln.startswith("points ["):
            flush_interval()
            cur = {}
            continue
        m = _CLASS_RE.search(ln)
        if m and in_item and tier is not None and not tier_class:
            tier_class = m.group(1)
            continue
        m = _NAME_RE.search(ln)
        if m and in_item and tier is not None and not tier.name:
            tier.name = m.group(1)
            continue
        m = _TEXT_RE.search(ln)
        if m and cur is not None:
            cur["text"] = m.group(1).replace('""', '"')
            continue
        m = re.search(r"xmin\s*=\s*([-\d.eE+]+)", ln)
        if m:
            v = float(m.group(1))
            if cur is not None:
                cur["xmin"] = v
            elif tier is not None and in_item:
                tier.xmin = v
            else:
                header_bounds.append(v)
                tg.xmin = header_bounds[0] if len(header_bounds) == 1 else tg.xmin
            continue
        m = re.search(r"xmax\s*=\s*([-\d.eE+]+)", ln)
        if m:
            v = float(m.group(1))
            if cur is not None:
                cur["xmax"] = v
            elif tier is not None and in_item:
                tier.xmax = v
            else:
                tg.xmax = max(tg.xmax, v)
            continue

    flush_interval()
    if tier is not None:
        tg.tiers.append(tier)
    return tg


def reference_words_from_textgrid(path: str | Path) -> list:
    """Extract the `words` tier as ReferenceWord list (non-empty intervals),
    as the json-mode case loader does (alignment_report.rs:1042-1059)."""
    from ..align.report import ReferenceWord

    tg = parse_textgrid_file(path)
    tier = tg.tier("words")
    if tier is None:
        return []
    out = []
    for iv in tier.intervals:
        word = iv.text.strip()
        if not word:
            continue
        out.append(
            ReferenceWord(
                word=word,
                start_ms=int(round(iv.xmin * 1000)),
                end_ms=int(round(iv.xmax * 1000)),
            )
        )
    return out
