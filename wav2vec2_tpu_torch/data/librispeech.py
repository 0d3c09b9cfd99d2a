"""LibriSpeech-layout dataset discovery and case loading.

Mirrors the reference CLI's dataset handling
(src/bin/alignment_report.rs in the Rust reference):

- root resolution (:60-110): `root/LibriSpeech/{test-clean,test-other}` when
  `root/LibriSpeech` exists, else every direct child of root that contains
  `*.trans.txt` recursively;
- trans.txt cases (:1061-1134): each line `ID transcript...`, sibling audio
  `ID.flac` required (we also accept `.wav`);
- TextGrid cases (json mode, :1042-1059): recurse `*.TextGrid`, words tier
  becomes the reference; transcript from the `transcript` tier when present
  else the joined words;
- case filter file (:1447-1514): one entry per line, fuzzy audio-ID
  extraction (basename without extension; tolerates full paths and
  suffixes).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

from ..align.report import ReferenceWord

LIBRISPEECH_SUBSETS = ("test-clean", "test-other")


@dataclass
class Case:
    id: str
    audio_path: str  # relative to dataset root, '/'-separated
    transcript: str
    reference_words: list[ReferenceWord] = field(default_factory=list)
    has_reference: bool = False


def resolve_dataset_base_and_subsets(dataset_root: str | Path) -> tuple[Path, list[Path]]:
    dataset_root = Path(dataset_root)
    librispeech_dir = dataset_root / "LibriSpeech"
    if librispeech_dir.is_dir():
        return dataset_root, [librispeech_dir / s for s in LIBRISPEECH_SUBSETS]
    subset_dirs = sorted(
        p
        for p in dataset_root.iterdir()
        if p.is_dir() and any(p.rglob("*.trans.txt"))
    )
    if not subset_dirs:
        raise FileNotFoundError(
            f"No dataset found: neither '{librispeech_dir}' nor any direct "
            f"subdir with *.trans.txt under '{dataset_root}'."
        )
    return dataset_root, subset_dirs


def load_cases_from_transcripts(
    dataset_root: Path, subset_dirs: list[Path]
) -> list[Case]:
    cases: list[Case] = []
    for subset_dir in subset_dirs:
        if not subset_dir.exists():
            raise FileNotFoundError(f"Missing subset directory: {subset_dir}")
        trans_files = sorted(subset_dir.rglob("*.trans.txt"))
        if not trans_files:
            raise FileNotFoundError(f"No *.trans.txt files found in '{subset_dir}'.")
        for trans_path in trans_files:
            for line_no, raw in enumerate(trans_path.read_text().splitlines(), 1):
                line = raw.strip()
                if not line:
                    continue
                parts = line.split(None, 1)
                if len(parts) < 2 or not parts[1].strip():
                    continue
                case_id, transcript = parts[0], parts[1].strip()
                audio_abs = trans_path.parent / f"{case_id}.flac"
                if not audio_abs.exists():
                    wav = trans_path.parent / f"{case_id}.wav"
                    if wav.exists():
                        audio_abs = wav
                    else:
                        raise FileNotFoundError(
                            f"Missing sibling audio for transcript entry "
                            f"'{case_id}' at line {line_no} in '{trans_path}'."
                        )
                rel = audio_abs.relative_to(dataset_root).as_posix()
                cases.append(Case(id=case_id, audio_path=rel, transcript=transcript))
    return cases


def load_cases_from_textgrids(
    dataset_root: Path, subset_dirs: list[Path]
) -> list[Case]:
    from .textgrid import parse_textgrid_file

    cases: list[Case] = []
    for subset_dir in subset_dirs:
        if not subset_dir.exists():
            raise FileNotFoundError(f"Missing subset directory: {subset_dir}")
        tg_files = sorted(subset_dir.rglob("*.TextGrid"))
        if not tg_files:
            raise FileNotFoundError(f"No TextGrid files found in '{subset_dir}'.")
        for tg_path in tg_files:
            tg = parse_textgrid_file(tg_path)
            words_tier = tg.tier("words")
            reference_words = []
            if words_tier is not None:
                for iv in words_tier.intervals:
                    word = iv.text.strip()
                    if word:
                        reference_words.append(
                            ReferenceWord(
                                word=word,
                                start_ms=int(round(iv.xmin * 1000)),
                                end_ms=int(round(iv.xmax * 1000)),
                            )
                        )
            transcript_tier = tg.tier("transcript")
            if transcript_tier is not None and transcript_tier.intervals:
                transcript = transcript_tier.intervals[0].text.strip()
            else:
                transcript = " ".join(w.word for w in reference_words)
            audio_abs = _audio_for_textgrid(tg_path)
            if audio_abs is None:
                continue
            rel = audio_abs.relative_to(dataset_root).as_posix()
            cases.append(
                Case(
                    id=tg_path.stem,
                    audio_path=rel,
                    transcript=transcript,
                    reference_words=reference_words,
                    has_reference=True,
                )
            )
    return cases


def _audio_for_textgrid(tg_path: Path) -> Optional[Path]:
    for ext in (".flac", ".wav"):
        p = tg_path.with_suffix(ext)
        if p.exists():
            return p
    return None


def extract_audio_id(entry: str) -> str:
    """Fuzzy audio-ID extraction for case filter files
    (alignment_report.rs:1447-1514): strip directories and a single audio /
    TextGrid extension."""
    name = entry.strip().replace("\\", "/").rsplit("/", 1)[-1]
    for ext in (".flac", ".wav", ".textgrid", ".TextGrid"):
        if name.lower().endswith(ext.lower()):
            name = name[: -len(ext)]
            break
    return name


def load_case_filter(path: str | Path) -> set[str]:
    ids = set()
    for raw in Path(path).read_text().splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        ids.add(extract_audio_id(line))
    return ids


def filter_cases(
    cases: list[Case],
    case_ids: Optional[set[str]] = None,
    offset: int = 0,
    limit: Optional[int] = None,
) -> list[Case]:
    out = cases
    if case_ids:
        out = [c for c in out if c.id in case_ids or extract_audio_id(c.audio_path) in case_ids]
    out = out[offset:]
    if limit is not None:
        out = out[:limit]
    return out
