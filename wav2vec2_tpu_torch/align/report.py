"""Evaluation & reporting (L5).

Carried over from `wav2vec2_tpu.align.report`: the behaviour of the Rust
reference's src/alignment/report.rs (1515 lines): per-sentence structural / confidence / timing metrics vs an optional
reference, aggregation with per-split distributions + pass rates, and
outlier ranking with per-word traces. All constants, formulas, sort orders
and tie-breaks match the reference:

- structural (report.rs:640-699): negative-duration words (end ≤ start),
  overlaps + overlap_ms, non-monotonic starts, invalid-confidence count,
  gap/overlap ratio of duration;
- confidence (report.rs:700-832): mean/min conf, adaptive low-conf threshold
  0.50 ± margin/boundary adjustments clamped [0.40, 0.60], low-conf ratio,
  avg margin, avg boundary confidence;
- timing (report.rs:843-926): start/end endpoint metrics (mean signed,
  median/p90/max abs), combined abs-err median/p90, 10%-trimmed mean, center
  offset, drift = end_mean_signed − start_mean_signed (+ per-second);
- aggregation (report.rs:289-561): mean/p50/p90/p95/p99 distributions over
  sentence metrics AND word-level abs errors; ≤50/100/150 ms pass rates at
  sentence-p90 and word level; top-20 outliers by abs_err_p90, |drift|
  (filtered to ≥3 s & ≥5 ref words), low-conf ratio with abs_err_p90
  tiebreak and id as final tiebreak.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from enum import Enum
from typing import Optional, Sequence

from ..errors import InvalidInputError
from ..types import WordTiming

OUTLIER_TOP_N = 20
EPS_DURATION_SEC = 0.001
BASE_LOW_CONF_THRESHOLD = 0.50
MIN_LOW_CONF_THRESHOLD = 0.40
MAX_LOW_CONF_THRESHOLD = 0.60
DRIFT_OUTLIER_MIN_DURATION_MS = 3_000
DRIFT_OUTLIER_MIN_WORD_COUNT = 5
PASS_RATE_THRESHOLDS_MS = (50.0, 100.0, 150.0)


class Split(str, Enum):
    CLEAN = "clean"
    OTHER = "other"
    UNKNOWN = "unknown"


@dataclass
class ReferenceWord:
    word: str
    start_ms: int
    end_ms: int


@dataclass
class StructuralMetrics:
    negative_duration_word_count: int = 0
    overlap_word_count: int = 0
    non_monotonic_word_count: int = 0
    invalid_confidence_word_count: int = 0
    gap_ratio: float = 0.0
    overlap_ratio: float = 0.0


@dataclass
class ConfidenceMetrics:
    word_conf_mean: float = 0.0
    word_conf_min: float = 0.0
    low_conf_threshold_used: float = BASE_LOW_CONF_THRESHOLD
    avg_word_margin: Optional[float] = None
    avg_boundary_confidence: Optional[float] = None
    low_conf_word_ratio: float = 0.0
    blank_frame_ratio: Optional[float] = None
    token_entropy_mean: Optional[float] = None


@dataclass
class EndpointMetrics:
    mean_signed_ms: float = 0.0
    median_abs_ms: float = 0.0
    p90_abs_ms: float = 0.0
    max_abs_ms: float = 0.0


@dataclass
class TimingMetrics:
    start: EndpointMetrics = field(default_factory=EndpointMetrics)
    end: EndpointMetrics = field(default_factory=EndpointMetrics)
    abs_err_ms_median: float = 0.0
    abs_err_ms_p90: float = 0.0
    trimmed_mean_abs_err_ms: float = 0.0
    offset_ms: float = 0.0
    drift_ms_per_sec: float = 0.0
    drift_delta_ms: float = 0.0


@dataclass
class PerWordTrace:
    word: str
    ref_start_ms: int
    ref_end_ms: int
    pred_start_ms: int
    pred_end_ms: int
    start_err_ms: float
    end_err_ms: float
    conf: Optional[float]
    quality_confidence: Optional[float]
    calibrated_confidence: Optional[float]
    mean_logp: Optional[float]
    geo_mean_prob: Optional[float]
    min_logp: Optional[float]
    p10_logp: Optional[float]
    mean_margin: Optional[float]
    coverage_frame_count: int
    boundary_confidence: Optional[float]


@dataclass
class SentenceReport:
    id: str
    split: Split
    has_reference: bool
    duration_ms: int
    word_count_pred: int
    word_count_ref: int
    structural: StructuralMetrics
    confidence: Optional[ConfidenceMetrics]
    timing: Optional[TimingMetrics]
    per_word: Optional[list[PerWordTrace]]
    notes: list[str]
    word_abs_errors_ms: list[float] = field(default_factory=list)


@dataclass
class MetricDistribution:
    mean: float
    p50: float
    p90: float
    p95: float
    p99: float


@dataclass
class ThresholdPassRates:
    le_50_ms: float
    le_100_ms: float
    le_150_ms: float


@dataclass
class AggregateMetrics:
    abs_err_ms_median: Optional[MetricDistribution] = None
    abs_err_ms_p90: Optional[MetricDistribution] = None
    drift_ms_per_sec: Optional[MetricDistribution] = None
    drift_delta_ms: Optional[MetricDistribution] = None
    low_conf_word_ratio: Optional[MetricDistribution] = None
    avg_word_margin: Optional[MetricDistribution] = None
    avg_boundary_confidence: Optional[MetricDistribution] = None
    blank_frame_ratio: Optional[MetricDistribution] = None
    abs_err_ms_p90_pass_rate: Optional[ThresholdPassRates] = None
    word_abs_err_ms: Optional[MetricDistribution] = None
    word_abs_err_pass_rate: Optional[ThresholdPassRates] = None


@dataclass
class OutlierEntry:
    id: str
    split: Split
    value: float


@dataclass
class OutlierReport:
    worst_abs_err_ms_p90: list[OutlierEntry]
    worst_drift_ms_per_sec: list[OutlierEntry]
    worst_low_conf_word_ratio: Optional[list[OutlierEntry]]


@dataclass
class AggregateCounts:
    total: int
    with_reference: int
    without_reference: int


@dataclass
class AggregateBySplit:
    clean: AggregateMetrics
    other: AggregateMetrics
    unknown: Optional[AggregateMetrics]


@dataclass
class AggregateReport:
    counts: AggregateCounts
    global_: AggregateMetrics
    by_split: AggregateBySplit
    outliers: OutlierReport


@dataclass
class Meta:
    generated_at: str
    model_path: str
    device: str
    frame_stride_ms: float
    case_count: int


@dataclass
class Report:
    schema_version: int
    meta: Meta
    sentences: list[SentenceReport]
    aggregates: AggregateReport


def infer_split(path_or_id: str) -> Split:
    normalized = path_or_id.lower()
    if "test-clean" in normalized:
        return Split.CLEAN
    if "test-other" in normalized:
        return Split.OTHER
    return Split.UNKNOWN


def compute_sentence_report(
    id: str,
    split: Split,
    predicted: Sequence[WordTiming],
    reference: Optional[Sequence[ReferenceWord]],
    duration_ms: int,
    frame_stats=None,
) -> SentenceReport:
    """`frame_stats` (types.UtteranceFrameStats) fills the
    blank_frame_ratio / token_entropy_mean fields the reference declares but
    never computes (report.rs ConfidenceMetrics placeholders)."""
    notes: list[str] = []
    reference_words = reference if reference is not None else []
    has_reference = reference is not None

    if not has_reference:
        notes.append("reference_missing")
    if not predicted:
        notes.append("no_predicted_words")
    if has_reference and not reference_words:
        notes.append("empty_reference_words")

    structural = _structural_metrics(predicted, duration_ms)
    if structural.invalid_confidence_word_count > 0:
        notes.append(
            f"invalid_confidence_words={structural.invalid_confidence_word_count}"
        )
    confidence = _confidence_metrics(predicted)
    if frame_stats is not None and confidence is not None:
        confidence.blank_frame_ratio = frame_stats.blank_frame_ratio
        confidence.token_entropy_mean = frame_stats.token_entropy_mean

    timing = None
    word_abs_errors: list[float] = []
    if has_reference:
        timing, word_abs_errors = _timing_metrics(
            predicted, reference_words, duration_ms, notes
        )
        if len(predicted) != len(reference_words):
            notes.append(
                f"word_count_mismatch:pred={len(predicted)} ref={len(reference_words)}"
            )
        mismatches = sum(
            1
            for p, r in zip(predicted, reference_words)
            if _normalize_word(p.word) != _normalize_word(r.word)
        )
        if mismatches > 0:
            notes.append(f"word_label_mismatches={mismatches}")

    return SentenceReport(
        id=id,
        split=split,
        has_reference=has_reference,
        duration_ms=duration_ms,
        word_count_pred=len(predicted),
        word_count_ref=len(reference_words),
        structural=structural,
        confidence=confidence,
        timing=timing,
        per_word=None,
        notes=notes,
        word_abs_errors_ms=word_abs_errors,
    )


def aggregate_reports(sentences: Sequence[SentenceReport]) -> AggregateReport:
    with_reference = [s for s in sentences if s.has_reference and s.timing is not None]
    global_ = _aggregate_metrics(with_reference)
    by_split = AggregateBySplit(
        clean=_aggregate_metrics([s for s in with_reference if s.split == Split.CLEAN]),
        other=_aggregate_metrics([s for s in with_reference if s.split == Split.OTHER]),
        unknown=(
            _aggregate_metrics(
                [s for s in with_reference if s.split == Split.UNKNOWN]
            )
            if any(s.split == Split.UNKNOWN for s in with_reference)
            else None
        ),
    )
    return AggregateReport(
        counts=AggregateCounts(
            total=len(sentences),
            with_reference=len(with_reference),
            without_reference=len(sentences) - len(with_reference),
        ),
        global_=global_,
        by_split=by_split,
        outliers=_build_outliers(with_reference, OUTLIER_TOP_N),
    )


def attach_outlier_traces(
    sentences: list[SentenceReport],
    predicted_by_id: dict[str, list[WordTiming]],
    references_by_id: dict[str, list[ReferenceWord]],
    top_n: int,
) -> None:
    """Attach per-word traces to the top-N worst abs_err_p90 sentences
    (report.rs:318-382; ties broken by ascending id)."""
    ranked = sorted(
        (
            (s.id, s.timing.abs_err_ms_p90)
            for s in sentences
            if s.timing is not None
        ),
        key=lambda kv: (-kv[1], kv[0]),
    )
    outlier_ids = {id for id, _ in ranked[:top_n]}
    for s in sentences:
        if s.id not in outlier_ids:
            continue
        predicted = predicted_by_id.get(s.id)
        reference = references_by_id.get(s.id)
        if predicted is None or reference is None:
            continue
        traces = []
        for pred, ref in zip(predicted, reference):
            cs = pred.confidence_stats
            traces.append(
                PerWordTrace(
                    word=ref.word,
                    ref_start_ms=ref.start_ms,
                    ref_end_ms=ref.end_ms,
                    pred_start_ms=pred.start_ms,
                    pred_end_ms=pred.end_ms,
                    start_err_ms=float(pred.start_ms - ref.start_ms),
                    end_err_ms=float(pred.end_ms - ref.end_ms),
                    conf=pred.confidence,
                    quality_confidence=cs.quality_confidence,
                    calibrated_confidence=(
                        cs.calibrated_confidence
                        if cs.calibrated_confidence is not None
                        else pred.confidence
                    ),
                    mean_logp=cs.mean_logp,
                    geo_mean_prob=cs.geo_mean_prob,
                    min_logp=cs.min_logp,
                    p10_logp=cs.p10_logp,
                    mean_margin=cs.mean_margin,
                    coverage_frame_count=cs.coverage_frame_count,
                    boundary_confidence=cs.boundary_confidence,
                )
            )
        if traces:
            s.per_word = traces


# --- internals ---


def _structural_metrics(
    predicted: Sequence[WordTiming], duration_ms: int
) -> StructuralMetrics:
    negative = sum(1 for w in predicted if w.end_ms <= w.start_ms)
    invalid_conf = sum(
        1
        for w in predicted
        if w.confidence is None
        or w.confidence_stats.geo_mean_prob is None
        or w.confidence_stats.coverage_frame_count == 0
    )
    overlap_count = 0
    non_monotonic = 0
    gap_ms = 0
    overlap_ms = 0
    for cur, nxt in zip(predicted, predicted[1:]):
        if cur.end_ms > nxt.start_ms:
            overlap_count += 1
            overlap_ms += max(cur.end_ms - nxt.start_ms, 0)
        else:
            gap_ms += max(nxt.start_ms - cur.end_ms, 0)
        if cur.start_ms > nxt.start_ms:
            non_monotonic += 1
    denom = float(duration_ms)
    return StructuralMetrics(
        negative_duration_word_count=negative,
        overlap_word_count=overlap_count,
        non_monotonic_word_count=non_monotonic,
        invalid_confidence_word_count=invalid_conf,
        gap_ratio=_checked(gap_ms / denom if denom > 0 else 0.0, "structural.gap_ratio"),
        overlap_ratio=_checked(
            overlap_ms / denom if denom > 0 else 0.0, "structural.overlap_ratio"
        ),
    )


def _tuned_low_conf_threshold(predicted: Sequence[WordTiming]) -> float:
    margins = [
        w.confidence_stats.mean_margin
        for w in predicted
        if w.confidence_stats.mean_margin is not None
    ]
    boundaries = [
        w.confidence_stats.boundary_confidence
        for w in predicted
        if w.confidence_stats.boundary_confidence is not None
    ]
    threshold = BASE_LOW_CONF_THRESHOLD
    if margins:
        avg_margin = _mean(margins)
        margin_score = 1.0 / (1.0 + math.exp(-((avg_margin - 3.0) / 1.5)))
        threshold += (0.5 - margin_score) * 0.12
    if boundaries:
        avg_boundary = min(max(_mean(boundaries), 0.0), 1.0)
        threshold -= (avg_boundary - 0.5) * 0.06
    return min(max(threshold, MIN_LOW_CONF_THRESHOLD), MAX_LOW_CONF_THRESHOLD)


def _confidence_metrics(predicted: Sequence[WordTiming]) -> ConfidenceMetrics:
    if not predicted:
        return ConfidenceMetrics()
    threshold = _tuned_low_conf_threshold(predicted)
    conf_values = [w.confidence for w in predicted if w.confidence is not None]
    margin_values = [
        w.confidence_stats.mean_margin
        for w in predicted
        if w.confidence_stats.mean_margin is not None
    ]
    boundary_values = [
        w.confidence_stats.boundary_confidence
        for w in predicted
        if w.confidence_stats.boundary_confidence is not None
    ]
    low_conf = 0
    for w in predicted:
        is_invalid = w.confidence is None or w.confidence_stats.coverage_frame_count == 0
        is_low = is_invalid or (
            w.confidence is not None and w.confidence < threshold
        )
        if is_low:
            low_conf += 1
    return ConfidenceMetrics(
        word_conf_mean=_checked(
            _mean(conf_values) if conf_values else 0.0, "confidence.word_conf_mean"
        ),
        word_conf_min=_checked(
            min(conf_values) if conf_values else 0.0, "confidence.word_conf_min"
        ),
        low_conf_threshold_used=_checked(threshold, "confidence.low_conf_threshold_used"),
        avg_word_margin=(
            _checked(_mean(margin_values), "confidence.avg_word_margin")
            if margin_values
            else None
        ),
        avg_boundary_confidence=(
            _checked(_mean(boundary_values), "confidence.avg_boundary_confidence")
            if boundary_values
            else None
        ),
        low_conf_word_ratio=_checked(
            low_conf / len(predicted), "confidence.low_conf_word_ratio"
        ),
        blank_frame_ratio=None,
        token_entropy_mean=None,
    )


def _timing_metrics(
    predicted: Sequence[WordTiming],
    reference: Sequence[ReferenceWord],
    duration_ms: int,
    notes: list[str],
) -> tuple[TimingMetrics, list[float]]:
    paired_len = min(len(predicted), len(reference))
    if paired_len == 0:
        notes.append("no_aligned_word_pairs_for_timing")
        return TimingMetrics(), []

    start_signed, end_signed, center_signed, abs_all = [], [], [], []
    for pred, ref in zip(predicted, reference):
        start_err = float(pred.start_ms - ref.start_ms)
        end_err = float(pred.end_ms - ref.end_ms)
        center_err = (
            (pred.start_ms + pred.end_ms) - (ref.start_ms + ref.end_ms)
        ) / 2.0
        start_signed.append(start_err)
        end_signed.append(end_err)
        center_signed.append(center_err)
        abs_all.append(abs(start_err))
        abs_all.append(abs(end_err))

    start = _endpoint_metrics(start_signed)
    end = _endpoint_metrics(end_signed)
    abs_sorted = sorted(abs_all)
    duration_sec = max(duration_ms / 1000.0, EPS_DURATION_SEC)
    drift_delta = end.mean_signed_ms - start.mean_signed_ms
    metrics = TimingMetrics(
        start=start,
        end=end,
        abs_err_ms_median=_checked(_median_sorted(abs_sorted), "timing.abs_err_ms_median"),
        abs_err_ms_p90=_checked(
            _percentile_sorted(abs_sorted, 0.9), "timing.abs_err_ms_p90"
        ),
        trimmed_mean_abs_err_ms=_checked(
            _trimmed_mean_drop_top(abs_all, 0.1), "timing.trimmed_mean_abs_err_ms"
        ),
        offset_ms=_checked(_mean(center_signed), "timing.offset_ms"),
        drift_ms_per_sec=_checked(drift_delta / duration_sec, "timing.drift_ms_per_sec"),
        drift_delta_ms=_checked(drift_delta, "timing.drift_delta_ms"),
    )
    return metrics, list(abs_all)


def _endpoint_metrics(signed_errors: list[float]) -> EndpointMetrics:
    if not signed_errors:
        return EndpointMetrics()
    abs_values = sorted(abs(v) for v in signed_errors)
    return EndpointMetrics(
        mean_signed_ms=_mean(signed_errors),
        median_abs_ms=_median_sorted(abs_values),
        p90_abs_ms=_percentile_sorted(abs_values, 0.9),
        max_abs_ms=abs_values[-1],
    )


def _aggregate_metrics(sentences: Sequence[SentenceReport]) -> AggregateMetrics:
    abs_med, abs_p90, drift_ps, drift_d = [], [], [], []
    low_conf, margins, boundaries, blanks, word_abs = [], [], [], [], []
    for s in sentences:
        if s.timing is not None:
            abs_med.append(s.timing.abs_err_ms_median)
            abs_p90.append(s.timing.abs_err_ms_p90)
            drift_ps.append(s.timing.drift_ms_per_sec)
            drift_d.append(s.timing.drift_delta_ms)
            word_abs.extend(s.word_abs_errors_ms)
        if s.confidence is not None:
            low_conf.append(s.confidence.low_conf_word_ratio)
            if s.confidence.avg_word_margin is not None:
                margins.append(s.confidence.avg_word_margin)
            if s.confidence.avg_boundary_confidence is not None:
                boundaries.append(s.confidence.avg_boundary_confidence)
            if s.confidence.blank_frame_ratio is not None:
                blanks.append(s.confidence.blank_frame_ratio)
    return AggregateMetrics(
        abs_err_ms_median=_distribution(abs_med),
        abs_err_ms_p90=_distribution(abs_p90),
        drift_ms_per_sec=_distribution(drift_ps),
        drift_delta_ms=_distribution(drift_d),
        low_conf_word_ratio=_distribution(low_conf),
        avg_word_margin=_distribution(margins),
        avg_boundary_confidence=_distribution(boundaries),
        blank_frame_ratio=_distribution(blanks),
        abs_err_ms_p90_pass_rate=_pass_rates(abs_p90),
        word_abs_err_ms=_distribution(word_abs),
        word_abs_err_pass_rate=_pass_rates(word_abs),
    )


def _build_outliers(
    sentences: Sequence[SentenceReport], top_n: int
) -> OutlierReport:
    worst_abs = _ranked(
        sentences, top_n,
        metric=lambda s: s.timing.abs_err_ms_p90 if s.timing else None,
    )
    drift_candidates = [
        s
        for s in sentences
        if s.duration_ms >= DRIFT_OUTLIER_MIN_DURATION_MS
        and s.word_count_ref >= DRIFT_OUTLIER_MIN_WORD_COUNT
    ] or list(sentences)
    worst_drift = _ranked(
        drift_candidates, top_n,
        metric=lambda s: s.timing.drift_ms_per_sec if s.timing else None,
        sort_score=lambda v, s: abs(v),
        secondary=_abs_p90_tiebreak,
    )
    low_conf = _ranked(
        sentences, top_n,
        metric=lambda s: s.confidence.low_conf_word_ratio if s.confidence else None,
        secondary=_abs_p90_tiebreak,
    )
    return OutlierReport(
        worst_abs_err_ms_p90=worst_abs,
        worst_drift_ms_per_sec=worst_drift,
        worst_low_conf_word_ratio=low_conf if low_conf else None,
    )


def _abs_p90_tiebreak(s: SentenceReport) -> float:
    return s.timing.abs_err_ms_p90 if s.timing is not None else 0.0


def _ranked(
    sentences: Sequence[SentenceReport],
    top_n: int,
    metric,
    sort_score=lambda v, s: v,
    secondary=lambda s: 0.0,
) -> list[OutlierEntry]:
    entries = []
    for s in sentences:
        value = metric(s)
        if value is None:
            continue
        sv = sort_score(value, s)
        tb = secondary(s)
        if not (math.isfinite(value) and math.isfinite(sv) and math.isfinite(tb)):
            continue
        entries.append((sv, tb, s.id, OutlierEntry(id=s.id, split=s.split, value=value)))
    entries.sort(key=lambda e: (-e[0], -e[1], e[2]))
    return [e[3] for e in entries[:top_n]]


def _distribution(values: Sequence[float]) -> Optional[MetricDistribution]:
    if not values:
        return None
    sorted_v = sorted(values)
    return MetricDistribution(
        mean=_checked(_mean(sorted_v), "aggregate.mean"),
        p50=_checked(_percentile_sorted(sorted_v, 0.5), "aggregate.p50"),
        p90=_checked(_percentile_sorted(sorted_v, 0.9), "aggregate.p90"),
        p95=_checked(_percentile_sorted(sorted_v, 0.95), "aggregate.p95"),
        p99=_checked(_percentile_sorted(sorted_v, 0.99), "aggregate.p99"),
    )


def _pass_rates(values: Sequence[float]) -> Optional[ThresholdPassRates]:
    if not values:
        return None
    n = len(values)
    t50, t100, t150 = PASS_RATE_THRESHOLDS_MS
    return ThresholdPassRates(
        le_50_ms=sum(1 for v in values if v <= t50) / n,
        le_100_ms=sum(1 for v in values if v <= t100) / n,
        le_150_ms=sum(1 for v in values if v <= t150) / n,
    )


def _mean(values: Sequence[float]) -> float:
    return sum(values) / len(values) if values else 0.0


def _median_sorted(sorted_values: Sequence[float]) -> float:
    if not sorted_values:
        return 0.0
    mid = len(sorted_values) // 2
    if len(sorted_values) % 2 == 0:
        return (sorted_values[mid - 1] + sorted_values[mid]) / 2.0
    return sorted_values[mid]


def _percentile_sorted(sorted_values: Sequence[float], percentile: float) -> float:
    if not sorted_values:
        return 0.0
    if len(sorted_values) == 1:
        return sorted_values[0]
    clamped = min(max(percentile, 0.0), 1.0)
    rank = clamped * (len(sorted_values) - 1)
    lower = math.floor(rank)
    upper = math.ceil(rank)
    if lower == upper:
        return sorted_values[lower]
    weight = rank - lower
    return sorted_values[lower] * (1.0 - weight) + sorted_values[upper] * weight


def _trimmed_mean_drop_top(values: Sequence[float], top_fraction: float) -> float:
    if not values:
        return 0.0
    sorted_v = sorted(values)
    drop = math.floor(len(sorted_v) * min(max(top_fraction, 0.0), 1.0))
    keep = max(len(sorted_v) - drop, 1)
    return _mean(sorted_v[:keep])


def _normalize_word(word: str) -> str:
    upper = word.strip().upper()
    return "UNK" if upper in ("<UNK>", "UNK") else upper


def _checked(value: float, metric_name: str) -> float:
    if not math.isfinite(value):
        raise InvalidInputError(
            f"metric {metric_name!r} produced non-finite value: {value}"
        )
    return float(value)
