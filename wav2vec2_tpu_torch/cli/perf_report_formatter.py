"""Perf output: JSONL records + aggregate summary.

Schema v1, field-compatible with the reference
(src/bin/alignment_report/perf_report_formatter.rs:8-259)
and with the Python-reference benchmark's records
(scripts/wav2vec2aligner_librispeech_textgrids.py) so the existing
comparison tooling reads both.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from datetime import datetime, timezone
from pathlib import Path
from typing import Optional

PERF_SCHEMA_VERSION = 1


@dataclass
class GpuMemorySnapshot:
    # None (null in the JSON) where no device reading could be taken
    gpu_used: Optional[int]
    gpu_total: Optional[int]
    # additive extension over the reference schema: host RSS peak for the
    # stage (the reference tracks RSS separately; comparison tools ignore
    # unknown fields)
    rss_peak: Optional[int] = None


@dataclass
class PerfMemory:
    forward: Optional[GpuMemorySnapshot] = None
    post: Optional[GpuMemorySnapshot] = None
    dp: Optional[GpuMemorySnapshot] = None
    group: Optional[GpuMemorySnapshot] = None
    conf: Optional[GpuMemorySnapshot] = None


@dataclass
class PerfRunConfig:
    warmup: int
    repeats: int
    aggregate: str
    append: bool


@dataclass
class PerfUtteranceRecord:
    utterance_id: str
    audio_path: str
    duration_ms: int
    num_frames_t: int
    state_len: int
    ts_product: int
    vocab_size: int
    dtype: str
    device: str
    frame_stride_ms: float
    warmup: int
    repeats: int
    aggregate: str
    forward_ms: float
    post_ms: float
    dp_ms: float
    group_ms: float
    conf_ms: float
    align_ms: float
    align_ms_per_ts: float
    align_ms_per_t: float
    total_ms: float
    forward_ms_repeats: list[float] = field(default_factory=list)
    post_ms_repeats: list[float] = field(default_factory=list)
    dp_ms_repeats: list[float] = field(default_factory=list)
    group_ms_repeats: list[float] = field(default_factory=list)
    conf_ms_repeats: list[float] = field(default_factory=list)
    align_ms_repeats: list[float] = field(default_factory=list)
    total_ms_repeats: list[float] = field(default_factory=list)
    memory: Optional[PerfMemory] = None


@dataclass
class PerfMetricStats:
    mean: float
    median: float
    min: float
    max: float


@dataclass
class PerfAggregateStats:
    utterance_count: int
    forward_ms: PerfMetricStats
    post_ms: PerfMetricStats
    dp_ms: PerfMetricStats
    group_ms: PerfMetricStats
    conf_ms: PerfMetricStats
    align_ms: PerfMetricStats
    align_ms_per_ts: PerfMetricStats
    align_ms_per_t: PerfMetricStats
    total_ms: PerfMetricStats


def record_to_json(record: PerfUtteranceRecord) -> str:
    d = asdict(record)
    if d.get("memory") is None:
        d.pop("memory", None)
    else:
        # stages that were not measured are left out; a device reading
        # that could not be taken stays in as null
        d["memory"] = {k: v for k, v in d["memory"].items() if v is not None}
    return json.dumps(d)


def metric_stats(values: list[float]) -> PerfMetricStats:
    if not values:
        return PerfMetricStats(0.0, 0.0, 0.0, 0.0)
    s = sorted(values)
    n = len(s)
    median = s[n // 2] if n % 2 else (s[n // 2 - 1] + s[n // 2]) / 2.0
    return PerfMetricStats(
        mean=sum(s) / n, median=median, min=s[0], max=s[-1]
    )


def aggregate_stats(records: list[PerfUtteranceRecord]) -> PerfAggregateStats:
    def col(name):
        return metric_stats([getattr(r, name) for r in records])

    return PerfAggregateStats(
        utterance_count=len(records),
        forward_ms=col("forward_ms"),
        post_ms=col("post_ms"),
        dp_ms=col("dp_ms"),
        group_ms=col("group_ms"),
        conf_ms=col("conf_ms"),
        align_ms=col("align_ms"),
        align_ms_per_ts=col("align_ms_per_ts"),
        align_ms_per_t=col("align_ms_per_t"),
        total_ms=col("total_ms"),
    )


class PerfJsonlAppender:
    """Buffered JSONL appender (perf_report_formatter.rs:123-175)."""

    def __init__(self, path: str | Path):
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(path, "a", buffering=2 * 1024 * 1024)

    def append(self, record: PerfUtteranceRecord) -> None:
        self._fh.write(record_to_json(record))
        self._fh.write("\n")

    def finish(self) -> None:
        self._fh.flush()
        self._fh.close()


def _now_iso() -> str:
    return datetime.now(timezone.utc).isoformat()


def write_json_report(
    path: str | Path,
    config: PerfRunConfig,
    records: list[PerfUtteranceRecord],
    aggregate: PerfAggregateStats,
) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    payload = {
        "schema_version": PERF_SCHEMA_VERSION,
        "generated_at": _now_iso(),
        "config": asdict(config),
        "records": [json.loads(record_to_json(r)) for r in records],
        "aggregate": asdict(aggregate),
    }
    Path(path).write_text(json.dumps(payload, indent=2) + "\n")


def write_summary_report(
    path: str | Path, config: PerfRunConfig, aggregate: PerfAggregateStats
) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    payload = {
        "schema_version": PERF_SCHEMA_VERSION,
        "generated_at": _now_iso(),
        "config": asdict(config),
        "aggregate": asdict(aggregate),
    }
    Path(path).write_text(json.dumps(payload, indent=2) + "\n")


def summary_path_for(path: str | Path) -> Path:
    return Path(str(path) + ".summary.json")
