"""JSON report serialization (reference: json_report_formatter.rs:7-28).

Dataclass → JSON with the reference's field names (`global_` serializes as
"global", enum splits as lowercase strings, None-valued optional sections
preserved as null except where the reference skips them).
"""

from __future__ import annotations

import dataclasses
import json
from enum import Enum
from pathlib import Path

from ..align.report import Report

_SKIP_IF_NONE = {"timing", "per_word", "unknown", "memory"}
_RENAME = {"global_": "global", "id": "id"}


def _to_jsonable(obj):
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {}
        for f in dataclasses.fields(obj):
            value = getattr(obj, f.name)
            if value is None and f.name in _SKIP_IF_NONE:
                continue
            key = _RENAME.get(f.name, f.name)
            out[key] = _to_jsonable(value)
        return out
    if isinstance(obj, Enum):
        return obj.value
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(v) for v in obj]
    if isinstance(obj, dict):
        return {k: _to_jsonable(v) for k, v in obj.items()}
    return obj


def report_to_dict(report: Report) -> dict:
    d = _to_jsonable(report)
    # the internal word_abs_errors_ms buffer is #[serde(skip)] in the reference
    for sentence in d.get("sentences", []):
        sentence.pop("word_abs_errors_ms", None)
    return d


def write_report(report: Report, path: str | Path) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps(report_to_dict(report), indent=2) + "\n")
