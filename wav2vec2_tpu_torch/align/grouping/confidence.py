"""Composite word confidence + piecewise-linear calibration.

Exact formulas from the Rust reference, src/alignment/grouping/mod.rs:163-226:

    quality = (0.40·geo + 0.30·sigmoid((margin−1)/1.5) + 0.20·exp(p10_logp)
               + 0.10·boundary(default 0.5)) / present_weights, clamped [0,1]

then calibrated through the 8-knot piecewise-linear map
(0,.02)(,.12)(,.28)(,.50)(,.72)(,.88)(,.97)(1,.99). Missing stats drop their
weight from the normalizer; geo_mean_prob missing ⇒ None. f64 arithmetic,
f32 result — matching the Rust types.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from ...config import AlignerHyperParams
from ...types import WordConfidenceStats


def quality_confidence_score(
    stats: WordConfidenceStats, hp: AlignerHyperParams
) -> Optional[float]:
    if stats.geo_mean_prob is None:
        return None
    geo = float(np.float32(stats.geo_mean_prob))

    weighted_sum = 0.0
    total_weight = 0.0

    weighted_sum += hp.weight_geo_mean * geo
    total_weight += hp.weight_geo_mean

    if stats.mean_margin is not None:
        margin_score = _sigmoid((float(np.float32(stats.mean_margin)) - 1.0) / 1.5)
        weighted_sum += hp.weight_margin * margin_score
        total_weight += hp.weight_margin

    if stats.p10_logp is not None:
        p10_prob = min(max(math.exp(float(np.float32(stats.p10_logp))), 0.0), 1.0)
        weighted_sum += hp.weight_p10 * p10_prob
        total_weight += hp.weight_p10

    boundary_score = (
        float(np.float32(stats.boundary_confidence))
        if stats.boundary_confidence is not None
        else 0.5
    )
    weighted_sum += hp.weight_boundary * min(max(boundary_score, 0.0), 1.0)
    total_weight += hp.weight_boundary

    if total_weight <= 0.0:
        return None
    return float(np.float32(min(max(weighted_sum / total_weight, 0.0), 1.0)))


def _sigmoid(x: float) -> float:
    return 1.0 / (1.0 + math.exp(-x))


def calibrate_quality_confidence(score: float, hp: AlignerHyperParams) -> float:
    knots = hp.calibration_knots
    x = min(max(float(np.float32(score)), 0.0), 1.0)
    for (x0, y0), (x1, y1) in zip(knots, knots[1:]):
        if x <= x1:
            t = 0.0 if abs(x1 - x0) < np.finfo(np.float64).eps else (x - x0) / (x1 - x0)
            return float(np.float32(min(max(y0 + t * (y1 - y0), 0.0), 1.0)))
    return 0.99
