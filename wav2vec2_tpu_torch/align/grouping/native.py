"""ctypes binding for the native C++ grouping engine (native/grouping.cpp).

Carried over from `wav2vec2_tpu.align.grouping.native`, with the port's own
build of the library (`utils.native_build`: `build/torch_native/`, never
`native/` or the JAX package's directory). The compiled engine plays the
role the reference's Rust grouping plays: the host hot loop at serving
throughput, beside the next batch's forward. Output is bit-identical to the
Python implementation — same f32 accumulation orders, f64 widenings, and
tie-breaking — enforced by tests/test_torch_port_native.py (goldens +
randomized equivalence, and against the JAX package's engine).

The Python path remains the oracle and handles everything the native path
declines: per-stage memory instrumentation (`measure` hook), debug logging,
exotic vocab characters whose lowercase form expands to multiple
codepoints, and any marshalling/limit failure (automatic fallback).
"""

from __future__ import annotations

import ctypes
import logging
import threading
from typing import Optional, Sequence

import numpy as np

from ...config import AlignerHyperParams
from ...types import WordConfidenceStats, WordTiming
from .path_to_words import FrameEvidence

logger = logging.getLogger(__name__)

_lib = None
_lib_failed = False
_lock = threading.Lock()

_MAX_POLICIES = 8
_MAX_KNOTS = 16


class _Policy(ctypes.Structure):
    _fields_ = [
        ("max_left", ctypes.c_int32),
        ("max_right", ctypes.c_int32),
        ("min_silence", ctypes.c_int32),
        ("is_balanced", ctypes.c_int32),
    ]


class _HyperParams(ctypes.Structure):
    _fields_ = [
        ("weight_boundary_confidence", ctypes.c_double),
        ("weight_boundary_shift", ctypes.c_double),
        ("weight_pause_plausibility", ctypes.c_double),
        ("large_gap_threshold_frames", ctypes.c_int32),
        ("overlap_penalty_per_frame", ctypes.c_double),
        ("near_collapse_penalty", ctypes.c_double),
        ("weight_geo_mean", ctypes.c_double),
        ("weight_margin", ctypes.c_double),
        ("weight_p10", ctypes.c_double),
        ("weight_boundary", ctypes.c_double),
        ("n_policies", ctypes.c_int32),
        ("n_knots", ctypes.c_int32),
        ("policies", _Policy * _MAX_POLICIES),
        ("knots", (ctypes.c_double * 2) * _MAX_KNOTS),
    ]


class _OutWord(ctypes.Structure):
    _fields_ = [
        ("state_offset", ctypes.c_int32),
        ("state_len", ctypes.c_int32),
        ("start_ms", ctypes.c_int32),
        ("end_ms", ctypes.c_int32),
        ("coverage_frame_count", ctypes.c_int32),
        ("has_confidence", ctypes.c_int32),
        ("has_mean_logp", ctypes.c_int32),
        ("has_geo", ctypes.c_int32),
        ("has_min", ctypes.c_int32),
        ("has_p10", ctypes.c_int32),
        ("has_margin", ctypes.c_int32),
        ("has_bc", ctypes.c_int32),
        ("has_qc", ctypes.c_int32),
        ("has_cc", ctypes.c_int32),
        ("confidence", ctypes.c_float),
        ("mean_logp", ctypes.c_float),
        ("geo_mean_prob", ctypes.c_float),
        ("min_logp", ctypes.c_float),
        ("p10_logp", ctypes.c_float),
        ("mean_margin", ctypes.c_float),
        ("boundary_confidence", ctypes.c_float),
        ("quality_confidence", ctypes.c_float),
        ("calibrated_confidence", ctypes.c_float),
    ]


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            from ...utils import native_build

            lib = native_build.load("grouping")
            lib.group_words_native.restype = ctypes.c_int32
            lib.group_words_native.argtypes = [
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,   # path
                ctypes.POINTER(ctypes.c_int32),                    # tokens
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,    # lchar, s_len
                ctypes.POINTER(ctypes.c_uint32),                   # exp offsets
                ctypes.POINTER(ctypes.c_uint32), ctypes.c_int32,   # exp cps
                ctypes.POINTER(ctypes.c_float),                    # emit_lp
                ctypes.POINTER(ctypes.c_float),                    # margin
                ctypes.POINTER(ctypes.c_double),                   # blank_prob
                ctypes.c_int32, ctypes.c_int32, ctypes.c_double,   # ids, stride
                ctypes.POINTER(_HyperParams),
                ctypes.POINTER(_OutWord), ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
                ctypes.POINTER(ctypes.c_double),
            ]
            _lib = lib
        except Exception as e:  # missing toolchain, load failure, ...
            logger.info("native grouping unavailable (%s); using Python path", e)
            _lib_failed = True
    return _lib


def native_available() -> bool:
    return _load() is not None


def _hp_struct(hp: AlignerHyperParams) -> Optional[_HyperParams]:
    if not (1 <= len(hp.expansion_policies) <= _MAX_POLICIES):
        return None
    if not (2 <= len(hp.calibration_knots) <= _MAX_KNOTS):
        return None
    s = _HyperParams()
    s.weight_boundary_confidence = hp.weight_boundary_confidence
    s.weight_boundary_shift = hp.weight_boundary_shift
    s.weight_pause_plausibility = hp.weight_pause_plausibility
    s.large_gap_threshold_frames = hp.large_gap_threshold_frames
    s.overlap_penalty_per_frame = hp.overlap_penalty_per_frame
    s.near_collapse_penalty = hp.near_collapse_penalty
    s.weight_geo_mean = hp.weight_geo_mean
    s.weight_margin = hp.weight_margin
    s.weight_p10 = hp.weight_p10
    s.weight_boundary = hp.weight_boundary
    s.n_policies = len(hp.expansion_policies)
    s.n_knots = len(hp.calibration_knots)
    balanced_name = hp.expansion_policies[0].name
    for i, pc in enumerate(hp.expansion_policies):
        s.policies[i] = _Policy(
            pc.max_left_expansion_frames, pc.max_right_pullback_frames,
            pc.min_interior_silence_frames, 1 if pc.name == balanced_name else 0,
        )
    for i, (x, y) in enumerate(hp.calibration_knots):
        s.knots[i][0] = x
        s.knots[i][1] = y
    return s


def group_into_words_native(
    path_states: Sequence[int],
    tokens: Sequence[int],
    chars: Sequence[Optional[str]],
    expected_words: Sequence[str],
    evidence: FrameEvidence,
    blank_id: int,
    word_sep_id: int,
    stride_ms: float,
    hp: AlignerHyperParams,
) -> Optional[tuple[list[WordTiming], float, float, float]]:
    """Native grouping. Returns (words, conf_ms, collect_ms,
    expand_select_ms) or None when the native path can't serve this call
    (library missing, exotic casing, limits) — caller falls back to Python."""
    lib = _load()
    if lib is None:
        return None
    hps = _hp_struct(hp)
    if hps is None:
        return None

    s_len = len(tokens)
    # per-state lowercase codepoint (-1 for blank/sep states); decline when
    # a char's lowercase form expands to multiple codepoints (e.g. 'İ') so
    # the Python path's str.lower() semantics stay authoritative
    lchar = np.full(s_len, -1, np.int32)
    for i, c in enumerate(chars):
        if c is None or c == "|":
            continue
        lc = c.lower()
        if len(lc) != 1:
            return None
        lchar[i] = ord(lc)

    exp_off = np.zeros(len(expected_words) + 1, np.uint32)
    cps: list[int] = []
    for i, w in enumerate(expected_words):
        lw = w.lower()
        if lw != "".join(ch.lower() for ch in w):
            # context-sensitive lowercasing (Unicode Final_Sigma: 'ΘΕΟΣ' →
            # 'θεος' with final 'ς', but per-char lower gives 'σ'): the C++
            # engine lowercases per char, so its match test would diverge
            # from the Python oracle — decline and let the oracle run
            return None
        cps.extend(ord(ch) for ch in lw)
        exp_off[i + 1] = len(cps)
    exp_cps = np.asarray(cps or [0], np.uint32)

    t_len = evidence.t_len
    path_arr = np.ascontiguousarray(path_states, np.int32)
    if path_arr.shape[0] != t_len:  # contract mismatch: let the oracle decide
        return None
    tokens_arr = np.ascontiguousarray(tokens, np.int32)
    emit = np.ascontiguousarray(evidence.emit_lp, np.float32)
    marg = np.ascontiguousarray(evidence.margin, np.float32)
    blank = np.ascontiguousarray(evidence.blank_prob, np.float64)

    # a monotone CTC path enters each char state at most once, so emitted
    # chars (and hence words) are bounded by the state count
    max_words = s_len + 8
    max_states = s_len + 8
    out_words = (_OutWord * max_words)()
    out_state_idx = np.zeros(max_states, np.int32)
    timings = np.zeros(3, np.float64)

    def p(a, ct):
        return a.ctypes.data_as(ctypes.POINTER(ct))

    n = lib.group_words_native(
        p(path_arr, ctypes.c_int32), t_len,
        p(tokens_arr, ctypes.c_int32),
        p(lchar, ctypes.c_int32), s_len,
        p(exp_off, ctypes.c_uint32),
        p(exp_cps, ctypes.c_uint32), len(expected_words),
        p(emit, ctypes.c_float), p(marg, ctypes.c_float),
        p(blank, ctypes.c_double),
        blank_id, word_sep_id, float(stride_ms),
        ctypes.byref(hps),
        out_words, max_words,
        p(out_state_idx, ctypes.c_int32), max_states,
        p(timings, ctypes.c_double),
    )
    if n < 0:
        logger.warning("native grouping returned %d; falling back to Python", n)
        return None

    words: list[WordTiming] = []
    for i in range(n):
        o = out_words[i]
        text = "".join(
            chars[out_state_idx[o.state_offset + j]]
            for j in range(o.state_len)
        )
        stats = WordConfidenceStats(
            mean_logp=float(o.mean_logp) if o.has_mean_logp else None,
            geo_mean_prob=float(o.geo_mean_prob) if o.has_geo else None,
            quality_confidence=float(o.quality_confidence) if o.has_qc else None,
            calibrated_confidence=(
                float(o.calibrated_confidence) if o.has_cc else None
            ),
            min_logp=float(o.min_logp) if o.has_min else None,
            p10_logp=float(o.p10_logp) if o.has_p10 else None,
            mean_margin=float(o.mean_margin) if o.has_margin else None,
            coverage_frame_count=int(o.coverage_frame_count),
            boundary_confidence=(
                float(o.boundary_confidence) if o.has_bc else None
            ),
        )
        words.append(
            WordTiming(
                word=text,
                start_ms=int(o.start_ms),
                end_ms=int(o.end_ms),
                confidence=float(o.confidence) if o.has_confidence else None,
                confidence_stats=stats,
            )
        )
    return words, float(timings[2]), float(timings[0]), float(timings[1])
