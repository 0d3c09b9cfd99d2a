"""PyTorch port: the golden alignment fixtures, replayed through the port.

Every case of `tests/golden/alignment_cases.json` and
`tests/golden/phoneme_cases.json` is regenerated from its seed
(`generate_golden.synth_log_probs`) and replayed through the port's host
path — tokenization → `viterbi_numpy` → evidence → grouping — with the
Python grouping path, then again with the native grouping engine. Both must
equal the committed snapshot exactly (words, integer ms boundaries,
confidences and stats rounded to 8 decimals), as
`tests/test_golden_alignment.py` requires of the JAX package.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

from wav2vec2_tpu_torch.align import grouping, tokenization
from wav2vec2_tpu_torch.align.grouping import frame_evidence_from_log_probs, group_into_words
from wav2vec2_tpu_torch.align.grouping.phoneme import group_into_phonemes
from wav2vec2_tpu_torch.config import AlignerHyperParams
from wav2vec2_tpu_torch.ops import viterbi_ref

GOLDEN_DIR = Path(__file__).parent / "golden"
sys.path.insert(0, str(GOLDEN_DIR))
from generate_golden import (  # noqa: E402
    BLANK_ID,
    CASE_EXTRAS,
    PHONEME_VOCAB,
    SEP_ID,
    STRIDE_MS,
    VOCAB,
    synth_log_probs,
)

WORD_SNAPSHOT = json.loads((GOLDEN_DIR / "alignment_cases.json").read_text())
PHONEME_SNAPSHOT = json.loads((GOLDEN_DIR / "phoneme_cases.json").read_text())
KNOBS = ("t_len", "seed", "noise", "signal", "smear")


def _round(x, nd=8):
    return None if x is None else round(float(x), nd)


def _word_row(w):
    s = w.confidence_stats
    return {
        "word": w.word, "start_ms": w.start_ms, "end_ms": w.end_ms,
        "confidence": _round(w.confidence),
        "stats": {
            "mean_logp": _round(s.mean_logp),
            "geo_mean_prob": _round(s.geo_mean_prob),
            "quality_confidence": _round(s.quality_confidence),
            "calibrated_confidence": _round(s.calibrated_confidence),
            "min_logp": _round(s.min_logp),
            "p10_logp": _round(s.p10_logp),
            "mean_margin": _round(s.mean_margin),
            "coverage_frame_count": s.coverage_frame_count,
            "boundary_confidence": _round(s.boundary_confidence),
        },
    }


def _replay(case, vocab, tokenize, extras=None):
    seq = tokenize(case["transcript"], vocab, BLANK_ID, SEP_ID)
    lp = synth_log_probs(seq.tokens, *(case[k] for k in KNOBS), **(extras or {}))
    path = viterbi_ref.viterbi_numpy(lp, np.asarray(seq.tokens))
    states = [s for s, _ in path]
    return seq, path, states, frame_evidence_from_log_probs(lp, seq.tokens, states, BLANK_ID)


def test_snapshots_cover_every_case():
    assert WORD_SNAPSHOT["format"] == PHONEME_SNAPSHOT["format"] == 1
    assert WORD_SNAPSHOT["vocab"] == VOCAB and PHONEME_SNAPSHOT["vocab"] == PHONEME_VOCAB
    assert WORD_SNAPSHOT["stride_ms"] == PHONEME_SNAPSHOT["stride_ms"] == STRIDE_MS
    assert len(WORD_SNAPSHOT["cases"]) > 20 and len(PHONEME_SNAPSHOT["cases"]) >= 6


@pytest.mark.parametrize("engine", ["off", "require"])
@pytest.mark.parametrize("case", WORD_SNAPSHOT["cases"], ids=lambda c: c["id"])
def test_golden_words_exact(case, engine, monkeypatch):
    monkeypatch.setattr(grouping, "NATIVE_GROUPING", engine)
    seq, path, _, ev = _replay(case, VOCAB, tokenization.build_token_sequence_case_aware,
                               CASE_EXTRAS.get(case["id"]))
    words = group_into_words(path, seq.tokens, seq.chars, seq.normalized_words, ev,
                             BLANK_ID, SEP_ID, STRIDE_MS, AlignerHyperParams())
    assert [_word_row(w) for w in words] == case["words"]


@pytest.mark.parametrize("case", PHONEME_SNAPSHOT["cases"], ids=lambda c: c["id"])
def test_golden_phoneme_units_exact(case):
    seq, _, states, ev = _replay(case, PHONEME_VOCAB,
                                 tokenization.build_token_sequence_phoneme)
    units = group_into_phonemes(np.asarray(states), seq, ev, BLANK_ID, SEP_ID, STRIDE_MS)
    assert [{"word": u.word, "start_ms": u.start_ms, "end_ms": u.end_ms,
             "confidence": _round(u.confidence)} for u in units] == case["units"]
