"""PyTorch port vs the JAX package: the carried-over numpy host modules
(tokenization, word grouping, confidence, host evidence). They must give
IDENTICAL results (same words, frames, ms and confidence values) for the
same paths and evidence."""

import dataclasses

import numpy as np
import pytest

from wav2vec2_tpu.align import grouping as jax_grouping
from wav2vec2_tpu.align import tokenization as jax_tok
from wav2vec2_tpu.ops.viterbi_ref import viterbi_numpy
from wav2vec2_tpu_torch.align import grouping as torch_grouping
from wav2vec2_tpu_torch.align import tokenization as torch_tok
from wav2vec2_tpu_torch.config import AlignerHyperParams

VOCAB = {"<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3, "|": 4}
for _i, _c in enumerate("ETAONIHSRDLUMWCFGYPBVKXJQZ'"):
    VOCAB[_c] = 5 + _i

TRANSCRIPTS = ["the quick brown fox", "it's A dog!  under 9 stars",
               "x", "hello world again and again"]


@pytest.mark.parametrize("text", TRANSCRIPTS)
def test_tokenization_identical(text):
    got = torch_tok.build_token_sequence_case_aware(text, VOCAB, 0, 4)
    want = jax_tok.build_token_sequence_case_aware(text, VOCAB, 0, 4)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def _as_dict(words):
    return [dataclasses.asdict(w) for w in words]


@pytest.mark.parametrize("seed", range(6))
def test_grouping_identical_on_random_paths(seed):
    rng = np.random.default_rng(seed)
    seq = torch_tok.build_token_sequence_case_aware(
        TRANSCRIPTS[seed % len(TRANSCRIPTS)], VOCAB, 0, 4)
    t_len = len(seq.tokens) * 3 + int(rng.integers(0, 30))
    x = rng.normal(size=(t_len, len(VOCAB))).astype(np.float32) * 4
    lp = (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)
    states = np.asarray([s for s, _ in viterbi_numpy(lp, np.asarray(seq.tokens))], np.int32)
    ev_t = torch_grouping.frame_evidence_from_log_probs(lp, seq.tokens, states, 0)
    ev_j = jax_grouping.frame_evidence_from_log_probs(lp, seq.tokens, states, 0)
    for f in ("emit_lp", "margin", "blank_prob", "entropy"):
        np.testing.assert_array_equal(getattr(ev_t, f), getattr(ev_j, f))
    stride = 20.0
    hp = AlignerHyperParams()
    got = torch_grouping.group_into_words(
        states, seq.tokens, seq.chars, seq.normalized_words, ev_t, 0, 4, stride, hp)
    got_tuples = torch_grouping.group_into_words(
        [(int(s), t) for t, s in enumerate(states)], seq.tokens, seq.chars,
        seq.normalized_words, ev_t, 0, 4, stride, hp)
    want = jax_grouping.group_into_words(
        [(int(s), t) for t, s in enumerate(states)], seq.tokens, seq.chars,
        seq.normalized_words, ev_j, 0, 4, stride)
    assert _as_dict(got) == _as_dict(want) == _as_dict(got_tuples)
    assert len(got) == len(seq.normalized_words)


def test_grouping_profiled_and_empty_path():
    seq = torch_tok.build_token_sequence_case_aware("ab", {"a": 5, "b": 6, "|": 4}, 0, 4)
    ev = torch_grouping.FrameEvidence(
        emit_lp=np.zeros(0, np.float32), margin=np.zeros(0, np.float32),
        blank_prob=np.zeros(0))
    out = torch_grouping.group_into_words_profiled(
        [], seq.tokens, seq.chars, seq.normalized_words, ev, 0, 4, 20.0)
    assert out.words == [] and out.expand_select_ms == 0.0
