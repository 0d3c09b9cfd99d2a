"""The plain reference held to the port at tiny sizes on the CPU (this
test may import both; the reference itself imports neither the port nor
JAX), and the harness's weight tree held to the port's layout."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import weights
from portbench.reference import forward, grouping, viterbi
from portbench.reference.text import tokenize
from portbench.tests.conftest import tiny_config

CONFIGS = ["wav2vec2-base-960h", "wav2vec2-conformer-rel-pos-large-960h-ft"]


def _port_cfg(cfg):
    from portbench.run import model_config

    return model_config(cfg)


@pytest.mark.parametrize("name", CONFIGS)
def test_weight_tree_has_the_ports_layout(name):
    from wav2vec2_tpu_torch.models.params import init_params

    cfg = tiny_config(name)
    ours = weights.make(cfg, 5, "cpu")
    theirs = init_params(_port_cfg(cfg), 0)

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, list):
            return [shapes(v) for v in t]
        return tuple(t.shape)

    assert shapes(ours) == shapes(theirs)
    again = weights.make(cfg, 5, "cpu")
    assert torch.equal(ours["lm_head"]["kernel"], again["lm_head"]["kernel"])


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_matches_the_ports_f32_forward(name):
    from wav2vec2_tpu_torch.models.ctc_model import log_softmax_logits, wav2vec2_forward

    cfg = tiny_config(name)
    params = weights.make(cfg, 11, "cpu")
    rng = np.random.default_rng(0)
    audio = (rng.normal(size=23_456) * 0.1).astype(np.float32)
    ref = forward.log_probs(params, audio, cfg)
    x = torch.from_numpy(forward.normalize(audio))[None]
    port = log_softmax_logits(wav2vec2_forward(params, x, _port_cfg(cfg)))[0]
    assert ref.shape == port.shape
    assert float((ref - port).abs().max()) < 1e-4


def _random_case(rng, t, v=32):
    words = ["THE", "QUICK", "BROWN", "FOX", "ALL", "BEEN"]
    text = " ".join(rng.choice(words, rng.integers(1, 5)))
    lp = torch.log_softmax(torch.from_numpy(rng.normal(size=(t, v)).astype(np.float32) * 3), -1)
    return text, lp


VOCAB = {"<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3, "|": 4,
         **{c: 5 + i for i, c in enumerate("ETAONIHSRDLUMWCFGYPBVK'XJQZ")}}


@pytest.mark.parametrize("seed", range(6))
def test_viterbi_tokens_and_grouping_match_the_ports(seed):
    from wav2vec2_tpu_torch.align import grouping as port_grouping
    from wav2vec2_tpu_torch.align.tokenization import build_token_sequence_case_aware
    from wav2vec2_tpu_torch.ops.viterbi_ref import viterbi_numpy

    rng = np.random.default_rng(seed)
    text, lp = _random_case(rng, int(rng.integers(60, 160)))
    seq = tokenize(text, VOCAB, 0, 4)
    port_seq = build_token_sequence_case_aware(text, VOCAB, 0, 4)
    assert (seq.tokens, seq.chars, seq.normalized_words) == (
        port_seq.tokens, port_seq.chars, port_seq.normalized_words)
    path = viterbi.best_path(lp, seq.tokens)
    oracle = np.array([s for s, _ in viterbi_numpy(lp.numpy(), np.array(seq.tokens))])
    assert np.array_equal(path, oracle)
    ev = grouping.frame_evidence_from_log_probs(lp.numpy(), seq.tokens, path, 0)
    ours = grouping.group_into_words(path, seq.tokens, seq.chars, seq.normalized_words, ev,
                                     0, 4, 20.0)
    port_ev = port_grouping.frame_evidence_from_log_probs(lp.numpy(), seq.tokens, path, 0)
    theirs = port_grouping.group_into_words_profiled(
        [(int(s), t) for t, s in enumerate(path)], seq.tokens, seq.chars,
        seq.normalized_words, port_ev, 0, 4, 20.0, measure=lambda _, fn: fn()).words
    assert [(w.word, w.start_ms, w.end_ms, w.confidence) for w in ours] == [
        (w.word, w.start_ms, w.end_ms, w.confidence) for w in theirs]


def test_best_path_ties_and_end_as_the_port():
    from wav2vec2_tpu_torch.ops.viterbi_ref import viterbi_numpy

    tokens = [0, 5, 0, 5, 0, 6, 0]  # a repeated token: no skip from 1 to 3
    for lp in (np.zeros((9, 8), np.float32),  # every path ties
               np.log(np.full((9, 8), 0.125, np.float32))):
        oracle = np.array([s for s, _ in viterbi_numpy(lp, np.array(tokens))])
        assert np.array_equal(viterbi.best_path(torch.from_numpy(lp), tokens), oracle)


@pytest.mark.cuda
def test_best_path_on_the_card_as_on_the_cpu(card):
    rng = np.random.default_rng(3)
    text, lp = _random_case(rng, 5 * viterbi.GRAPH_FRAMES + 37)
    tokens = tokenize(text, VOCAB, 0, 4).tokens
    assert np.array_equal(viterbi.best_path(lp.cuda(), tokens), viterbi.best_path(lp, tokens))
