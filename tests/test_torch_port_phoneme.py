"""PyTorch port vs the JAX package: phoneme units on the CPU.

- `build_token_sequence_phoneme` and `group_into_phonemes`: identical
  outputs for the same transcripts, paths and evidence.
- `PhonemeTokenizer` / `PhonemeGrouper`: identical to JAX's.
- `BatchAligner(units="phoneme")` against JAX's at f32: the same units,
  boundaries within one frame stride (the tolerance of
  `tests/test_torch_port_pipeline.py::_assert_same_alignment`).
- The builder keeps a phoneme vocab's multi-codepoint symbols when the
  injected tokenizer asks for them (`vocab_filter`), as the JAX builder
  does; the default tokenizer keeps the single-char rule.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest

from wav2vec2_tpu.align import tokenization as jax_tok
from wav2vec2_tpu.align.grouping import frame_evidence_from_log_probs
from wav2vec2_tpu.align.grouping.phoneme import group_into_phonemes as jax_group_phonemes
from wav2vec2_tpu.config import Wav2Vec2ModelConfig as JaxCfg
from wav2vec2_tpu.models.params import init_params as jax_init_params
from wav2vec2_tpu.ops.viterbi_ref import viterbi_numpy
from wav2vec2_tpu.parallel.batching import BatchAligner as JaxBatchAligner
from wav2vec2_tpu.pipeline import defaults as jax_defaults
from wav2vec2_tpu_torch import AlignmentInput, BatchAligner, ForcedAlignerBuilder, Wav2Vec2Config
from wav2vec2_tpu_torch.align import tokenization as port_tok
from wav2vec2_tpu_torch.align.grouping.phoneme import group_into_phonemes
from wav2vec2_tpu_torch.config import Wav2Vec2ModelConfig as TorchCfg
from wav2vec2_tpu_torch.models.params import params_from_jax, params_to_hf_flat_dict
from wav2vec2_tpu_torch.pipeline.defaults import PhonemeGrouper, PhonemeTokenizer
from wav2vec2_tpu_torch.utils.checkpoint import save_safetensors

BLANK, SEP = 0, 4
VOCAB = {"<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3, "|": 4, "a": 5, "ɛ̃": 6,
         "tʃ": 7, "k": 8, "u": 9, "ʃ": 10, "ɔ̃": 11, "ə": 12, "b": 13}
CONFIG = dict(
    model_type="wav2vec2",
    hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
    intermediate_size=64, conv_dim=[16, 16], conv_kernel=[10, 3],
    conv_stride=[5, 2], num_conv_pos_embeddings=16,
    num_conv_pos_embedding_groups=4, pad_token_id=0, vocab_size=16,
    do_stable_layer_norm=False, feat_extract_norm="group", conv_bias=False,
)
TRANSCRIPTS = ["a ɛ̃ tʃ", "k u | a", "tʃ tʃ u", "| a ?? | | k |", "ʃ ɔ̃ ə b a", "xx yy"]


@pytest.mark.parametrize("text", TRANSCRIPTS)
def test_phoneme_tokenization_identical(text):
    got = port_tok.build_token_sequence_phoneme(text, VOCAB, BLANK, SEP)
    want = jax_tok.build_token_sequence_phoneme(text, VOCAB, BLANK, SEP)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert PhonemeTokenizer().tokenize(text, VOCAB, BLANK, SEP) == got
    assert PhonemeTokenizer.vocab_filter == jax_defaults.PhonemeTokenizer.vocab_filter


@pytest.mark.parametrize("seed", range(5))
def test_group_into_phonemes_identical(seed):
    rng = np.random.default_rng(seed)
    seq = port_tok.build_token_sequence_phoneme(TRANSCRIPTS[seed], VOCAB, BLANK, SEP)
    t_len = len(seq.tokens) * 2 + int(rng.integers(0, 20))
    x = rng.normal(size=(t_len, 16)).astype(np.float32) * 3
    lp = (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)
    states = np.asarray([s for s, _ in viterbi_numpy(lp, np.asarray(seq.tokens))], np.int32)
    ev = frame_evidence_from_log_probs(lp, seq.tokens, states, BLANK)
    got = group_into_phonemes(states, seq, ev, BLANK, SEP, 20.0)
    want = jax_group_phonemes(states, seq, ev, BLANK, SEP, 20.0)
    assert [dataclasses.asdict(w) for w in got] == [dataclasses.asdict(w) for w in want]
    via_grouper = PhonemeGrouper().group_words(states, seq, ev, BLANK, SEP, 20.0)
    assert [dataclasses.asdict(w) for w in via_grouper] == [dataclasses.asdict(w) for w in got]
    assert [u.word for u in got] == seq.normalized_words


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = JaxCfg.from_dict(CONFIG), TorchCfg.from_dict(CONFIG)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(5))
    return jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp))


def _assert_same_units(got, want, stride_ms):
    assert [w.word for w in got] == [w.word for w in want]
    assert got, "no units aligned"
    for g, w in zip(got, want):
        assert abs(g.start_ms - w.start_ms) <= stride_ms
        assert abs(g.end_ms - w.end_ms) <= stride_ms


def test_batch_aligner_phoneme_units_match_jax(models):
    jcfg, tcfg, jp, tp = models
    rng = np.random.default_rng(0)
    audios = [rng.normal(size=n).astype(np.float32) for n in (3000, 2200, 4100, 1500)]
    texts = ["a ɛ̃ tʃ", "k u | a", "tʃ tʃ u ʃ ɔ̃", "ə b"]
    got = BatchAligner(tcfg, tp, VOCAB, compute_dtype="float32", device="cpu",
                       units="phoneme").align_utterances(
        audios, texts, audio_multiple=1000, token_multiple=16, max_batch=2)
    want = JaxBatchAligner(jcfg, jp, VOCAB, compute_dtype="float32",
                           units="phoneme").align_utterances(
        audios, texts, audio_multiple=1000, token_multiple=16, max_batch=2)
    for g, w, t in zip(got, want, texts):
        _assert_same_units(g.words, w.words, tcfg.frame_stride_ms(16000))
        assert [u.word for u in g.words] == [s for s in t.split() if s != "|"]


def test_batch_aligner_rejects_unknown_units(models):
    _, tcfg, _, tp = models
    with pytest.raises(ValueError, match="units"):
        BatchAligner(tcfg, tp, VOCAB, device="cpu", units="syllable")


def test_builder_keeps_multi_codepoint_symbols_for_phoneme_units(models, tmp_path):
    """The builder's vocab filter follows the injected tokenizer: with
    PhonemeTokenizer it keeps "ɛ̃" and "tʃ" (a single-char filter would drop
    them, and with them every unit they carry)."""
    from wav2vec2_tpu import AlignmentInput as JaxInput
    from wav2vec2_tpu import ForcedAlignerBuilder as JaxBuilder
    from wav2vec2_tpu import Wav2Vec2Config as JaxConfig

    _, tcfg, _, tp = models
    (tmp_path / "config.json").write_text(json.dumps(CONFIG))
    (tmp_path / "vocab.json").write_text(json.dumps(VOCAB, ensure_ascii=False))
    save_safetensors(tmp_path / "model.safetensors", params_to_hf_flat_dict(tp, tcfg))
    paths = dict(model_path=str(tmp_path / "model.safetensors"),
                 config_path=str(tmp_path / "config.json"),
                 vocab_path=str(tmp_path / "vocab.json"), device="cpu")
    port = (ForcedAlignerBuilder(Wav2Vec2Config(**paths))
            .with_tokenizer(PhonemeTokenizer()).with_word_grouper(PhonemeGrouper()).build())
    assert port.vocab == VOCAB
    assert "tʃ" not in ForcedAlignerBuilder(Wav2Vec2Config(**paths)).build().vocab
    jax_aligner = (JaxBuilder(JaxConfig(**paths))
                   .with_tokenizer(jax_defaults.PhonemeTokenizer())
                   .with_word_grouper(jax_defaults.PhonemeGrouper()).build())
    audio = np.random.default_rng(2).normal(size=4000).astype(np.float32)
    transcript = "a ɛ̃ tʃ k u"
    got = port.align(AlignmentInput(16000, audio, transcript)).words
    want = jax_aligner.align(JaxInput(16000, audio, transcript)).words
    assert [u.word for u in got] == transcript.split()
    _assert_same_units(got, want, tcfg.frame_stride_ms(16000))
