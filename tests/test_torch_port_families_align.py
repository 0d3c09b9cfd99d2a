"""PyTorch port vs the JAX package: the entry points on the new families.

A small model with the 7-layer conv frontend (20 ms frames) and, for the
conv adapter, 3 adapter layers (160 ms frames), JAX random-init weights
with every norm and bias moved off its init value, carried across by
`params_from_jax`:

- `BatchAligner(device="cpu")` and the JAX `BatchAligner` on the adapter
  config give the same words, their boundaries on the 160 ms grid;
- `align_longform` on 2 minutes of audio with the adapter: stitched
  log-probs within 1e-4 of the JAX forward's, the same words as the JAX
  `align_longform`, boundaries within one 160 ms frame;
- `ForcedAlignerBuilder` on HF-format model directories written by the
  port's `params_to_hf_flat_dict` under each family's own prefix
  (`hubert.`, `wavlm.`, `data2vec_audio.`, `unispeech_sat.`, and
  `wav2vec2.` with adapters), against the JAX builder on the same
  directory: the same words, boundaries within one frame.
"""

import json

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from wav2vec2_tpu import AlignmentInput as JaxInput
from wav2vec2_tpu import ForcedAlignerBuilder as JaxBuilder
from wav2vec2_tpu import Wav2Vec2Config as JaxConfig
from wav2vec2_tpu.align import longform as jax_longform
from wav2vec2_tpu.config import Wav2Vec2ModelConfig as JaxCfg
from wav2vec2_tpu.models.ctc_model import log_softmax_logits as jax_log_softmax
from wav2vec2_tpu.models.ctc_model import make_forward_fn
from wav2vec2_tpu.models.params import init_params as jax_init_params
from wav2vec2_tpu.parallel.batching import BatchAligner as JaxBatchAligner
from wav2vec2_tpu.pipeline.runtime import normalize_audio as jax_normalize_audio
from wav2vec2_tpu_torch import AlignmentInput, ForcedAlignerBuilder, Wav2Vec2Config
from wav2vec2_tpu_torch import align_longform
from wav2vec2_tpu_torch.align import longform
from wav2vec2_tpu_torch.config import Wav2Vec2ModelConfig as TorchCfg
from wav2vec2_tpu_torch.models import params as torch_params
from wav2vec2_tpu_torch.parallel.batching import BatchAligner
from wav2vec2_tpu_torch.pipeline.runtime import normalize_audio
from wav2vec2_tpu_torch.utils.checkpoint import save_safetensors

from test_torch_port_families import perturb

CONV_7 = dict(
    hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
    intermediate_size=96, conv_dim=[32] * 7, conv_kernel=[10, 3, 3, 3, 3, 2, 2],
    conv_stride=[5, 2, 2, 2, 2, 2, 2], num_conv_pos_embeddings=16,
    num_conv_pos_embedding_groups=4, pad_token_id=0, vocab_size=32,
    do_stable_layer_norm=True, feat_extract_norm="layer", conv_bias=True,
)
ADAPTER = dict(CONV_7, add_adapter=True, num_adapter_layers=3)
VOCAB = {"<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3, "|": 4}
for _i, _c in enumerate("ETAONIHSRDLUMWCFGYPBVKXJQZ"):
    VOCAB[_c] = 5 + _i
WORDS = "the quick brown fox jumps over a lazy dog".split()
CPU = torch.device("cpu")


def _models(d, seed=0):
    jcfg, tcfg = JaxCfg.from_dict(d), TorchCfg.from_dict(d)
    tree = perturb(jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(seed))),
                   seed + 1)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), tree


@pytest.fixture(scope="module")
def adapter_model():
    jcfg, tcfg, jp, tree = _models(ADAPTER)
    return jcfg, tcfg, jp, torch_params.params_from_jax(tree)


def _assert_same_words(got, want, stride_ms):
    assert got and [w.word for w in got] == [w.word for w in want]
    for a, b in zip(got, want):
        assert abs(a.start_ms - b.start_ms) <= stride_ms
        assert abs(a.end_ms - b.end_ms) <= stride_ms


def test_batch_aligner_with_the_adapter_matches_jax(adapter_model):
    jcfg, tcfg, jp, tp = adapter_model
    assert tcfg.frame_stride_ms(16000) == 160.0
    rng = np.random.default_rng(2)
    audios = [rng.normal(size=n).astype(np.float32) for n in (48_000, 40_000, 64_000, 30_000)]
    texts = ["the quick fox", "over a dog", "jumps over the lazy dog", "brown fox"]
    got = BatchAligner(tcfg, tp, VOCAB, compute_dtype="float32", device="cpu") \
        .align_utterances(audios, texts, audio_multiple=16_000, max_batch=2)
    want = JaxBatchAligner(jcfg, jp, VOCAB, compute_dtype="float32") \
        .align_utterances(audios, texts, audio_multiple=16_000, max_batch=2)
    for g, w, text in zip(got, want, texts):
        assert [x.word for x in g.words] == text.upper().split()
        _assert_same_words(g.words, w.words, 160)
        assert all(x.start_ms % 160 == 0 and x.end_ms % 160 == 0 for x in g.words)


def _jax_stitched(jcfg, jp, audio, chunk, overlap):
    normalized = jax_normalize_audio(audio)
    stride = jcfg.frame_stride_samples()
    spans = jax_longform.chunk_spans(len(normalized), chunk, overlap, stride)
    batch = np.zeros((len(spans), max(s1 - s0 for s0, s1 in spans)), np.float32)
    lens = np.array([s1 - s0 for s0, s1 in spans], np.int32)
    for i, (s0, s1) in enumerate(spans):
        batch[i, : s1 - s0] = normalized[s0:s1]
    lp = np.asarray(jax_log_softmax(make_forward_fn(jcfg)(jp, jnp.asarray(batch),
                                                          jnp.asarray(lens))))
    chunks = [lp[i, : jcfg.conv_output_length(int(n))] for i, n in enumerate(lens)]
    return jax_longform.stitch_log_probs(chunks, spans, stride,
                                         jcfg.conv_output_length(len(audio)))


def test_align_longform_with_the_adapter_matches_jax(adapter_model):
    """2 minutes in 30 s chunks with 5 s overlaps: the adapter's 2 560-
    sample frames are the chunk-alignment unit on both sides."""
    jcfg, tcfg, jp, tp = adapter_model
    audio = np.random.default_rng(3).normal(size=120 * 16_000).astype(np.float32)
    transcript = " ".join(np.random.default_rng(4).choice(WORDS, size=40))
    chunk, overlap = 30 * 16_000, 5 * 16_000
    stitched = longform.longform_log_probs(normalize_audio(audio), tp, tcfg, chunk, overlap,
                                           torch.float32, 32, CPU).numpy()
    assert stitched.shape == (tcfg.conv_output_length(len(audio)), 32)
    np.testing.assert_allclose(stitched, _jax_stitched(jcfg, jp, audio, chunk, overlap),
                               atol=1e-4, rtol=0)
    got = align_longform(audio, transcript, tp, tcfg, VOCAB, device="cpu")
    want = jax_longform.align_longform(audio, transcript, jp, jcfg, VOCAB)
    assert [w.word for w in got.words] == transcript.upper().split()
    _assert_same_words(got.words, want.words, 160)
    assert all(w.start_ms % 160 == 0 and w.end_ms % 160 == 0 for w in got.words)


@pytest.mark.parametrize("model_type,change", [
    ("hubert", {}),
    ("wavlm", {"num_buckets": 32, "max_bucket_distance": 100}),
    ("data2vec-audio", {"num_conv_pos_embeddings": 3, "do_stable_layer_norm": False,
                        "conv_bias": False}),
    ("unispeech-sat", {"feat_extract_norm": "group", "do_stable_layer_norm": False,
                       "conv_bias": False}),
    ("wav2vec2", {"adapter_attn_dim": 8}),
])
def test_builder_aligns_a_family_model_dir(tmp_path, model_type, change):
    d = {**CONV_7, **change, "model_type": model_type}
    _, tcfg, _, tree = _models(d, seed=5)
    (tmp_path / "config.json").write_text(json.dumps(d))
    (tmp_path / "vocab.json").write_text(json.dumps(VOCAB))
    flat = torch_params.params_to_hf_flat_dict(tree, tcfg, model_type=model_type)
    assert any(k.startswith(torch_params.HF_PREFIXES[model_type]) for k in flat)
    save_safetensors(tmp_path / "model.safetensors", flat)
    files = dict(model_path=str(tmp_path / "model.safetensors"),
                 config_path=str(tmp_path / "config.json"),
                 vocab_path=str(tmp_path / "vocab.json"))
    samples = np.random.default_rng(6).normal(size=40_000).astype(np.float32)
    text = "jumps over the lazy dog"
    got = ForcedAlignerBuilder(Wav2Vec2Config(**files, device="cpu")).build() \
        .align(AlignmentInput(16000, samples, text))
    want = JaxBuilder(JaxConfig(**files)).build().align(JaxInput(16000, samples, text))
    assert [w.word for w in got.words] == text.upper().split()
    _assert_same_words(got.words, want.words, 20)
