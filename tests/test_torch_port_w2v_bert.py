"""PyTorch port vs the JAX package: w2v-BERT 2.0.

Small models (2 conformer blocks, hidden 64, 4 heads of 16, depthwise
kernel 7, relative_key distances [−8, 2]; the BERT adapter with 1 or 2
layers and the intermediate FFN), JAX random-init weights with every norm
affine and bias drawn off its init value, carried across by
`params_from_jax`. One family runs at layer_norm_eps 1e-2, so that a norm
at a fixed 1e-5 (the conformer's) cannot pass. Same numpy audio on both
sides, the JAX side at HIGHEST precision.

Bounds: f32 log-probs within 1e-4 of JAX's `wav2vec2_forward`
(`F32_LP_ATOL`) and of each utterance alone; bf16 within bench.py's gate
of f32; the mel constants equal to JAX's and the mel features within 1e-4
of JAX's `mel_frontend`, padded and unpadded; the relative_key term within
1e-5 of JAX's formula and of the gather; the adapter's lengths equal to
JAX's `frame_lengths` for every N of a sweep. relative_key attention never
reaches K5, with the kernel forced; the adapter's attention calls it once
per adapter layer and matches JAX's forced forward. On the 40 ms frames of
the adapter: K1's paths equal `viterbi_numpy`, `BatchAligner` gives JAX's
words and boundaries, `align_longform` stays within the long-form tests'
bounds of JAX's, and `ForcedAlignerBuilder` and `alignment_report --device
cpu` on a `wav2vec2_bert.` directory give the batch entry's words.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from wav2vec2_tpu.align import longform as jax_longform
from wav2vec2_tpu.config import Wav2Vec2ModelConfig as JaxCfg
from wav2vec2_tpu.models import ctc_model as jax_ctc
from wav2vec2_tpu.models import mel as jax_mel
from wav2vec2_tpu.models.ctc_model import log_softmax_logits as jax_log_softmax
from wav2vec2_tpu.models.ctc_model import make_forward_fn
from wav2vec2_tpu.models.params import init_params as jax_init_params
from wav2vec2_tpu.parallel.batching import BatchAligner as JaxBatchAligner
from wav2vec2_tpu.pipeline.runtime import normalize_audio as jax_normalize_audio
from wav2vec2_tpu_torch import AlignmentInput, ForcedAlignerBuilder, Wav2Vec2Config
from wav2vec2_tpu_torch import align_longform
from wav2vec2_tpu_torch.align import longform
from wav2vec2_tpu_torch.cli.alignment_report import run as port_cli
from wav2vec2_tpu_torch.config import Wav2Vec2ModelConfig as TorchCfg
from wav2vec2_tpu_torch.data.audio import read_audio_mono
from wav2vec2_tpu_torch.data.flac_encoder import write_flac
from wav2vec2_tpu_torch.data.textgrid import parse_textgrid_file
from wav2vec2_tpu_torch.errors import InvalidInputError
from wav2vec2_tpu_torch.models import ctc_model as torch_ctc
from wav2vec2_tpu_torch.models import encoder as torch_encoder
from wav2vec2_tpu_torch.models import mel as torch_mel
from wav2vec2_tpu_torch.models import params as torch_params
from wav2vec2_tpu_torch.ops import flash_attention as fa
from wav2vec2_tpu_torch.ops.viterbi_ref import viterbi_numpy
from wav2vec2_tpu_torch.parallel.batching import BatchAligner
from wav2vec2_tpu_torch.pipeline.runtime import normalize_audio
from wav2vec2_tpu_torch.utils.checkpoint import save_safetensors

from test_torch_port_families import F32_LP_ATOL, jax_lp, perturb, torch_lp

BERT = dict(
    model_type="wav2vec2-bert", hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
    intermediate_size=96, pad_token_id=0, vocab_size=32,
    position_embeddings_type="relative_key", left_max_position_embeddings=8,
    right_max_position_embeddings=2, conv_depthwise_kernel_size=7,
    add_adapter=True, adapter_kernel_size=3, adapter_stride=2, num_adapter_layers=1,
    use_intermediate_ffn_before_adapter=True,
)
BERT_FAMILIES = {
    "w2v-bert": BERT,
    "w2v-bert-eps-1e-2": dict(BERT, layer_norm_eps=1e-2),
    "w2v-bert-adapter-proj": dict(BERT, output_hidden_size=48, num_adapter_layers=2,
                                  use_intermediate_ffn_before_adapter=False),
    "w2v-bert-no-adapter": dict(BERT, add_adapter=False,
                                use_intermediate_ffn_before_adapter=False),
    "w2v-bert-no-position": dict(BERT, position_embeddings_type=None),
}
VOCAB = {"<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3, "|": 4}
for _i, _c in enumerate("ETAONIHSRDLUMWCFGYPBVKXJQZ"):
    VOCAB[_c] = 5 + _i
WORDS = "the quick brown fox jumps over a lazy dog".split()
CPU = torch.device("cpu")


def family_models(d, seed=0):
    jcfg, tcfg = JaxCfg.from_dict(d), TorchCfg.from_dict(d)
    tree = perturb(jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(seed))),
                   seed + 1)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), tree


_CACHE = {}


def models(family):
    if family not in _CACHE:
        jcfg, tcfg, jp, tree = family_models(BERT_FAMILIES[family])
        _CACHE[family] = jcfg, tcfg, jp, torch_params.params_from_jax(tree)
    return _CACHE[family]


def batch(seed=0, n=24_000):
    """A padded batch of 3 (1.5 s, 1.125 s, 0.4 s): 74, 55 and 19 stacked
    mel frames, 37, 28 and 10 after one adapter layer."""
    rng = np.random.default_rng(seed)
    lens = np.array([n, 3 * n // 4, 6400], np.int32)
    audio = rng.normal(size=(3, n)).astype(np.float32)
    for i, m in enumerate(lens):
        audio[i, m:] = 0
    return audio, lens


@pytest.mark.parametrize("family", sorted(BERT_FAMILIES))
def test_f32_padded_batch_matches_jax(family):
    jcfg, tcfg, jp, tp = models(family)
    assert (tcfg.encoder_style, tcfg.frontend_style) == ("conformer_bert", "mel")
    audio, lens = batch()
    want = jax_lp(jp, jcfg, audio, lens)
    got = torch_lp(tp, tcfg, audio, lens)
    assert got.shape == want.shape == (3, tcfg.conv_output_length(24_000), 32)
    np.testing.assert_allclose(got, want, atol=F32_LP_ATOL, rtol=0)


@pytest.mark.parametrize("family", sorted(BERT_FAMILIES))
def test_padded_batch_equals_unpadded(family):
    _, tcfg, _, tp = models(family)
    audio, lens = batch(1)
    padded = torch_lp(tp, tcfg, audio, lens)
    for i in (1, 2):
        alone = torch_lp(tp, tcfg, audio[i:i + 1, : lens[i]].copy(), None)
        t_i = tcfg.conv_output_length(int(lens[i]))
        assert alone.shape[1] == t_i
        np.testing.assert_allclose(padded[i, :t_i], alone[0], atol=F32_LP_ATOL, rtol=0)


@pytest.mark.parametrize("family", ["w2v-bert", "w2v-bert-adapter-proj"])
def test_bf16_within_gate_of_f32_and_bf16_storage_is_exact(family):
    _, tcfg, _, tp = models(family)
    audio, lens = batch(2)
    ref = torch_lp(tp, tcfg, audio, lens)
    lp = torch_lp(tp, tcfg, audio, lens, dtype=torch.bfloat16)
    valid = torch_ctc.frame_lengths(tcfg, torch.from_numpy(lens)).numpy()
    d = np.concatenate([np.abs(lp[i, :t].astype(np.float64) - ref[i, :t]).ravel()
                        for i, t in enumerate(valid)])
    assert d.mean() <= 0.05 and np.percentile(d, 99) <= 0.3, (d.mean(), np.percentile(d, 99))
    cast = torch_params.cast_compute_weights_bf16(tp)
    np.testing.assert_array_equal(torch_lp(cast, tcfg, audio, lens, dtype=torch.bfloat16), lp)


def test_mel_constants_equal_jax():
    np.testing.assert_array_equal(torch_mel.kaldi_mel_filter_bank(),
                                  jax_mel.kaldi_mel_filter_bank())
    np.testing.assert_array_equal(torch_mel._povey_window(), jax_mel._povey_window())
    for got, want in zip(torch_mel.build_mel_matrices(), jax_mel.build_mel_matrices()):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    for n in range(0, 5000, 7):
        assert torch_mel.num_mel_frames(n) == jax_mel.num_mel_frames(n)


@pytest.mark.parametrize("scale", [1.0, 0.05])
def test_mel_features_match_jax_padded_and_unpadded(scale):
    """Raw and normalized-scale waveforms (the gain cancels up to the
    2⁻²³ floor), a padded batch and each utterance alone."""
    cfg = TorchCfg.from_dict(BERT)
    rng = np.random.default_rng(3)
    lens = np.array([24_000, 16_411, 720, 5_000], np.int32)
    audio = (rng.normal(size=(4, 24_000)) * scale).astype(np.float32)
    for i, m in enumerate(lens):
        audio[i, m:] = 0
    got, got_lens = torch_mel.mel_frontend(torch.from_numpy(audio), cfg,
                                           audio_lens=torch.from_numpy(lens))
    want, want_lens = jax_mel.mel_frontend(jnp.asarray(audio), JaxCfg.from_dict(BERT),
                                           audio_lens=jnp.asarray(lens))
    assert got.dtype == torch.float32 and got.shape == want.shape == (4, 74, 160)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    for i, m in enumerate(lens):
        alone, none = torch_mel.mel_frontend(torch.from_numpy(audio[i:i + 1, :m].copy()), cfg)
        want_alone, _ = jax_mel.mel_frontend(jnp.asarray(audio[i:i + 1, :m]),
                                             JaxCfg.from_dict(BERT))
        assert none is None and alone.shape[1] == int(got_lens[i])
        np.testing.assert_allclose(alone.numpy(), np.asarray(want_alone), atol=1e-4, rtol=0)
        np.testing.assert_allclose(got[i, : alone.shape[1]].numpy(), alone[0].numpy(),
                                   atol=1e-4, rtol=0)
        # the unstacked 10 ms frames past the utterance are 0 (HF's padding)
        assert not got[i].reshape(-1, 80)[torch_mel.num_mel_frames(int(m)):].any()
    with pytest.raises(ValueError, match="too short"):
        torch_mel.mel_frontend(torch.zeros(1, 399), cfg)


@pytest.mark.parametrize("t", [1, 2, 3, 9, 17, 60])
def test_relative_key_term_matches_jax_and_the_gather(t):
    """The port's relative_key term against JAX's expression of it (its
    clamped-distance gather and einsum) and against a numpy gather over
    each (query, key) pair, within 1e-5."""
    left, right, hd = 3, 2, 8
    rng = np.random.default_rng(t)
    q = rng.normal(size=(2, 3, t, hd)).astype(np.float32)
    table = rng.normal(size=(left + right + 1, hd)).astype(np.float32)
    cfg = dataclasses.replace(TorchCfg.from_dict(BERT), left_max_position_embeddings=left,
                              right_max_position_embeddings=right)
    got = torch_encoder._relative_key_term({"distance_embedding": torch.from_numpy(table)},
                                           torch.from_numpy(q), cfg).numpy()
    dist = jnp.clip(jnp.arange(t)[None, :] - jnp.arange(t)[:, None], -left, right)
    want = np.asarray(jnp.einsum("bhld,lrd->bhlr", q, jnp.asarray(table)[dist + left]))
    oracle = np.empty((2, 3, t, t), np.float32)
    for i in range(t):
        for j in range(t):
            oracle[:, :, i, j] = q[:, :, i] @ table[min(max(j - i, -left), right) + left]
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, oracle, atol=1e-5, rtol=1e-5)


def test_adapter_lengths_match_jax_frame_lengths():
    """For every N of a sweep: the config's frame count, `frame_lengths`
    and the lengths `bert_adapter_forward` returns equal JAX's
    `frame_lengths`, with 1 and 2 adapter layers (40 and 80 ms frames)."""
    lens = np.concatenate([np.arange(0, 2000, 1), np.arange(2000, 200_000, 997)]).astype(np.int32)
    for layers in (1, 2):
        d = dict(BERT, num_adapter_layers=layers)
        tcfg, jcfg = TorchCfg.from_dict(d), JaxCfg.from_dict(d)
        want = np.asarray(jax_ctc.frame_lengths(jcfg, jnp.asarray(lens)))
        assert tcfg.frame_stride_samples() == jcfg.frame_stride_samples() == 320 * 2 ** layers
        np.testing.assert_array_equal(
            torch_ctc.frame_lengths(tcfg, torch.from_numpy(lens)).numpy(), want)
        assert [tcfg.conv_output_length(int(n)) for n in lens] == \
            [max(int(w), 0) for w in want]
        tree = torch_params.params_from_jax(torch_params.init_params(tcfg, seed=1))
        conv = torch_ctc.conv_frame_lengths(tcfg, torch.from_numpy(lens[lens >= 4000]))
        x = torch.zeros(len(conv), int(conv.max()), 64)
        _, out = torch_encoder.bert_adapter_forward(tree["adapter"], x, tcfg, frame_lens=conv)
        np.testing.assert_array_equal(out.numpy(), want[lens >= 4000])


def test_relative_key_never_reaches_k5(monkeypatch):
    """With `flash_forced` patched to True and the kernel switch on, the
    relative_key blocks never call the K5 wrapper and give the plain
    forward; the adapter's position-free attention calls it once per
    adapter layer (hd 12 after the adapter's projection to 48) and matches JAX's forced forward (its
    kernel in interpret mode)."""
    jcfg, tcfg, jp, tp = models("w2v-bert-adapter-proj")
    audio, lens = batch(4)
    plain = torch_lp(tp, tcfg, audio, lens)
    calls = []
    real = fa.flash_attention

    def counting(*a, **kw):
        calls.append(kw.get("scale"))
        return real(*a, **kw)

    monkeypatch.setattr(fa, "flash_attention", counting)
    monkeypatch.setattr(fa, "flash_forced", lambda: True)
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(2, 11, 64)).astype(np.float32))
    block = torch_encoder._layer_slice(tp["encoder"]["layers"], 0)
    forced = torch_encoder._conformer_attention(
        block["self_attn"], x, None, dataclasses.replace(tcfg, use_flash_attention=True), None)
    assert calls == []
    np.testing.assert_array_equal(
        forced.numpy(),
        torch_encoder._conformer_attention(block["self_attn"], x, None, tcfg, None).numpy())
    got = torch_lp(tp, tcfg, audio, lens, flash=True)
    hd = tcfg.output_hidden_size // tcfg.num_attention_heads  # 48 // 4
    assert calls == [hd ** -0.5] * tcfg.num_adapter_layers
    np.testing.assert_allclose(got, plain, atol=F32_LP_ATOL, rtol=0)
    monkeypatch.setenv(fa.FORCE_ENV, "1")
    np.testing.assert_allclose(got, jax_lp(jp, jcfg, audio, lens, flash=True),
                               atol=F32_LP_ATOL, rtol=0)


def test_config_refuses_position_styles_outside_the_encoder():
    with pytest.raises(InvalidInputError, match="relative_key"):
        TorchCfg.from_dict({**BERT, "model_type": "wav2vec2-conformer", "conv_dim": [16],
                            "conv_kernel": [10], "conv_stride": [5],
                            "num_conv_pos_embeddings": 16,
                            "num_conv_pos_embedding_groups": 4})
    with pytest.raises(InvalidInputError, match="conformer_bert"):
        TorchCfg.from_dict({**BERT, "position_embeddings_type": "alibi"})
    cfg = TorchCfg.from_dict(BERT)
    assert (cfg.hidden_act, cfg.num_adapter_layers, cfg.output_hidden_size) == ("swish", 1, 64)
    assert cfg.conv_dim == [] and cfg.frame_stride_ms(16000) == 40.0


# --- the entry points on the adapter's 40 ms frames ------------------------

CASES = [(48_000, "the quick brown fox"), (40_000, "jumps over the dog"),
         (30_000, "a lazy dog")]


@pytest.fixture(scope="module")
def entry_model():
    return family_models(BERT, seed=7)


def _assert_same_words(got, want, stride_ms=None):
    assert got and [w.word for w in got] == [w.word for w in want]
    for a, b in zip(got, want):
        if stride_ms is None:
            assert (a.start_ms, a.end_ms) == (b.start_ms, b.end_ms), (a, b)
        else:
            assert abs(a.start_ms - b.start_ms) <= stride_ms
            assert abs(a.end_ms - b.end_ms) <= stride_ms


def test_k1_paths_and_batch_aligner_match_jax(entry_model):
    jcfg, tcfg, jp, tree = entry_model
    tp = torch_params.params_from_jax(tree)
    assert tcfg.frame_stride_ms(16000) == 40.0
    rng = np.random.default_rng(2)
    audios = [rng.normal(size=n).astype(np.float32) for n, _ in CASES]
    texts = [t for _, t in CASES]
    aligner = BatchAligner(tcfg, tp, VOCAB, compute_dtype="float32", device="cpu")
    audio = np.zeros((len(audios), max(len(a) for a in audios)), np.float32)
    for i, a in enumerate(audios):
        audio[i, : len(a)] = normalize_audio(a)
    seqs = [aligner._tokenize(t) for t in texts]
    tokens = np.zeros((len(seqs), 128), np.int32)
    for i, s in enumerate(seqs):
        tokens[i, : len(s.tokens)] = s.tokens
    handles = aligner.submit_padded_batch(
        torch.from_numpy(audio), torch.tensor([len(a) for a in audios], dtype=torch.int32),
        torch.from_numpy(tokens), torch.tensor([len(s.tokens) for s in seqs], dtype=torch.int32),
        return_log_probs=True)
    paths, t_lens, lp = handles[0].numpy(), handles[1].numpy(), handles[-1].numpy()
    for i, s in enumerate(seqs):
        assert t_lens[i] == tcfg.conv_output_length(len(audios[i]))
        oracle = [st for st, _ in viterbi_numpy(lp[i, : t_lens[i]], np.asarray(s.tokens))]
        assert list(paths[i, : t_lens[i]]) == oracle
    got = aligner.align_utterances(audios, texts, max_batch=2)
    want = JaxBatchAligner(jcfg, jp, VOCAB, compute_dtype="float32") \
        .align_utterances(audios, texts, max_batch=2)
    for g, w, text in zip(got, want, texts):
        assert [x.word for x in g.words] == text.upper().split()
        _assert_same_words(g.words, w.words)
        assert all(x.start_ms % 40 == 0 and x.end_ms % 40 == 0 for x in g.words)


def _jax_stitched(jcfg, jp, audio, chunk, overlap):
    normalized = jax_normalize_audio(audio)
    stride = jcfg.frame_stride_samples()
    spans = jax_longform.chunk_spans(len(normalized), chunk, overlap, stride)
    batch_ = np.zeros((len(spans), max(s1 - s0 for s0, s1 in spans)), np.float32)
    lens = np.array([s1 - s0 for s0, s1 in spans], np.int32)
    for i, (s0, s1) in enumerate(spans):
        batch_[i, : s1 - s0] = normalized[s0:s1]
    lp = np.asarray(jax_log_softmax(make_forward_fn(jcfg)(jp, jnp.asarray(batch_),
                                                          jnp.asarray(lens))))
    chunks = [lp[i, : jcfg.conv_output_length(int(n))] for i, n in enumerate(lens)]
    return jax_longform.stitch_log_probs(chunks, spans, stride,
                                         jcfg.conv_output_length(len(audio)))


def test_align_longform_matches_jax(entry_model):
    """1 minute in 20 s chunks with 4 s overlaps, cut on the adapter's
    640-sample frames on both sides: stitched log-probs within 1e-4 of the
    JAX forward's, the same words as JAX's `align_longform`, boundaries
    within one 40 ms frame."""
    jcfg, tcfg, jp, tree = entry_model
    tp = torch_params.params_from_jax(tree)
    audio = np.random.default_rng(3).normal(size=60 * 16_000).astype(np.float32)
    transcript = " ".join(np.random.default_rng(4).choice(WORDS, size=25))
    chunk, overlap = 20 * 16_000, 4 * 16_000
    stitched = longform.longform_log_probs(normalize_audio(audio), tp, tcfg, chunk, overlap,
                                           torch.float32, 32, CPU).numpy()
    assert stitched.shape == (tcfg.conv_output_length(len(audio)), 32)
    np.testing.assert_allclose(stitched, _jax_stitched(jcfg, jp, audio, chunk, overlap),
                               atol=1e-4, rtol=0)
    got = align_longform(audio, transcript, tp, tcfg, VOCAB, chunk_sec=20.0, overlap_sec=4.0,
                         device="cpu")
    want = jax_longform.align_longform(audio, transcript, jp, jcfg, VOCAB, chunk_sec=20.0,
                                       overlap_sec=4.0)
    assert [w.word for w in got.words] == transcript.upper().split()
    _assert_same_words(got.words, want.words, 40)
    assert all(w.start_ms % 40 == 0 and w.end_ms % 40 == 0 for w in got.words)


def test_builder_and_cli_on_a_model_dir_match_the_batch_entry(entry_model, tmp_path):
    """A `wav2vec2_bert.` HF-format directory through `ForcedAlignerBuilder`
    and through `alignment_report --device cpu` (textgrid, f32): the batch
    entry's words on the same samples, equal boundaries."""
    _, tcfg, _, tree = entry_model
    model_dir = tmp_path / "model"
    model_dir.mkdir()
    (model_dir / "config.json").write_text(json.dumps(BERT))
    (model_dir / "vocab.json").write_text(json.dumps(VOCAB))
    flat = torch_params.params_to_hf_flat_dict(tree, tcfg)
    assert all(k.startswith(("wav2vec2_bert.", "lm_head.")) for k in flat)
    save_safetensors(model_dir / "model.safetensors", flat)
    base = tmp_path / "data" / "LibriSpeech" / "test-clean" / "1" / "2"
    base.mkdir(parents=True)
    rng = np.random.default_rng(5)
    lines = []
    for i, (n, text) in enumerate(CASES):
        write_flac(base / f"1-2-{i:04d}.flac",
                   np.clip(rng.normal(size=n) * 3000, -32768, 32767).astype(np.int64), 16000)
        lines.append(f"1-2-{i:04d} {text.upper()}")
    (base / "1-2.trans.txt").write_text("\n".join(lines))
    samples = [read_audio_mono(base / f"1-2-{i:04d}.flac")[0] for i in range(len(CASES))]
    texts = [t for _, t in CASES]
    batch_entry = BatchAligner(tcfg, torch_params.params_from_jax(tree), VOCAB,
                               compute_dtype="float32", device="cpu") \
        .align_utterances(samples, texts)
    files = dict(model_path=str(model_dir / "model.safetensors"),
                 config_path=str(model_dir / "config.json"),
                 vocab_path=str(model_dir / "vocab.json"))
    single = ForcedAlignerBuilder(Wav2Vec2Config(**files, device="cpu")).build()
    assert port_cli(["--model-dir", str(model_dir), "--dataset-root", str(tmp_path / "data"),
                     "--device", "cpu", "--compute-dtype", "float32",
                     "--output-format", "textgrid"]) == 0
    for i, (s, text, want) in enumerate(zip(samples, texts, batch_entry)):
        assert [w.word for w in want.words] == text.upper().split()
        _assert_same_words(single.align(AlignmentInput(16000, s, text)).words, want.words)
        tier = parse_textgrid_file(base / f"1-2-{i:04d}.TextGrid").tier("words")
        words = [iv for iv in tier.intervals if iv.text.strip()]
        assert [iv.text for iv in words] == [w.word for w in want.words]
        for iv, w in zip(words, want.words):
            assert (round(iv.xmin * 1000), round(iv.xmax * 1000)) == (w.start_ms, w.end_ms)
