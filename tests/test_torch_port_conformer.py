"""PyTorch port vs the JAX package: the wav2vec2-conformer family.

A tiny conformer (2 blocks, hidden 64, 2 heads of 32, depthwise kernel 7,
layer-norm frontend, swish) with JAX random-init weights carried across by
`params_from_jax`; the Transformer-XL biases `pos_bias_u`/`pos_bias_v` and
the folded BatchNorm are given random non-zero values on both sides, so a
wrong bias or BatchNorm path cannot pass unseen. Same numpy audio on both
sides; the JAX flash path runs its Pallas kernel in interpret mode.

Bounds: f32 logits within 1e-4 of the JAX forward, relative to the largest
logit (sums in another order through 2 blocks), for each position style
and for the relative style with the kernel switch on (the plain K5 against
the JAX interpret kernel); the switch on against off within 1e-3 (the
kernel's table is an f64 sin of (i − k)·w, the factorized path's an f32 sin
of i·w and k·w: `tests/test_flash_attention.py`'s bound); the layer-norm
frontend within 1e-5.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from wav2vec2_tpu import AlignmentInput as JaxInput
from wav2vec2_tpu import ForcedAlignerBuilder as JaxBuilder
from wav2vec2_tpu import Wav2Vec2Config as JaxConfig
from wav2vec2_tpu.config import Wav2Vec2ModelConfig as JaxCfg
from wav2vec2_tpu.models import ctc_model as jax_ctc
from wav2vec2_tpu.models import feature_extractor as jax_fe
from wav2vec2_tpu.models import layers as jax_layers
from wav2vec2_tpu.models.params import init_params as jax_init_params
from wav2vec2_tpu.models.params import params_from_flat_dict as jax_params_from_flat_dict
from wav2vec2_tpu.parallel.batching import BatchAligner as JaxBatchAligner
from wav2vec2_tpu_torch import AlignmentInput, ForcedAlignerBuilder, Wav2Vec2Config
from wav2vec2_tpu_torch.config import Wav2Vec2ModelConfig as TorchCfg
from wav2vec2_tpu_torch.errors import InvalidInputError, RuntimeBackendError
from wav2vec2_tpu_torch.models import ctc_model as torch_ctc
from wav2vec2_tpu_torch.models import feature_extractor as torch_fe
from wav2vec2_tpu_torch.models import layers as torch_layers
from wav2vec2_tpu_torch.models import params as torch_params
from wav2vec2_tpu_torch.ops import flash_attention as fa
from wav2vec2_tpu_torch.parallel.batching import BatchAligner
from wav2vec2_tpu_torch.utils.checkpoint import save_safetensors

F32_REL = 1e-4
FLAG_REL = 1e-3

CONFIG = dict(
    model_type="wav2vec2-conformer",
    hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
    intermediate_size=96, conv_dim=[16, 16], conv_kernel=[10, 3],
    conv_stride=[5, 2], num_conv_pos_embeddings=16,
    num_conv_pos_embedding_groups=4, pad_token_id=0, vocab_size=32,
    feat_extract_norm="layer", conv_bias=True,
    position_embeddings_type="relative", hidden_act="swish",
    conv_depthwise_kernel_size=7,
)
VOCAB = {"<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3, "|": 4}
for _i, _c in enumerate("ETAONIHSRDLUMWCFGYPBVKXJQZ"):
    VOCAB[_c] = 5 + _i


def _randomize_biases(tree, seed):
    """Non-zero pos_bias_u/v and a non-identity BatchNorm affine, in place."""
    rng = np.random.default_rng(seed)
    layers = tree["encoder"]["layers"]
    for k in ("pos_bias_u", "pos_bias_v"):
        if k in layers["self_attn"]:
            layers["self_attn"][k] = rng.normal(size=layers["self_attn"][k].shape).astype(
                np.float32)
    bn = layers["conv_module"]["batch_norm"]
    bn["scale"] = (1.0 + 0.3 * rng.normal(size=bn["scale"].shape)).astype(np.float32)
    bn["shift"] = (0.3 * rng.normal(size=bn["shift"].shape)).astype(np.float32)
    return tree


def _models(style="relative", seed=0):
    d = {**CONFIG, "position_embeddings_type": style}
    jcfg, tcfg = JaxCfg.from_dict(d), TorchCfg.from_dict(d)
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(seed)))
    tree = _randomize_biases(tree, seed + 1)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), torch_params.params_from_jax(tree)


@pytest.fixture(scope="module")
def models():
    return _models()


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    audio = rng.normal(size=(3, 4000)).astype(np.float32)
    lens = np.array([4000, 3000, 1234], np.int32)
    for i, n in enumerate(lens):
        audio[i, n:] = 0
    return audio, lens


def _jax_logits(jp, jcfg, audio, lens, flag=False, dtype=jnp.float32):
    cfg = dataclasses.replace(jcfg, use_flash_attention=flag)
    return np.asarray(jax_ctc.wav2vec2_forward(jp, jnp.asarray(audio), cfg,
                                               audio_lens=jnp.asarray(lens),
                                               compute_dtype=dtype))


def _torch_logits(tp, tcfg, audio, lens, flag=False, dtype=torch.float32):
    cfg = dataclasses.replace(tcfg, use_flash_attention=flag)
    return torch_ctc.wav2vec2_forward(tp, torch.from_numpy(audio), cfg,
                                      audio_lens=torch.from_numpy(lens),
                                      compute_dtype=dtype).numpy()


def _rel_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("style,flag", [
    ("relative", False), ("relative", True), ("rotary", False), ("none", False),
])
def test_conformer_f32_forward_matches_jax(style, flag):
    jcfg, tcfg, jp, tp = _models(style)
    audio, lens = _batch()
    want = _jax_logits(jp, jcfg, audio, lens, flag)
    got = _torch_logits(tp, tcfg, audio, lens, flag)
    assert got.shape == want.shape == (3, tcfg.conv_output_length(4000), 32)
    assert _rel_err(got, want) < F32_REL


def test_flag_on_against_flag_off(models):
    _, tcfg, _, tp = models
    audio, lens = _batch(1)
    on = _torch_logits(tp, tcfg, audio, lens, flag=True)
    off = _torch_logits(tp, tcfg, audio, lens, flag=False)
    assert _rel_err(on, off) < FLAG_REL


def test_flag_on_runs_the_kernel_wrapper_once_per_layer(models, monkeypatch):
    _, tcfg, _, tp = models
    calls = []
    real = fa.flash_attention

    def counting(*a, **kw):
        calls.append(kw.get("rel_r") is not None)
        return real(*a, **kw)

    monkeypatch.setattr(fa, "flash_attention", counting)
    audio, lens = _batch(2)
    _torch_logits(tp, tcfg, audio, lens, flag=True)
    assert calls == [True] * tcfg.num_hidden_layers
    calls.clear()
    _torch_logits(tp, tcfg, audio, lens, flag=False)
    assert calls == []


@pytest.mark.parametrize("flag", [False, True])
def test_padded_batch_equals_unpadded(models, flag):
    _, tcfg, _, tp = models
    audio, lens = _batch(3)
    padded = _torch_logits(tp, tcfg, audio, lens, flag)
    alone = _torch_logits(tp, tcfg, audio[2:, : lens[2]].copy(), lens[2:], flag)
    t2 = tcfg.conv_output_length(int(lens[2]))
    assert _rel_err(padded[2, :t2], alone[0]) < F32_REL


def test_bf16_forward_within_gate_of_f32(models):
    _, tcfg, _, tp = models
    audio, lens = _batch(4)
    t = tcfg.conv_output_length(1234)
    ref = torch.log_softmax(torch.from_numpy(_torch_logits(tp, tcfg, audio, lens)), -1)
    for flag in (False, True):
        lp = torch.log_softmax(torch.from_numpy(
            _torch_logits(tp, tcfg, audio, lens, flag, torch.bfloat16)), -1)
        d = (lp - ref)[:, :t].abs().double().numpy()
        assert d.mean() <= 0.05 and np.percentile(d, 99) <= 0.3


def test_layer_norm_frontend_matches_jax(models):
    jcfg, tcfg, jp, tp = models
    audio, lens = _batch(5)
    want = np.asarray(jax_fe.feature_extractor_forward(
        jp["feature_extractor"], jnp.asarray(audio), jcfg, audio_lens=jnp.asarray(lens)))
    got = torch_fe.feature_extractor_forward(
        tp["feature_extractor"], torch.from_numpy(audio), tcfg,
        audio_lens=torch.from_numpy(lens)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_channels_is_the_transposed_layer_norm(dtype):
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(2, 16, 50)).astype(np.float32) * 3 + 1).to(dtype)
    w = torch.from_numpy(rng.normal(size=16).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=16).astype(np.float32))
    got = torch_layers.layer_norm_channels(x, w, b, 1e-5)
    want = torch_layers.layer_norm(x.transpose(1, 2), w, b, 1e-5).transpose(1, 2)
    assert got.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("name", ["swish", "silu", "gelu", "relu"])
@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_act_fn_matches_jax(name, dtype):
    x = np.random.default_rng(7).normal(size=(4, 33)).astype(np.float32) * 4
    want = np.asarray(jax_layers.act_fn(name)(jnp.asarray(x, dtype)).astype(jnp.float32))
    tdtype = torch.float32 if dtype == np.float32 else torch.bfloat16
    got = torch_layers.act_fn(name)(torch.from_numpy(x).to(tdtype)).float().numpy()
    tol = 1e-6 if dtype == np.float32 else 1e-2
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    with pytest.raises(NotImplementedError):
        torch_layers.act_fn("tanh")


def test_config_parses_the_conformer_fields():
    cfg = TorchCfg.from_dict({**CONFIG, "rotary_embedding_base": 500,
                              "max_source_positions": 3000})
    assert cfg.encoder_style == "conformer"
    assert (cfg.position_embeddings_type, cfg.hidden_act) == ("relative", "swish")
    assert (cfg.conv_depthwise_kernel_size, cfg.rotary_embedding_base,
            cfg.max_source_positions) == (7, 500, 3000)
    assert cfg.use_flash_attention is False
    assert TorchCfg.from_dict({**CONFIG, "position_embeddings_type": None}) \
        .position_embeddings_type == "none"
    assert TorchCfg.from_dict({**CONFIG, "feat_extract_norm": "group"}).feat_extract_norm == "group"
    assert TorchCfg.from_dict(CONFIG).frame_stride_ms(16000) == \
        JaxCfg.from_dict(CONFIG).frame_stride_ms(16000)


@pytest.mark.parametrize("change", [
    {"model_type": "wav2vec2-bert"}, {"model_type": "sew"}, {"model_type": "sew-d"},
    {"model_type": "wavlm"}, {"model_type": "hubert"}, {"model_type": "data2vec-audio"},
    {"do_stable_layer_norm": True}, {"add_adapter": True},
    {"position_embeddings_type": "relative_key"},
    {"model_type": "wav2vec2", "feat_extract_norm": "layer"},
])
def test_config_refuses_the_unported_families(change):
    """The relative_key style is refused by the conformer encoder (only
    w2v-BERT's runs it); every other family, w2v-BERT, SEW and SEW-D among
    them (refused before the port ran them), parses to the JAX package's
    field values."""
    d = {**CONFIG, **change}
    if change.get("position_embeddings_type") == "relative_key":
        with pytest.raises(InvalidInputError):
            TorchCfg.from_dict(d)
        return
    got, want = TorchCfg.from_dict(d), JaxCfg.from_dict(d)
    fields = [f.name for f in dataclasses.fields(got)]
    assert {n: getattr(got, n) for n in fields} == {n: getattr(want, n) for n in fields}


def test_numpy_init_has_the_jax_tree_shapes(models):
    jcfg, tcfg, jp, _ = models
    for style in ("relative", "rotary"):
        d = {**CONFIG, "position_embeddings_type": style}
        want = jax.tree.map(lambda a: tuple(a.shape),
                            jax_init_params(JaxCfg.from_dict(d), jax.random.PRNGKey(0)))
        got = jax.tree.map(lambda a: tuple(a.shape),
                           torch_params.init_params(TorchCfg.from_dict(d), seed=0))
        assert got == want


def test_converter_refuses_other_conformer_layouts(models):
    _, _, jp, _ = models
    tree = jax.tree.map(np.asarray, jp)
    bert = jax.tree.map(lambda a: a, tree)
    bert["encoder"]["layers"]["conv_module"]["depthwise_layer_norm"] = \
        bert["encoder"]["layers"]["conv_module"]["layer_norm"]
    with pytest.raises(RuntimeBackendError):
        torch_params.params_from_jax(bert)
    tree = jax.tree.map(np.asarray, jp)
    del tree["encoder"]["layers"]["self_attn"]["pos_bias_v"]
    with pytest.raises(RuntimeBackendError):
        torch_params.params_from_jax(tree)


def test_bf16_storage_keeps_norms_in_f32_and_is_exact(models):
    _, tcfg, _, tp = models
    cast = torch_params.cast_compute_weights_bf16(tp)
    layers = cast["encoder"]["layers"]
    for k in ("ffn1_layer_norm", "self_attn_layer_norm", "ffn2_layer_norm",
              "final_layer_norm"):
        assert layers[k]["weight"].dtype == torch.float32
    assert layers["conv_module"]["layer_norm"]["weight"].dtype == torch.float32
    assert layers["conv_module"]["batch_norm"]["scale"].dtype == torch.float32
    assert cast["feature_extractor"]["conv_layers"][1]["layer_norm"]["weight"].dtype \
        == torch.float32
    assert layers["self_attn"]["linear_q"]["kernel"].dtype == torch.bfloat16
    audio, lens = _batch(8)
    for flag in (False, True):
        np.testing.assert_array_equal(
            _torch_logits(cast, tcfg, audio, lens, flag, torch.bfloat16),
            _torch_logits(tp, tcfg, audio, lens, flag, torch.bfloat16))


def test_hf_names_round_trip_through_both_loaders(models):
    """Port params → HF names (`wav2vec2_conformer.` prefix, [out, in, 1]
    pointwise convs, BatchNorm with mean 0 / var 1) → the port's and the
    JAX package's loaders give the port's forward back."""
    jcfg, tcfg, _, tp = models
    flat = torch_params.params_to_hf_flat_dict(tp, tcfg)
    assert "wav2vec2_conformer.encoder.layers.1.conv_module.batch_norm.running_var" in flat
    assert flat["wav2vec2_conformer.encoder.layers.0.conv_module.pointwise_conv1.weight"] \
        .shape == (128, 64, 1)
    assert not any("pos_conv_embed" in k for k in flat)
    tp2 = torch_params.params_from_flat_dict(flat, tcfg)
    jp2 = jax_params_from_flat_dict(flat, jcfg)
    bn = tp["encoder"]["layers"]["conv_module"]["batch_norm"]
    bn2 = tp2["encoder"]["layers"]["conv_module"]["batch_norm"]
    torch.testing.assert_close(bn2["scale"], bn["scale"], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(bn2["shift"], bn["shift"], rtol=0, atol=0)
    audio, lens = _batch(9)
    ref = _torch_logits(tp, tcfg, audio, lens)
    assert _rel_err(_torch_logits(tp2, tcfg, audio, lens), ref) < F32_REL
    assert _rel_err(_jax_logits(jp2, jcfg, audio, lens), ref) < F32_REL
    with pytest.raises(RuntimeBackendError):
        torch_params.params_from_flat_dict(
            {k: v for k, v in flat.items() if "running_mean" not in k}, tcfg)


def test_loader_folds_batch_norm_stats_as_the_jax_loader(models):
    jcfg, tcfg, _, tp = models
    flat = torch_params.params_to_hf_flat_dict(tp, tcfg)
    rng = np.random.default_rng(10)
    for name in list(flat):
        if name.endswith("running_mean"):
            flat[name] = rng.normal(size=flat[name].shape).astype(np.float32)
        elif name.endswith("running_var"):
            flat[name] = rng.uniform(0.5, 2.0, size=flat[name].shape).astype(np.float32)
    got = torch_params.params_from_flat_dict(flat, tcfg)["encoder"]["layers"]
    want = jax_params_from_flat_dict(flat, jcfg)["encoder"]["layers"]
    for k in ("scale", "shift"):
        np.testing.assert_allclose(got["conv_module"]["batch_norm"][k].numpy(),
                                   np.asarray(want["conv_module"]["batch_norm"][k]),
                                   rtol=1e-6, atol=1e-6)


def test_batch_aligner_flag_rule(models):
    _, tcfg, _, tp = models
    assert BatchAligner(tcfg, tp, VOCAB, "float32", device="cpu").cfg.use_flash_attention \
        is False
    on = BatchAligner(tcfg, tp, VOCAB, "float32", device="cpu", use_flash_attention=True)
    assert on.cfg.use_flash_attention is True and tcfg.use_flash_attention is False
    arrived_on = dataclasses.replace(tcfg, use_flash_attention=True)
    off = BatchAligner(arrived_on, tp, VOCAB, "float32", device="cpu",
                       use_flash_attention=False)
    assert off.cfg.use_flash_attention is False
    auto = BatchAligner(arrived_on, tp, VOCAB, "float32", device="cpu")
    assert auto.cfg.use_flash_attention is False  # auto: on only on a CUDA device


def test_batch_aligner_matches_jax_with_the_kernel_switch_on(models):
    jcfg, tcfg, jp, tp = models
    rng = np.random.default_rng(11)
    audios = [rng.normal(size=n).astype(np.float32) for n in (3000, 2100, 4000, 900)]
    texts = ["the quick brown fox", "jumps over", "the lazy dog again and", "hi"]
    got = BatchAligner(tcfg, tp, VOCAB, compute_dtype="float32", device="cpu",
                       use_flash_attention=True) \
        .align_utterances(audios, texts, audio_multiple=1000, max_batch=2)
    want = JaxBatchAligner(jcfg, jp, VOCAB, compute_dtype="float32",
                           use_flash_attention=True) \
        .align_utterances(audios, texts, audio_multiple=1000, max_batch=2)
    stride = tcfg.frame_stride_ms(16000)
    for g, w in zip(got, want):
        assert [x.word for x in g.words] == [x.word for x in w.words]
        assert g.words, "no words aligned"
        for a, b in zip(g.words, w.words):
            assert abs(a.start_ms - b.start_ms) <= stride
            assert abs(a.end_ms - b.end_ms) <= stride


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory, models):
    _, tcfg, _, tp = models
    d = tmp_path_factory.mktemp("torch_port_conformer")
    (d / "config.json").write_text(json.dumps(CONFIG))
    (d / "vocab.json").write_text(json.dumps(VOCAB))
    save_safetensors(d / "model.safetensors", torch_params.params_to_hf_flat_dict(tp, tcfg))
    return d


def test_builder_aligns_a_conformer_model_dir_without_the_kernel(model_dir, monkeypatch):
    """A `wav2vec2-conformer` model directory loads and aligns through
    `ForcedAlignerBuilder` on the factorized path (no K5), as in JAX."""
    def refuse(*a, **kw):
        raise AssertionError("the single-utterance path must not reach K5")

    monkeypatch.setattr(fa, "flash_attention", refuse)
    rng = np.random.default_rng(12)
    samples = rng.normal(size=6000).astype(np.float32)
    text = "over the lazy dog"
    files = dict(model_path=str(model_dir / "model.safetensors"),
                 config_path=str(model_dir / "config.json"),
                 vocab_path=str(model_dir / "vocab.json"))
    got = ForcedAlignerBuilder(Wav2Vec2Config(**files, device="cpu")).build() \
        .align(AlignmentInput(16000, samples, text))
    want = JaxBuilder(JaxConfig(**files)).build().align(JaxInput(16000, samples, text))
    assert [w.word for w in got.words] == [w.word for w in want.words] == text.upper().split()
    for a, b in zip(got.words, want.words):
        assert abs(a.start_ms - b.start_ms) <= 20 and abs(a.end_ms - b.end_ms) <= 20
