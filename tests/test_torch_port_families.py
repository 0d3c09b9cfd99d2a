"""PyTorch port vs the JAX package: the wav2vec2-encoder families.

Each family at a small size (2 layers, hidden 64, 4 heads, its own
structural knobs: data2vec's positional conv stack cut to 3 layers, the
conv adapter's 3 layers, WavLM's buckets) gets JAX random-init weights,
carried across by `params_from_jax`. Every leaf that init leaves at 1 or 0
(LayerNorm, BatchNorm and adapter norms, WavLM's gate constant, every
bias) is drawn anew from a seed first, so that a wrong transpose or a
missed affine cannot pass unseen. Same numpy audio on both sides (a padded
batch of 3), the JAX side at HIGHEST precision.

Bounds: f32 log-probs within 1e-4 of JAX's (`F32_LP_ATOL` of
tests/test_torch_port_forward.py) and of the unpadded forward on the valid
frames (bf16: tests/test_torch_port_families_bf16.py). Under
WAV2VEC2_FLASH_FORCE=1 the encoder's
attention calls the K5 wrapper once per layer (its plain version on the
CPU) and matches JAX's forced forward (the JAX kernel in interpret mode)
within 1e-4; WavLM never calls it. The presets parse to the JAX configs,
and WavLM's buckets equal JAX's for every T up to 1 600.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from wav2vec2_tpu.config import Wav2Vec2ModelConfig as JaxCfg
from wav2vec2_tpu.models import ctc_model as jax_ctc
from wav2vec2_tpu.models import encoder as jax_encoder
from wav2vec2_tpu.models import presets as jax_presets
from wav2vec2_tpu.models.params import init_params as jax_init_params
from wav2vec2_tpu_torch.config import Wav2Vec2ModelConfig as TorchCfg
from wav2vec2_tpu_torch.models import ctc_model as torch_ctc
from wav2vec2_tpu_torch.models import encoder as torch_encoder
from wav2vec2_tpu_torch.models import params as torch_params
from wav2vec2_tpu_torch.models import presets as torch_presets
from wav2vec2_tpu_torch.ops import flash_attention as fa

F32_LP_ATOL = 1e-4

SMALL = dict(
    hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
    intermediate_size=96, conv_dim=[32, 32], conv_kernel=[10, 3],
    conv_stride=[5, 2], num_conv_pos_embeddings=16,
    num_conv_pos_embedding_groups=4, pad_token_id=0, vocab_size=32,
    feat_extract_norm="group", conv_bias=False,
)
PRE_NORM = dict(do_stable_layer_norm=True, feat_extract_norm="layer", conv_bias=True)
FAMILIES = {
    "pre-norm": PRE_NORM,
    "layer-frontend": dict(feat_extract_norm="layer", conv_bias=True),
    "hubert": dict(model_type="hubert"),
    "hubert-no-proj-ln": dict(model_type="hubert", feat_proj_layer_norm=False),
    "data2vec": dict(model_type="data2vec-audio", feat_extract_norm="layer",
                     num_conv_pos_embeddings=3, conv_pos_kernel_size=19),
    "mms": dict(PRE_NORM, adapter_attn_dim=8),
    "wavlm": dict(model_type="wavlm", num_buckets=32, max_bucket_distance=100),
    "wavlm-pre-norm": dict(PRE_NORM, model_type="wavlm", num_buckets=32,
                           max_bucket_distance=100),
    "mhubert": dict(model_type="hubert", conv_pos_batch_norm=True),
    "adapter": dict(PRE_NORM, add_adapter=True, num_adapter_layers=3),
    "adapter-proj": dict(add_adapter=True, num_adapter_layers=2, output_hidden_size=48),
    "unispeech": dict(PRE_NORM, model_type="unispeech"),
    "unispeech-sat": dict(model_type="unispeech-sat"),
}
_NORMS = {"layer_norm", "final_layer_norm", "norm", "proj_layer_norm", "ffn1_layer_norm",
          "ffn2_layer_norm", "self_attn_layer_norm", "output_norm",
          "rel_embeddings_layer_norm", "depthwise_layer_norm", "residual_layer_norm",
          "ffn_layer_norm"}


def perturb(tree, seed):
    """The numpy tree with every norm affine, folded BatchNorm, WavLM gate
    constant and bias drawn from `seed` (init_params leaves them at 1 or
    0), in place."""
    rng = np.random.default_rng(seed)

    def draw(a, one):
        return ((1.0 if one else 0.0) + 0.2 * rng.standard_normal(a.shape)).astype(np.float32)

    def walk(node, parent):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, k)
            elif parent in _NORMS or parent == "batch_norm":
                node[k] = draw(v, k in ("weight", "scale"))
            elif k == "gru_rel_pos_const":
                node[k] = draw(v, True)
            elif k == "bias":
                node[k] = draw(v, False)

    walk(tree, None)
    return tree


def family_models(family, seed=0, **change):
    d = {**SMALL, **FAMILIES[family], **change}
    jcfg, tcfg = JaxCfg.from_dict(d), TorchCfg.from_dict(d)
    tree = perturb(jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(seed))),
                   seed + 1)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), torch_params.params_from_jax(tree)


_CACHE = {}


def models(family):
    if family not in _CACHE:
        _CACHE[family] = family_models(family)
    return _CACHE[family]


def batch(seed=0, n=4000):
    rng = np.random.default_rng(seed)
    lens = np.array([n, 3 * n // 4, 1234], np.int32)
    audio = rng.normal(size=(3, n)).astype(np.float32)
    for i, m in enumerate(lens):
        audio[i, m:] = 0
    return audio, lens


def jax_lp(jp, jcfg, audio, lens, flash=False, dtype=jnp.float32):
    cfg = dataclasses.replace(jcfg, use_flash_attention=flash)
    logits = jax_ctc.wav2vec2_forward(jp, jnp.asarray(audio), cfg,
                                      audio_lens=None if lens is None else jnp.asarray(lens),
                                      compute_dtype=dtype)
    return np.asarray(jax_ctc.log_softmax_logits(logits))


def torch_lp(tp, tcfg, audio, lens, flash=False, dtype=torch.float32):
    cfg = dataclasses.replace(tcfg, use_flash_attention=flash)
    logits = torch_ctc.wav2vec2_forward(
        tp, torch.from_numpy(audio), cfg,
        audio_lens=None if lens is None else torch.from_numpy(lens), compute_dtype=dtype)
    return torch_ctc.log_softmax_logits(logits).numpy()


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_f32_padded_batch_matches_jax(family):
    jcfg, tcfg, jp, tp = models(family)
    audio, lens = batch()
    want = jax_lp(jp, jcfg, audio, lens)
    got = torch_lp(tp, tcfg, audio, lens)
    assert got.shape == want.shape == (3, tcfg.conv_output_length(4000), 32)
    np.testing.assert_allclose(got, want, atol=F32_LP_ATOL, rtol=0)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_padded_batch_equals_unpadded(family):
    _, tcfg, _, tp = models(family)
    audio, lens = batch(1)
    padded = torch_lp(tp, tcfg, audio, lens)
    for i in (1, 2):
        alone = torch_lp(tp, tcfg, audio[i:i + 1, : lens[i]].copy(), None)
        t_i = tcfg.conv_output_length(int(lens[i]))
        assert alone.shape[1] == t_i
        np.testing.assert_allclose(padded[i, :t_i], alone[0], atol=F32_LP_ATOL, rtol=0)


@pytest.mark.parametrize("name", sorted(jax_presets.PRESETS))
def test_presets_parse_to_the_jax_configs(name):
    """Every preset of the JAX package, SEW, SEW-D and w2v-BERT 2.0 among
    them, builds in the port with the JAX config's field values, frame
    stride and frame counts."""
    vocab = 392 if name == "unispeech-large-phoneme" else 32
    assert set(torch_presets.PRESETS) == set(jax_presets.PRESETS)
    got, want = torch_presets.PRESETS[name](vocab), jax_presets.PRESETS[name](vocab)
    fields = [f.name for f in dataclasses.fields(got)]
    assert {n: getattr(got, n) for n in fields} == {n: getattr(want, n) for n in fields}
    lens = np.arange(0, 40_000, 97, dtype=np.int32)
    assert got.frame_stride_samples() == want.frame_stride_samples()
    assert [got.conv_output_length(int(n)) for n in lens] == \
        [want.conv_output_length(int(n)) for n in lens]
    np.testing.assert_array_equal(
        torch_ctc.frame_lengths(got, torch.from_numpy(lens)).numpy(),
        np.asarray(jax_ctc.frame_lengths(want, jnp.asarray(lens))))


def test_adapter_frames_are_160_ms():
    cfg = torch_presets.wav2vec2_large_adapter()
    assert cfg.frame_stride_samples() == 2560 and cfg.frame_stride_ms(16000) == 160.0
    assert cfg.conv_output_length(160_000) == 63


@pytest.mark.parametrize("num_buckets,max_distance", [(320, 800), (32, 100)])
def test_wavlm_buckets_match_jax_for_every_t(num_buckets, max_distance):
    """JAX's bucket table at T = 1 600 (read off an embedding whose row b
    holds b), against the port's bucket of each offset for every T from 1
    to 1 600 (each T's [T, T] table gathers from those), and the port's
    [T, T] tables at the T around the bucket edges."""
    t_max = 1600
    embed = jnp.arange(num_buckets, dtype=jnp.float32)[:, None]
    want = np.asarray(jax_encoder.wavlm_position_bias(embed, t_max, num_buckets,
                                                      max_distance))[0].astype(np.int64)
    by_offset = np.concatenate([want[::-1, 0], want[0, 1:]])  # offsets −1599 … 1599
    for t in range(1, t_max + 1):
        got = torch_encoder.wavlm_offset_buckets(t, num_buckets, max_distance).numpy()
        np.testing.assert_array_equal(got, by_offset[t_max - t: t_max + t - 1])
    for t in (1, 2, 7, 8, 9, 79, 80, 81, 100, 499, 713, 800, 801, 1600):
        got = torch_encoder.wavlm_buckets(t, num_buckets, max_distance, torch.device("cpu"))
        np.testing.assert_array_equal(got.numpy(), want[:t, :t])


@pytest.mark.parametrize("family", ["pre-norm", "layer-frontend", "mms", "wavlm",
                                    "wavlm-pre-norm", "adapter"])
def test_forced_flash_runs_the_kernel_once_per_layer(family, monkeypatch):
    """WAV2VEC2_FLASH_FORCE=1: the pre-norm and post-norm encoders call the
    K5 wrapper once per layer and match JAX's forced forward; WavLM's
    gated bias keeps attention off the kernel, as in the JAX package."""
    jcfg, tcfg, jp, tp = models(family)
    monkeypatch.setenv(fa.FORCE_ENV, "1")
    calls = []
    real = fa.flash_attention

    def counting(*a, **kw):
        calls.append(kw.get("scale"))
        return real(*a, **kw)

    monkeypatch.setattr(fa, "flash_attention", counting)
    audio, lens = batch(3)
    got = torch_lp(tp, tcfg, audio, lens, flash=True)
    if tcfg.attention_style == "wavlm":
        assert calls == []
        return
    assert calls == [1.0] * tcfg.num_hidden_layers
    np.testing.assert_allclose(got, jax_lp(jp, jcfg, audio, lens, flash=True),
                               atol=F32_LP_ATOL, rtol=0)
    calls.clear()
    np.testing.assert_allclose(got, torch_lp(tp, tcfg, audio, lens), atol=F32_LP_ATOL, rtol=0)
    assert calls == []


def test_mms_width_head_dim_80_forced_and_plain():
    """The MMS-1b geometry at 1 layer (hidden 1280, 16 heads of 80, FFN
    5120, adapters of width 16): the forced forward (K5's plain version on
    the CPU) and the plain-attention forward against JAX's forward."""
    jcfg, tcfg, jp, tp = family_models(
        "mms", seed=4, hidden_size=1280, num_attention_heads=16, intermediate_size=5120,
        num_hidden_layers=1, adapter_attn_dim=16, num_conv_pos_embedding_groups=16)
    assert tcfg.hidden_size // tcfg.num_attention_heads == 80
    audio, lens = batch(4, n=2400)
    want = jax_lp(jp, jcfg, audio, lens)
    np.testing.assert_allclose(torch_lp(tp, tcfg, audio, lens), want, atol=F32_LP_ATOL, rtol=0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(fa.FORCE_ENV, "1")
        np.testing.assert_allclose(torch_lp(tp, tcfg, audio, lens, flash=True), want,
                                   atol=F32_LP_ATOL, rtol=0)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_numpy_init_has_the_jax_tree_shapes(family):
    d = {**SMALL, **FAMILIES[family]}
    want = jax.tree.map(lambda a: tuple(a.shape),
                        jax_init_params(JaxCfg.from_dict(d), jax.random.PRNGKey(0)))
    tree = torch_params.init_params(TorchCfg.from_dict(d), seed=0)
    assert jax.tree.map(lambda a: tuple(a.shape), tree) == want
    torch_params.params_from_jax(tree)  # the converter takes every family's tree
