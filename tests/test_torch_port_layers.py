"""PyTorch port vs the JAX package: the model's building blocks.

Same numpy inputs (from a seed) through `wav2vec2_tpu.models.*` (JAX, on
the CPU) and `wav2vec2_tpu_torch.models.*`. Tolerances: 1e-5 absolute at
f32 (float32 rounding of reductions taken in another order); at bf16 one
bf16 ulp relative (2**-8) plus 1e-6, since both sides evaluate the same
f32 expression and round it once to bf16, and the f32 exp/erf of the two
libraries may differ in the last bits.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from wav2vec2_tpu.config import Wav2Vec2ModelConfig as JaxCfg
from wav2vec2_tpu.models import encoder as jax_encoder
from wav2vec2_tpu.models import feature_extractor as jax_fe
from wav2vec2_tpu.models import layers as jax_layers
from wav2vec2_tpu.models.params import init_params as jax_init_params
from wav2vec2_tpu_torch.config import Wav2Vec2ModelConfig as TorchCfg
from wav2vec2_tpu_torch.models import encoder as torch_encoder
from wav2vec2_tpu_torch.models import feature_extractor as torch_fe
from wav2vec2_tpu_torch.models import layers as torch_layers
from wav2vec2_tpu_torch.models.params import params_from_jax

F32_ATOL = 1e-5
BF16_RTOL = 2.0 ** -8

CONFIG = dict(
    hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
    intermediate_size=64, conv_dim=[16, 16], conv_kernel=[10, 3],
    conv_stride=[5, 2], num_conv_pos_embeddings=16,
    num_conv_pos_embedding_groups=4, pad_token_id=0, vocab_size=32,
    do_stable_layer_norm=False, feat_extract_norm="group", conv_bias=False,
)


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = JaxCfg.from_dict(CONFIG), TorchCfg.from_dict(CONFIG)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    return jcfg, tcfg, jp, tp


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("seed", range(3))
def test_layer_norm_f32(seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(2, 7, 24)) * 3 + 1).astype(np.float32)
    w = rng.normal(size=24).astype(np.float32)
    b = rng.normal(size=24).astype(np.float32)
    want = jax_layers.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-5)
    got = torch_layers.layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                                  torch.from_numpy(b), 1e-5)
    np.testing.assert_allclose(_np(got), _np(want), atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_group_norm_1d(masked):
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(3, 8, 40)) * 2 + 0.5).astype(np.float32)
    w = rng.normal(size=8).astype(np.float32)
    b = rng.normal(size=8).astype(np.float32)
    mask = np.arange(40)[None, :] < np.array([40, 25, 3])[:, None]
    want = jax_layers.group_norm_1d(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 8, 1e-5,
        time_mask=jnp.asarray(mask) if masked else None,
    )
    got = torch_layers.group_norm_1d(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), 8, 1e-5,
        time_mask=torch.from_numpy(mask) if masked else None,
    )
    np.testing.assert_allclose(_np(got), _np(want), atol=F32_ATOL, rtol=0)
    if masked:  # padded frames are zeroed
        assert (_np(got)[1, :, 25:] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu(dtype):
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(4, 257)) * 4).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want = _np(jax_layers.gelu(jnp.asarray(x).astype(jdt)))
    got_t = torch_layers.gelu(torch.from_numpy(x).to(tdt))
    assert got_t.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(_np(got_t), want, atol=F32_ATOL, rtol=0)
    else:
        np.testing.assert_allclose(_np(got_t), want, atol=1e-6, rtol=BF16_RTOL)


def test_linear_and_fold_weight_norm():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 12)).astype(np.float32)
    k = rng.normal(size=(12, 6)).astype(np.float32)
    b = rng.normal(size=6).astype(np.float32)
    want = jax_layers.linear(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b),
                             precision="highest")
    got = torch_layers.linear(torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(b))
    np.testing.assert_allclose(_np(got), _np(want), atol=F32_ATOL, rtol=0)

    wv = rng.normal(size=(6, 3, 5)).astype(np.float32)
    for wg in (rng.random((1, 1, 5)).astype(np.float32),
               rng.random((6, 1, 1)).astype(np.float32)):
        np.testing.assert_array_equal(torch_layers.fold_weight_norm(wg, wv),
                                      jax_layers.fold_weight_norm(wg, wv))
    with pytest.raises(ValueError):
        torch_layers.fold_weight_norm(np.ones((2, 2, 2), np.float32), wv)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pos_conv_even_kernel(models, dtype):
    """Kernel 16 (even) with pad 8 gives one extra frame that is dropped."""
    jcfg, tcfg, jp, tp = models
    assert tcfg.num_conv_pos_embeddings % 2 == 0
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 37, 32)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    with jax.default_matmul_precision("highest"):
        want = jax_encoder.pos_conv_forward(
            jp["encoder"]["pos_conv_embed"], jnp.asarray(x).astype(jdt), jcfg)
    got = torch_encoder.pos_conv_forward(
        tp["encoder"]["pos_conv_embed"], torch.from_numpy(x).to(tdt), tcfg)
    assert tuple(got.shape) == (2, 37, 32)
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), atol=F32_ATOL, rtol=0)
    else:
        # bf16 convs sum 64 bf16 products; the two libraries round the
        # accumulated sum at different points, so allow a few bf16 ulps
        np.testing.assert_allclose(_np(got), _np(want), atol=2e-2, rtol=4 * BF16_RTOL)


def test_feature_extractor_masked(models):
    """Conv stack with masked layer-0 GroupNorm on a ragged batch."""
    jcfg, tcfg, jp, tp = models
    rng = np.random.default_rng(5)
    audio = rng.normal(size=(3, 800)).astype(np.float32)
    lens = np.array([800, 555, 123], np.int32)
    for i, n in enumerate(lens):
        audio[i, n:] = 0
    with jax.default_matmul_precision("highest"):
        want = jax_fe.feature_extractor_forward(
            jp["feature_extractor"], jnp.asarray(audio), jcfg, audio_lens=jnp.asarray(lens))
    got = torch_fe.feature_extractor_forward(
        tp["feature_extractor"], torch.from_numpy(audio), tcfg,
        audio_lens=torch.from_numpy(lens))
    np.testing.assert_allclose(_np(got), _np(want), atol=F32_ATOL, rtol=0)
