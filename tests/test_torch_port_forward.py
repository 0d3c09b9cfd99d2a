"""PyTorch port vs the JAX package: the whole wav2vec2 CTC forward.

The JAX parameter pytree (random init) goes through the port's converter,
so both packages run the same weights on the same numpy audio. Tolerance
at f32: 1e-4 absolute on log-probs (the JAX side at HIGHEST precision; sums
taken in another order through 2 encoder layers). At bf16 the two
libraries round intermediate results at different places, so the bf16
forward is held to the log-prob distance gate of bench.py (mean |Δ| to
the f32 forward ≤ 0.05) on each side instead of to each other.
"""

import json

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from wav2vec2_tpu.config import Wav2Vec2ModelConfig as JaxCfg
from wav2vec2_tpu.models import ctc_model as jax_ctc
from wav2vec2_tpu.models.params import init_params as jax_init_params
from wav2vec2_tpu.models.params import params_from_flat_dict as jax_params_from_flat_dict
from wav2vec2_tpu_torch.config import Wav2Vec2ModelConfig as TorchCfg
from wav2vec2_tpu_torch.errors import InvalidInputError, RuntimeBackendError
from wav2vec2_tpu_torch.models import ctc_model as torch_ctc
from wav2vec2_tpu_torch.models import params as torch_params

F32_LP_ATOL = 1e-4

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
    tp = torch_params.params_from_jax(jax.tree.map(np.asarray, jp))
    return jcfg, tcfg, jp, tp


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    audio = rng.normal(size=(3, 4000)).astype(np.float32)
    lens = np.array([4000, 3000, 1234], np.int32)
    for i, n in enumerate(lens):
        audio[i, n:] = 0
    return audio, lens


def _jax_lp(jp, jcfg, audio, lens, dtype=jnp.float32):
    logits = jax_ctc.wav2vec2_forward(jp, jnp.asarray(audio), jcfg,
                                      audio_lens=jnp.asarray(lens), compute_dtype=dtype)
    return np.asarray(jax_ctc.log_softmax_logits(logits))


def _torch_lp(tp, tcfg, audio, lens, dtype=torch.float32):
    logits = torch_ctc.wav2vec2_forward(tp, torch.from_numpy(audio), tcfg,
                                        audio_lens=torch.from_numpy(lens), compute_dtype=dtype)
    return torch_ctc.log_softmax_logits(logits).numpy()


def test_forward_f32_padded_batch_matches_jax(models):
    jcfg, tcfg, jp, tp = models
    audio, lens = _batch()
    want = _jax_lp(jp, jcfg, audio, lens)
    got = _torch_lp(tp, tcfg, audio, lens)
    assert got.shape == want.shape == (3, tcfg.conv_output_length(4000), 32)
    np.testing.assert_allclose(got, want, atol=F32_LP_ATOL, rtol=0)


def test_forward_padded_equals_unpadded(models):
    """Padding is exact: row 2 alone (unpadded) equals its padded row."""
    _, tcfg, _, tp = models
    audio, lens = _batch()
    padded = _torch_lp(tp, tcfg, audio, lens)
    alone = _torch_lp(tp, tcfg, audio[2:, : lens[2]].copy(), lens[2:])
    t2 = tcfg.conv_output_length(int(lens[2]))
    np.testing.assert_allclose(padded[2, :t2], alone[0], atol=F32_LP_ATOL, rtol=0)


def test_forward_bf16_within_gate_of_f32(models):
    jcfg, tcfg, jp, tp = models
    audio, lens = _batch(1)
    t = tcfg.conv_output_length(1234)
    ref = _jax_lp(jp, jcfg, audio, lens)[:, :t]
    for lp in (_jax_lp(jp, jcfg, audio, lens, jnp.bfloat16)[:, :t],
               _torch_lp(tp, tcfg, audio, lens, torch.bfloat16)[:, :t]):
        d = np.abs(lp.astype(np.float64) - ref)
        assert d.mean() <= 0.05 and np.percentile(d, 99) <= 0.3


def test_f32_forward_turns_tf32_off_and_restores():
    torch.backends.cudnn.allow_tf32 = True
    seen = []
    with torch_ctc.full_f32_precision():
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
    assert seen == [(False, False)]
    assert torch.backends.cudnn.allow_tf32 is True


def test_frame_lengths_match_jax(models):
    jcfg, tcfg, _, _ = models
    lens = np.array([0, 9, 10, 11, 400, 4000, 16000], np.int32)
    want = np.asarray(jax_ctc.frame_lengths(jcfg, jnp.asarray(lens)))
    got = torch_ctc.frame_lengths(tcfg, torch.from_numpy(lens)).numpy()
    np.testing.assert_array_equal(got, want)
    assert [tcfg.conv_output_length(int(n)) for n in lens] == list(want)


def test_hf_flat_dict_round_trip_matches_jax_loader(models):
    """Port params → HF names (weight-normed pos-conv) → both loaders give
    the same forward."""
    jcfg, tcfg, _, tp = models
    flat = torch_params.params_to_hf_flat_dict(tp, tcfg)
    assert flat["wav2vec2.encoder.pos_conv_embed.conv.weight_g"].shape == (1, 1, 16)
    tp2 = torch_params.params_from_flat_dict(flat, tcfg)
    jp2 = jax_params_from_flat_dict(flat, jcfg)
    audio, lens = _batch(2)
    np.testing.assert_allclose(_torch_lp(tp2, tcfg, audio, lens),
                               _jax_lp(jp2, jcfg, audio, lens), atol=F32_LP_ATOL, rtol=0)
    np.testing.assert_allclose(_torch_lp(tp2, tcfg, audio, lens),
                               _torch_lp(tp, tcfg, audio, lens), atol=F32_LP_ATOL, rtol=0)
    with pytest.raises(RuntimeBackendError):
        torch_params.params_from_flat_dict(
            {k: v for k, v in flat.items() if "lm_head" not in k}, tcfg)


def test_numpy_init_has_the_jax_tree_shapes(models):
    jcfg, tcfg, jp, _ = models
    want = jax.tree.map(lambda a: tuple(a.shape), jp)
    got = jax.tree.map(lambda a: tuple(a.shape), torch_params.init_params(tcfg, seed=0))
    assert got == want


def test_bf16_weight_storage_is_exact_under_bf16_compute(models):
    _, tcfg, _, tp = models
    cast = torch_params.cast_compute_weights_bf16(tp)
    assert cast["encoder"]["layer_norm"]["weight"].dtype == torch.float32
    assert cast["encoder"]["layers"]["attention"]["q_proj"]["kernel"].dtype == torch.bfloat16
    audio, lens = _batch(3)
    np.testing.assert_array_equal(_torch_lp(cast, tcfg, audio, lens, torch.bfloat16),
                                  _torch_lp(tp, tcfg, audio, lens, torch.bfloat16))


@pytest.mark.parametrize("change", [
    {"model_type": "wavlm"}, {"do_stable_layer_norm": True},
    {"feat_extract_norm": "layer"}, {"add_adapter": True},
])
def test_config_refuses_graphs_outside_the_slice(change):
    with pytest.raises(InvalidInputError):
        TorchCfg.from_dict({**CONFIG, **change})


def test_converter_refuses_other_families(models):
    _, _, jp, _ = models
    tree = jax.tree.map(np.asarray, jp)
    tree["encoder"]["rel_attn_embed"] = np.zeros((4, 2), np.float32)
    with pytest.raises(RuntimeBackendError):
        torch_params.params_from_jax(tree)


def test_config_load(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps({**CONFIG, "model_type": "wav2vec2"}))
    cfg = TorchCfg.load(tmp_path / "config.json")
    assert cfg.frame_stride_ms(16000) == JaxCfg.from_dict(CONFIG).frame_stride_ms(16000)
