"""PyTorch port vs the JAX package: int8 serving (`models/quantize.py`).

Same seeded weights and inputs on both sides (the JAX tree carried across
by `params_from_jax`), on the CPU. `quantize_linear_int8` and
`quantize_encoder_int8` give JAX's int8 tree leaf for leaf (`kernel_q` and
`scale` bit-equal, every other leaf the same tensor); `linear_int8` is
bit-equal to JAX's at f32 and within one bf16 ulp at bf16 (both are
exact integer products followed by the same f32 epilogue); the int8
forward stays inside the JAX package's own bound of the bf16 forward
(`tests/test_quantize.py`: max |Δ| < 0.25·max|lp_bf16| + 0.1); the int8
`BatchAligner` gives the JAX engine's words within one frame. Both
packages accept and refuse the same presets, pinned by name. The repairs:
the bf16 cast keeps exactly JAX's f32 leaves on an int8 tree, and the tree
check takes a quantized projection and refuses a malformed one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wav2vec2_tpu.config import Wav2Vec2ModelConfig as JaxCfg
from wav2vec2_tpu.models import ctc_model as jax_ctc
from wav2vec2_tpu.models import presets as jax_presets
from wav2vec2_tpu.models import quantize as jq
from wav2vec2_tpu.models.params import init_params as jax_init_params
from wav2vec2_tpu.parallel.batching import BatchAligner as JaxBatchAligner
from wav2vec2_tpu_torch.config import Wav2Vec2ModelConfig as TorchCfg
from wav2vec2_tpu_torch.errors import InvalidInputError, RuntimeBackendError
from wav2vec2_tpu_torch.models import ctc_model as torch_ctc
from wav2vec2_tpu_torch.models import params as torch_params
from wav2vec2_tpu_torch.models import quantize as tq
from wav2vec2_tpu_torch.parallel.batching import BatchAligner

CONFIG = dict(
    hidden_size=64, num_hidden_layers=3, num_attention_heads=4,
    intermediate_size=128, conv_dim=[32, 32], conv_kernel=[10, 3],
    conv_stride=[5, 2], num_conv_pos_embeddings=16,
    num_conv_pos_embedding_groups=4, pad_token_id=0, vocab_size=32,
    do_stable_layer_norm=False, feat_extract_norm="group", conv_bias=False,
)
VOCAB = {"|": 4}
for _i, _c in enumerate("ETAONIHSRDLUMWCFGYPBVKXJQZ"):
    VOCAB[_c] = 5 + _i
# the presets whose trees both packages' quantize_encoder_int8 take: the
# wav2vec2 encoder's layers (and SEW's, which are the same); the conformers,
# w2v-BERT and SEW-D have other layer keys
INT8_ACCEPTED = {
    "data2vec-audio-base-960h", "hubert-base-ls960", "hubert-large-ls960-ft",
    "mhubert-147", "mms-1b", "sew-base", "unispeech-large-phoneme",
    "unispeech-sat-base-100h", "wav2vec2-base-960h", "wav2vec2-large-960h-lv60",
    "wav2vec2-large-adapter", "wavlm-base-plus", "wavlm-large", "xlsr-53",
}
INT8_REFUSED = {"sew-d-base": "SEW-D", "w2v-bert-2.0": "w2v-BERT",
                "wav2vec2-conformer-rel-pos-large-960h": "wav2vec2-conformer",
                "wav2vec2-conformer-rope-large-960h": "wav2vec2-conformer"}


def _perturbed_biases(tree, seed):
    """The numpy tree with every bias drawn off 0 (init leaves them at 0,
    which would hide a bias dropped or cast), in place."""
    rng = np.random.default_rng(seed)

    def walk(node):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v)
            elif k == "bias":
                node[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)

    walk(tree)
    return tree


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = JaxCfg.from_dict(CONFIG), TorchCfg.from_dict(CONFIG)
    tree = _perturbed_biases(
        jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0))), 1)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), torch_params.params_from_jax(tree)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for name, sub in tree.items()
                for k, v in _leaves(sub, f"{prefix}/{name}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _leaves(sub, f"{prefix}/{i}").items()}
    return {prefix: tree}


@pytest.mark.parametrize("stored", ["float32", "bfloat16"])
def test_quantize_linear_int8_is_bit_equal_to_jax(stored):
    rng = np.random.default_rng(0)
    w = rng.normal(0, 0.05, size=(3, 64, 128)).astype(np.float32)
    w[1, :, 7] = 0.0  # an all-zero channel takes the 1e-12 scale floor
    jw = jnp.asarray(w, dtype=stored)
    tw = torch.from_numpy(w).to(getattr(torch, stored))
    want = jq.quantize_linear_int8({"kernel": jw, "bias": jnp.zeros(128)})
    got = tq.quantize_linear_int8({"kernel": tw, "bias": torch.zeros(128)})
    assert got["kernel_q"].dtype == torch.int8 and got["scale"].dtype == torch.float32
    assert got["kernel_q"].shape == (3, 64, 128) and got["scale"].shape == (3, 128)
    np.testing.assert_array_equal(got["kernel_q"].numpy(), np.asarray(want["kernel_q"]))
    np.testing.assert_array_equal(got["scale"].numpy().view(np.int32),
                                  np.asarray(want["scale"]).view(np.int32))
    assert float(got["scale"][1, 7]) == np.float32(1e-12)


def test_quantize_encoder_int8_tree_is_jax_leaf_for_leaf(models):
    _, _, jp, tp = models
    want = _leaves(jax.tree.map(np.asarray, jq.quantize_encoder_int8(jp)))
    got = tq.quantize_encoder_int8(tp)
    leaves = _leaves(got)
    assert set(leaves) == set(want)
    for path, x in leaves.items():
        w = want[path]
        assert x.numpy().dtype == w.dtype, path
        np.testing.assert_array_equal(x.numpy().view(np.uint8), w.view(np.uint8), err_msg=path)
    # every entry but the six projections is the same tensor as before
    assert got["feature_extractor"] is tp["feature_extractor"]
    assert got["encoder"]["layers"]["layer_norm"]["weight"] is \
        tp["encoder"]["layers"]["layer_norm"]["weight"]
    assert "kernel" in tp["encoder"]["layers"]["attention"]["q_proj"]
    # the JAX int8 tree converts as it is: int8 stays int8
    carried = _leaves(torch_params.params_from_jax(jax.tree.map(np.asarray,
                                                                jq.quantize_encoder_int8(jp))))
    for path, x in carried.items():
        np.testing.assert_array_equal(x.numpy().view(np.uint8), want[path].view(np.uint8),
                                      err_msg=path)


def test_linear_int8_matches_jax(models):
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, size=(7, 33, 64)).astype(np.float32)
    x[2, 5] = 0.0  # an all-zero row takes the activation scale floor
    w = rng.normal(0, 0.05, size=(64, 128)).astype(np.float32)
    b = rng.normal(0, 0.01, size=(128,)).astype(np.float32)
    jqq = jq.quantize_linear_int8({"kernel": jnp.asarray(w), "bias": jnp.asarray(b)})
    tqq = tq.quantize_linear_int8({"kernel": torch.from_numpy(w), "bias": torch.from_numpy(b)})
    want = np.asarray(jq.linear_int8(jnp.asarray(x), jqq["kernel_q"], jqq["scale"], jqq["bias"]))
    got = tq.linear_int8(torch.from_numpy(x), tqq["kernel_q"], tqq["scale"], tqq["bias"])
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.abs(want - (x @ w + b)).max() <= 0.03 * np.abs(x @ w + b).max()

    want16 = np.asarray(jq.linear_int8(jnp.asarray(x, jnp.bfloat16), jqq["kernel_q"],
                                       jqq["scale"], jqq["bias"]).astype(jnp.float32))
    got16 = tq.linear_int8(torch.from_numpy(x).bfloat16(), tqq["kernel_q"], tqq["scale"],
                           tqq["bias"])
    assert got16.dtype == torch.bfloat16
    ulp = np.abs(want16) * 2.0 ** -7 + 1e-30
    assert (np.abs(got16.float().numpy() - want16) <= ulp).all()
    # linear_maybe_quantized dispatches on the entry's keys
    np.testing.assert_array_equal(tq.linear_maybe_quantized(torch.from_numpy(x), tqq).numpy(),
                                  want)
    plain = {"kernel": torch.from_numpy(w), "bias": torch.from_numpy(b)}
    np.testing.assert_array_equal(tq.linear_maybe_quantized(torch.from_numpy(x), plain).numpy(),
                                  (torch.from_numpy(x) @ plain["kernel"] + plain["bias"]).numpy())


@pytest.mark.parametrize("m,k,n", [(5, 3, 5), (49, 768, 3072), (16, 12, 20), (17, 8, 8)])
def test_padded_int_mm_is_exact(m, k, n, monkeypatch):
    """The card's path pads rows to > 16 and widths to multiples of 8 with
    zeros; run here by making the operands look like CUDA tensors to the
    shape rule, against an f64 product of the same int8 values (exact
    below 2**53)."""
    rng = np.random.default_rng(m + k + n)
    a = torch.from_numpy(rng.integers(-127, 128, size=(m, k)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, size=(k, n)).astype(np.int8))
    want = a.double() @ b.double()
    padded = []
    real = torch._int_mm

    def spy(x, y):
        padded.append((tuple(x.shape), tuple(y.shape)))
        return real(x, y)

    monkeypatch.setattr(torch, "_int_mm", spy)
    got = tq.int8_matmul(a, b)
    np.testing.assert_array_equal(got.double().numpy(), want.numpy())
    monkeypatch.setattr(tq, "_on_card", lambda t: True)
    got = tq.int8_matmul(a, b)
    assert got.dtype == torch.int32 and got.shape == (m, n)
    np.testing.assert_array_equal(got.double().numpy(), want.numpy())
    (xa, xb), = padded[1:]
    assert xa[0] > 16 and xa[1] % 8 == 0 and xb[1] % 8 == 0 and xa[1] == xb[0]


def test_int8_matmul_without_int_mm_raises(monkeypatch):
    monkeypatch.delattr(torch, "_int_mm")
    with pytest.raises(RuntimeError, match="_int_mm"):
        tq.int8_matmul(torch.zeros((17, 8), dtype=torch.int8),
                       torch.zeros((8, 8), dtype=torch.int8))


def test_int8_forward_within_the_jax_bound(models):
    jcfg, tcfg, jp, tp = models
    audio = np.random.default_rng(2).normal(0, 1, size=(2, 8000)).astype(np.float32)
    lens = torch.tensor([8000, 6000])
    bf16 = torch_ctc.wav2vec2_forward(tp, torch.from_numpy(audio), tcfg, audio_lens=lens,
                                      compute_dtype=torch.bfloat16).numpy()
    qp = tq.quantize_encoder_int8(tp)
    got = torch_ctc.wav2vec2_forward(qp, torch.from_numpy(audio), tcfg, audio_lens=lens,
                                     compute_dtype=torch.bfloat16).numpy()
    assert got.shape == bf16.shape and np.isfinite(got).all()
    assert np.abs(got - bf16).max() < 0.25 * np.abs(bf16).max() + 0.1
    jax_int8 = np.asarray(jax_ctc.wav2vec2_forward(
        jq.quantize_encoder_int8(jp), jnp.asarray(audio), jcfg,
        audio_lens=jnp.asarray(lens.numpy()), compute_dtype=jnp.bfloat16))
    assert np.abs(got - jax_int8).max() < 0.25 * np.abs(jax_int8).max() + 0.1
    # without int8 the routed sites are the plain linears: same bits as before
    f32 = torch_ctc.wav2vec2_forward(tp, torch.from_numpy(audio), tcfg, audio_lens=lens)
    want = jax_ctc.wav2vec2_forward(jp, jnp.asarray(audio), jcfg,
                                    audio_lens=jnp.asarray(lens.numpy()))
    assert np.abs(f32.numpy() - np.asarray(want)).max() < 1e-4 * np.abs(np.asarray(want)).max()


def test_batch_aligner_int8_matches_jax(models):
    jcfg, tcfg, jp, tp = models
    rng = np.random.default_rng(2)
    audios = [rng.normal(0, 1, size=n).astype(np.float32) for n in (8000, 8000, 5000)]
    texts = ["HELLO WORLD", "THE CAT", "GOOD DAY"]
    port = BatchAligner(tcfg, tp, VOCAB, "bfloat16", device="cpu", quantize_int8=True)
    assert port.cfg.use_flash_attention is False
    q = port.params["encoder"]["layers"]["feed_forward"]["output_dense"]
    assert q["kernel_q"].dtype == torch.int8 and q["scale"].dtype == torch.float32
    assert q["bias"].dtype == torch.float32  # linear_int8 adds its bias in f32
    assert port.params["lm_head"]["kernel"].dtype == torch.bfloat16
    got = port.align_utterances(audios, texts)
    want = JaxBatchAligner(jcfg, jp, VOCAB, compute_dtype="bfloat16",
                           quantize_int8=True).align_utterances(audios, texts)
    base = BatchAligner(tcfg, tp, VOCAB, "bfloat16", device="cpu").align_utterances(audios, texts)
    stride = tcfg.frame_stride_ms(16000)
    for g, w, b in zip(got, want, base):
        assert [x.word for x in g.words] == [x.word for x in w.words] == \
            [x.word for x in b.words]
        for x, y in zip(g.words, w.words):
            assert abs(x.start_ms - y.start_ms) <= stride
            assert abs(x.end_ms - y.end_ms) <= stride


def test_batch_aligner_int8_refuses_a_conformer():
    d = dict(CONFIG, model_type="wav2vec2-conformer", feat_extract_norm="layer",
             conv_bias=True, position_embeddings_type="relative", hidden_act="swish",
             conv_depthwise_kernel_size=7)
    cfg = TorchCfg.from_dict(d)
    tp = torch_params.params_from_jax(torch_params.init_params(cfg, 0))
    with pytest.raises(InvalidInputError, match="wav2vec2-conformer"):
        BatchAligner(cfg, tp, VOCAB, "bfloat16", device="cpu", quantize_int8=True)


def _small_tree(shapes):
    """A torch tree with the keys of a JAX shape tree and tiny zero leaves
    (acceptance depends on the keys alone)."""
    if isinstance(shapes, dict):
        return {k: _small_tree(v) for k, v in shapes.items()}
    if isinstance(shapes, (list, tuple)):
        return [_small_tree(v) for v in shapes]
    return torch.zeros([min(d, 2) for d in shapes.shape])


def test_both_packages_accept_and_refuse_the_same_presets():
    assert set(jax_presets.PRESETS) == INT8_ACCEPTED | set(INT8_REFUSED)
    for name in sorted(jax_presets.PRESETS):
        cfg = jax_presets.PRESETS[name](32)
        shapes = jax.eval_shape(lambda cfg=cfg: jax_init_params(cfg, jax.random.PRNGKey(0)))
        if name in INT8_ACCEPTED:
            jax.eval_shape(jq.quantize_encoder_int8, shapes)
            quantized = tq.quantize_encoder_int8(_small_tree(shapes))
            assert quantized["encoder"]["layers"]["attention"]["q_proj"]["kernel_q"].dtype \
                == torch.int8, name
        else:
            with pytest.raises(KeyError):
                jax.eval_shape(jq.quantize_encoder_int8, shapes)
            with pytest.raises(InvalidInputError, match=INT8_REFUSED[name]):
                tq.quantize_encoder_int8(_small_tree(shapes))


@pytest.mark.parametrize("family", ["base", "wavlm-adapter"])
def test_bf16_cast_keeps_jax_f32_leaves_on_an_int8_tree(family):
    """The repair: the port's cast on an int8 tree keeps in f32 exactly the
    leaves JAX's `cast_compute_weights_bf16` keeps (the dequant scales and
    the quantized projections' biases among them)."""
    d = dict(CONFIG)
    if family == "wavlm-adapter":
        d.update(model_type="wavlm", num_buckets=16, max_bucket_distance=50,
                 adapter_attn_dim=4)
    jcfg = JaxCfg.from_dict(d)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    want = _leaves(jq.cast_compute_weights_bf16(jq.quantize_encoder_int8(jp)))
    got = _leaves(torch_params.cast_compute_weights_bf16(
        tq.quantize_encoder_int8(torch_params.params_from_jax(jax.tree.map(np.asarray, jp)))))
    assert set(got) == set(want)
    names = {jnp.dtype(jnp.float32): torch.float32, jnp.dtype(jnp.bfloat16): torch.bfloat16,
             jnp.dtype(jnp.int8): torch.int8}
    kept = {p for p, x in want.items() if x.dtype == jnp.float32}
    assert "/encoder/layers/attention/q_proj/scale" in kept
    assert "/encoder/layers/feed_forward/output_dense/bias" in kept
    for path, x in got.items():
        assert x.dtype == names[want[path].dtype], path


def test_tree_check_takes_int8_projections_and_refuses_malformed(models):
    _, _, jp, _ = models
    q = jax.tree.map(np.asarray, jq.quantize_encoder_int8(jp))
    torch_params.params_from_jax(q)
    del q["encoder"]["layers"]["attention"]["k_proj"]["scale"]
    with pytest.raises(RuntimeBackendError, match="k_proj"):
        torch_params.params_from_jax(q)
    plain = jax.tree.map(np.asarray, jp)
    plain["encoder"]["layers"]["feed_forward"]["output_dense"]["scale"] = \
        np.ones((3, 64), np.float32)
    with pytest.raises(RuntimeBackendError, match="output_dense"):
        torch_params.params_from_jax(plain)
