"""PyTorch port vs `transformers`: the HF loader of every wav2vec2-encoder
family.

A random-init `transformers` CTC model of each family is built here, at a
small size (2 layers, hidden 64, 4 heads), with every LayerNorm,
BatchNorm, bias and WavLM gate constant moved off its init value (and
mHuBERT's BatchNorm running statistics randomized), as
`tests/test_model_parity.py` does for the JAX package. Its `config.json`
(the HF config's `to_dict()`) parses to the JAX package's field values,
and its state dict goes through the port's loader; the port's logits on
one utterance are within 2e-4 of HF's and of the JAX package's on its own
loader's tree (`tests/test_model_parity.py`'s tolerance). w2v-BERT's HF
model takes log-mel features: it gets the port's `mel_frontend` output,
which is held to transformers' SeamlessM4TFeatureExtractor within 5e-4
(`tests/test_w2v_bert.py`'s bound for the JAX frontend). The port's
writer, `params_to_hf_flat_dict`, puts each family's own prefix back, its
output loads to the same tree, and it loads into the `transformers` model
with no unexpected key and the same logits. `transformers` is imported by
this test only, never by the port.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

transformers = pytest.importorskip("transformers")

from wav2vec2_tpu.config import Wav2Vec2ModelConfig as JaxCfg
from wav2vec2_tpu.models import ctc_model as jax_ctc
from wav2vec2_tpu.models.params import params_from_flat_dict as jax_params_from_flat_dict
from wav2vec2_tpu_torch.config import Wav2Vec2ModelConfig as TorchCfg
from wav2vec2_tpu_torch.models import ctc_model as torch_ctc
from wav2vec2_tpu_torch.models import mel as torch_mel
from wav2vec2_tpu_torch.models import params as torch_params

HF_ATOL = 2e-4

SMALL = dict(
    hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
    intermediate_size=96, conv_dim=[32, 32], conv_kernel=[10, 3],
    conv_stride=[5, 2], num_conv_pos_embeddings=16,
    num_conv_pos_embedding_groups=4, pad_token_id=0, vocab_size=32,
    hidden_dropout=0.0, attention_dropout=0.0, feat_proj_dropout=0.0,
    final_dropout=0.0, layerdrop=0.0, hidden_act="gelu",
)
PRE_NORM = dict(do_stable_layer_norm=True, feat_extract_norm="layer", conv_bias=True)
POST_NORM = dict(do_stable_layer_norm=False, feat_extract_norm="group", conv_bias=False)
# family -> (transformers model class, its config class, config fields)
HF_FAMILIES = {
    "wav2vec2-pre-norm": ("Wav2Vec2ForCTC", "Wav2Vec2Config", PRE_NORM),
    "mms-adapters": ("Wav2Vec2ForCTC", "Wav2Vec2Config", dict(PRE_NORM, adapter_attn_dim=8)),
    "add-adapter": ("Wav2Vec2ForCTC", "Wav2Vec2Config",
                    dict(PRE_NORM, add_adapter=True, num_adapter_layers=3)),
    "add-adapter-proj": ("Wav2Vec2ForCTC", "Wav2Vec2Config",
                         dict(POST_NORM, add_adapter=True, num_adapter_layers=2,
                              output_hidden_size=48)),
    "hubert-base": ("HubertForCTC", "HubertConfig", POST_NORM),
    "hubert-large": ("HubertForCTC", "HubertConfig", PRE_NORM),
    "hubert-no-proj-ln": ("HubertForCTC", "HubertConfig",
                          dict(POST_NORM, feat_proj_layer_norm=False)),
    "mhubert-batch-norm": ("HubertForCTC", "HubertConfig",
                           dict(POST_NORM, conv_pos_batch_norm=True)),
    "data2vec-audio": ("Data2VecAudioForCTC", "Data2VecAudioConfig",
                       dict(num_conv_pos_embeddings=3, conv_pos_kernel_size=19)),
    "wavlm-base": ("WavLMForCTC", "WavLMConfig",
                   dict(POST_NORM, num_buckets=32, max_bucket_distance=100)),
    "wavlm-large": ("WavLMForCTC", "WavLMConfig",
                    dict(PRE_NORM, num_buckets=32, max_bucket_distance=100)),
    "unispeech": ("UniSpeechForCTC", "UniSpeechConfig", PRE_NORM),
    "unispeech-sat": ("UniSpeechSatForCTC", "UniSpeechSatConfig", POST_NORM),
    "sew": ("SEWForCTC", "SEWConfig", dict(POST_NORM, squeeze_factor=2)),
    "sew-d": ("SEWDForCTC", "SEWDConfig",
              dict(POST_NORM, squeeze_factor=2, position_buckets=16,
                   max_position_embeddings=64, layer_norm_eps=1e-7, share_att_key=True)),
    "w2v-bert": ("Wav2Vec2BertForCTC", "Wav2Vec2BertConfig",
                 dict(position_embeddings_type="relative_key", left_max_position_embeddings=8,
                      right_max_position_embeddings=2, conv_depthwise_kernel_size=7,
                      hidden_act="swish", add_adapter=True, num_adapter_layers=1,
                      use_intermediate_ffn_before_adapter=True, conformer_conv_dropout=0.0,
                      activation_dropout=0.0, apply_spec_augment=False)),
}
BERT_SAMPLES = 400 + 160 * 101  # 102 mel frames: no odd frame for HF's stacking to pad


def _perturb_hf(model, seed):
    """Every norm affine, bias and WavLM gate constant off its init value;
    BatchNorm running statistics randomized."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias") or "norm" in name.lower() or "gru_rel_pos_const" in name:
                p.add_(0.2 * torch.randn(p.shape, generator=gen))
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(0.3 * torch.randn(b.shape, generator=gen))
            elif name.endswith("running_var"):
                b.copy_(0.5 + torch.rand(b.shape, generator=gen))


@pytest.fixture(scope="module", params=sorted(HF_FAMILIES))
def hf_model(request):
    cls_name, cfg_name, fields = HF_FAMILIES[request.param]
    hf_cfg = getattr(transformers, cfg_name)(**{**SMALL, **fields})
    torch.manual_seed(0)
    model = getattr(transformers, cls_name)(hf_cfg).eval()
    _perturb_hf(model, 1)
    d = hf_cfg.to_dict()
    state = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    return request.param, model, d, state


def _audio(family):
    n = BERT_SAMPLES if family == "w2v-bert" else 3200
    return np.random.default_rng(1).normal(size=(1, n)).astype(np.float32)


def _torch_logits(tp, tcfg, audio):
    return torch_ctc.wav2vec2_forward(tp, torch.from_numpy(audio), tcfg).numpy()


def _hf_logits(model, tcfg, audio):
    """The HF model's logits; w2v-BERT's on the port's mel features (the
    frontend is held to HF's extractor on its own below)."""
    x = torch.from_numpy(audio)
    if tcfg.frontend_style == "mel":
        x = torch_mel.mel_frontend(x, tcfg)[0]
    with torch.no_grad():
        return model(x).logits.numpy()


def test_config_json_parses_to_the_jax_fields(hf_model):
    _, _, d, _ = hf_model
    got, want = TorchCfg.from_dict(d), JaxCfg.from_dict(d)
    fields = [f.name for f in dataclasses.fields(got)]
    assert {n: getattr(got, n) for n in fields} == {n: getattr(want, n) for n in fields}


def test_loader_matches_transformers_and_the_jax_loader(hf_model):
    family, model, d, state = hf_model
    tcfg, jcfg = TorchCfg.from_dict(d), JaxCfg.from_dict(d)
    tp = torch_params.params_from_flat_dict(state, tcfg)
    if "adapter_attn_dim" in HF_FAMILIES[family][2]:
        assert "adapter_layer" in tp["encoder"]["layers"]
    if tcfg.attention_style == "wavlm":
        assert "rel_attn_embed" in tp["encoder"]
    assert ("layer_norm" in tp["feature_projection"]) == tcfg.feat_proj_layer_norm
    audio = _audio(family)
    ref = _hf_logits(model, tcfg, audio)
    got = _torch_logits(tp, tcfg, audio)
    assert got.shape == ref.shape == (1, tcfg.conv_output_length(audio.shape[1]), 32)
    np.testing.assert_allclose(got, ref, atol=HF_ATOL, rtol=HF_ATOL)
    jp = jax_params_from_flat_dict(state, jcfg)
    want = np.asarray(jax_ctc.wav2vec2_forward(jp, jnp.asarray(audio), jcfg))
    np.testing.assert_allclose(got, want, atol=HF_ATOL, rtol=HF_ATOL)


def _leaves(tree, path=()):
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        return {p: v for k, sub in items for p, v in _leaves(sub, path + (k,)).items()}
    return {path: tree.numpy()}


def test_writer_round_trips_under_the_familys_prefix(hf_model):
    _, _, d, state = hf_model
    tcfg = TorchCfg.from_dict(d)
    tp = torch_params.params_from_flat_dict(state, tcfg)
    flat = torch_params.params_to_hf_flat_dict(tp, tcfg, model_type=d["model_type"])
    prefix = torch_params.HF_PREFIXES[d["model_type"]]
    assert all(k.startswith(prefix) or k.startswith("lm_head.") for k in flat)
    back = _leaves(torch_params.params_from_flat_dict(flat, tcfg))
    want = _leaves(tp)
    assert back.keys() == want.keys()
    for path, a in want.items():
        np.testing.assert_allclose(back[path], a, rtol=1e-6, atol=1e-6, err_msg=str(path))


def test_writer_output_loads_into_transformers(hf_model):
    """The port's writer output loads into a fresh `transformers` model of
    the family with no unexpected key (missing: only the unused
    masked_spec_embed and BatchNorm counters), which then gives the
    original model's logits."""
    family, model, d, state = hf_model
    tcfg = TorchCfg.from_dict(d)
    flat = torch_params.params_to_hf_flat_dict(torch_params.params_from_flat_dict(state, tcfg),
                                               tcfg, model_type=d["model_type"])
    cls_name, cfg_name, _ = HF_FAMILIES[family]
    fresh = getattr(transformers, cls_name)(getattr(transformers, cfg_name)(**d)).eval()
    missing, unexpected = fresh.load_state_dict(
        {k: torch.from_numpy(v) for k, v in flat.items()}, strict=False)
    assert not unexpected, unexpected
    assert all(k.endswith(("masked_spec_embed", "num_batches_tracked")) for k in missing), missing
    audio = _audio(family)
    np.testing.assert_allclose(_hf_logits(fresh, tcfg, audio), _hf_logits(model, tcfg, audio),
                               atol=HF_ATOL, rtol=HF_ATOL)


def test_mel_frontend_matches_the_seamless_extractor():
    extractor = transformers.SeamlessM4TFeatureExtractor()
    np.testing.assert_allclose(torch_mel.kaldi_mel_filter_bank(), extractor.mel_filters,
                               rtol=1e-10, atol=1e-12)
    audio = (np.random.default_rng(0).normal(size=BERT_SAMPLES) * 0.1).astype(np.float32)
    want = extractor([audio], sampling_rate=16000, return_tensors="np",
                     padding=True)["input_features"][0]
    tcfg = TorchCfg.from_dict({**SMALL, **HF_FAMILIES["w2v-bert"][2],
                               "model_type": "wav2vec2-bert"})
    got = torch_mel.mel_frontend(torch.from_numpy(audio)[None], tcfg)[0][0].numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=5e-4)
