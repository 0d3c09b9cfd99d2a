"""Model parameters: random init, the converter from the JAX pytree, and
the HF safetensors loader and writer.

The port keeps the JAX package's parameter tree (`wav2vec2_tpu.models.
params`) as nested dicts of torch tensors: linear kernels stored [in, out],
conv weights [O, I/G, K], encoder layers (and data2vec's positional convs,
and the adapters' layers) stacked on a leading L axis, the pos-conv weight
norm folded into a plain conv weight, BatchNorms folded to a per-channel
affine, the conformer's kernel-1 pointwise convs as [in, out] kernels, and
WavLM's bias embedding lifted from layer 0 to the encoder. So the converter
from a JAX pytree is a leaf-by-leaf copy, and a test can run both packages
on the same weights. Four encoders: the wav2vec2 transformer encoder (with
the HuBERT, data2vec-audio, WavLM, MMS, mHuBERT, UniSpeech(-SAT) and
conv-adapter variants, and SEW's squeezed form), SEW-D's DeBERTa encoder,
wav2vec2-conformer, and w2v-BERT's conformer (with its mel projection,
intermediate FFN and BERT adapter).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..config import Wav2Vec2ModelConfig
from ..errors import RuntimeBackendError
from ..utils.checkpoint import load_safetensors
from .layers import fold_weight_norm

_TOP_KEYS = {"feature_extractor", "feature_projection", "encoder", "lm_head"}
_OPTIONAL_TOP_KEYS = {"adapter", "intermediate_ffn"}
_ENCODER_KEYS = {"pos_conv_embed", "layer_norm", "layers"}
_LAYER_KEYS = {"attention", "layer_norm", "feed_forward", "final_layer_norm"}
_ATTENTION_KEYS = ("q_proj", "k_proj", "v_proj", "out_proj")
_WAVLM_KEYS = {"gru_rel_pos_const", "gru_rel_pos_linear"}
_POS_CONV_KEYS = ({"weight", "bias"}, {"weight", "bias", "batch_norm"}, {"layers"})
_ADAPTER_KEYS = ({"layers"}, {"proj", "proj_layer_norm", "layers"})
_FFN_KEYS = {"intermediate_dense", "output_dense"}
_SEWD_ENCODER_KEYS = {"pos_conv_embed", "layers", "upsample", "rel_embeddings"}
_SEWD_LAYER_KEYS = {"attention", "intermediate_dense", "output_dense", "output_norm"}
_SEWD_ATTENTION_KEYS = ("query_proj", "key_proj", "value_proj", "output_dense")
_CONFORMER_ENCODER_KEYS = {"layer_norm", "layers"}
_CONFORMER_LAYER_KEYS = {"ffn1_layer_norm", "ffn1", "self_attn_layer_norm", "self_attn",
                         "conv_module", "ffn2_layer_norm", "ffn2", "final_layer_norm"}
_ATTENTION_PROJECTIONS = ("linear_q", "linear_k", "linear_v", "linear_out")
_REL_POS_KEYS = {"linear_pos", "pos_bias_u", "pos_bias_v"}
_CONV_MODULE_KEYS = {"layer_norm", "pointwise_conv1", "depthwise_conv", "batch_norm",
                     "pointwise_conv2"}
_BERT_CONV_MODULE_KEYS = (_CONV_MODULE_KEYS - {"batch_norm"}) | {"depthwise_layer_norm"}
_BERT_ADAPTER_LAYER_KEYS = {"residual_layer_norm", "residual_conv", "self_attn_layer_norm",
                            "self_attn_conv", "self_attn", "ffn_layer_norm", "ffn"}
# subtrees consumed in f32 whatever the compute dtype: the norms (the MMS
# adapter's is `norm`, the adapters' `proj_layer_norm`, SEW-D's
# `output_norm`, w2v-BERT's `depthwise_layer_norm` and the BERT adapter's
# `residual_layer_norm` / `ffn_layer_norm`), the folded BatchNorms, WavLM's
# bias embedding and gate constant, SEW-D's position embedding with its
# norm, and the int8 projections' dequant `scale`
# (`wav2vec2_tpu.models.quantize`'s set)
_KEEP_F32_KEYS = {"layer_norm", "final_layer_norm", "norm", "ffn1_layer_norm",
                  "ffn2_layer_norm", "self_attn_layer_norm", "proj_layer_norm",
                  "depthwise_layer_norm", "output_norm", "rel_embeddings",
                  "rel_embeddings_layer_norm", "residual_layer_norm", "ffn_layer_norm",
                  "batch_norm", "rel_attn_embed", "gru_rel_pos_const", "scale"}
# a projection the encoder reads through `quantize.linear_maybe_quantized`:
# plain, or int8 (`quantize.quantize_linear_int8`)
_DENSE_FORMS = ({"kernel", "bias"}, {"kernel_q", "scale", "bias"})
BATCH_NORM_EPS = 1e-5  # torch BatchNorm1d's default, folded in at load
# config.json model_type → the HF checkpoint's model prefix
HF_PREFIXES = {"wav2vec2": "wav2vec2.", "wav2vec2-conformer": "wav2vec2_conformer.",
               "hubert": "hubert.", "data2vec-audio": "data2vec_audio.",
               "wavlm": "wavlm.", "unispeech": "unispeech.",
               "unispeech-sat": "unispeech_sat.", "sew": "sew.", "sew-d": "sew_d.",
               "wav2vec2-bert": "wav2vec2_bert."}

_POS_CONV_ALIASES = {
    "wav2vec2.encoder.pos_conv_embed.conv.parametrizations.weight.original0":
        "wav2vec2.encoder.pos_conv_embed.conv.weight_g",
    "wav2vec2.encoder.pos_conv_embed.conv.parametrizations.weight.original1":
        "wav2vec2.encoder.pos_conv_embed.conv.weight_v",
}


def init_params(cfg: Wav2Vec2ModelConfig, seed: int) -> dict:
    """Random-init parameter tree as numpy f32 arrays in the JAX layout,
    with the shapes and scales of `wav2vec2_tpu.models.params.init_params`
    (the values differ: they come from numpy's generator)."""
    rng = np.random.default_rng(seed)

    def normal(shape, scale):
        return (rng.standard_normal(shape, dtype=np.float32) * np.float32(scale))

    def dense(n_in, n_out):
        return {"kernel": normal((n_in, n_out), (2.0 / (n_in + n_out)) ** 0.5),
                "bias": np.zeros((n_out,), np.float32)}

    def ln(n):
        return {"weight": np.ones((n,), np.float32), "bias": np.zeros((n,), np.float32)}

    def ffn_pair(n, inner):
        return {"intermediate_dense": dense(n, inner), "output_dense": dense(inner, n)}

    conv_layers = []
    in_c = 1
    for i, (out_c, k) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel)):
        conv = {"weight": normal((out_c, in_c, k), (1.0 / (in_c * k)) ** 0.5)}
        if cfg.conv_bias:
            conv["bias"] = np.zeros((out_c,), np.float32)
        layer = {"conv": conv}
        if cfg.feat_extract_norm == "layer" or i == 0:
            layer["layer_norm"] = ln(out_c)
        conv_layers.append(layer)
        in_c = out_c

    h, ffn = cfg.hidden_size, cfg.intermediate_size
    g, kpos = cfg.num_conv_pos_embedding_groups, cfg.num_conv_pos_embeddings
    nh = cfg.num_attention_heads

    def enc_layer():
        layer = {
            "attention": {k: dense(h, h)
                          for k in _ATTENTION_KEYS},
            "layer_norm": ln(h),
            "feed_forward": ffn_pair(h, ffn),
            "final_layer_norm": ln(h),
        }
        if cfg.adapter_attn_dim:
            layer["adapter_layer"] = {"norm": ln(h),
                                      "linear_1": dense(h, cfg.adapter_attn_dim),
                                      "linear_2": dense(cfg.adapter_attn_dim, h)}
        if cfg.attention_style == "wavlm":
            layer["attention"]["gru_rel_pos_const"] = np.ones((1, nh, 1, 1), np.float32)
            layer["attention"]["gru_rel_pos_linear"] = dense(h // nh, 8)
        return layer

    def sewd_layer():
        attention = {k: dense(h, h) for k in _SEWD_ATTENTION_KEYS}
        attention["output_norm"] = ln(h)
        return {"attention": attention, "intermediate_dense": dense(h, ffn),
                "output_dense": dense(ffn, h), "output_norm": ln(h)}

    def conformer_layer():
        k = cfg.conv_depthwise_kernel_size
        self_attn = {name: dense(h, h) for name in _ATTENTION_PROJECTIONS}
        if cfg.position_embeddings_type == "relative":
            self_attn["linear_pos"] = {"kernel": normal((h, h), (1.0 / h) ** 0.5)}
            self_attn["pos_bias_u"] = np.zeros((nh, h // nh), np.float32)
            self_attn["pos_bias_v"] = np.zeros((nh, h // nh), np.float32)
        elif cfg.position_embeddings_type == "relative_key":
            n_pos = cfg.left_max_position_embeddings + cfg.right_max_position_embeddings + 1
            self_attn["distance_embedding"] = normal((n_pos, h // nh), 0.02)
        ffn1 = ffn_pair(h, ffn)  # drawn before the conv module, as before
        conv_module = {
            "layer_norm": ln(h),
            "pointwise_conv1": {"kernel": normal((h, 2 * h), (1.0 / h) ** 0.5)},
            "depthwise_conv": {"weight": normal((h, 1, k), (1.0 / k) ** 0.5)},
        }
        if cfg.encoder_style == "conformer_bert":
            conv_module["depthwise_layer_norm"] = ln(h)
        else:
            # BatchNorm running stats fold to an identity affine at init
            conv_module["batch_norm"] = {"scale": np.ones((h,), np.float32),
                                         "shift": np.zeros((h,), np.float32)}
        conv_module["pointwise_conv2"] = {"kernel": normal((h, h), (1.0 / h) ** 0.5)}
        return {
            "ffn1_layer_norm": ln(h),
            "ffn1": ffn1,
            "self_attn_layer_norm": ln(h),
            "self_attn": self_attn,
            "conv_module": conv_module,
            "ffn2_layer_norm": ln(h),
            "ffn2": ffn_pair(h, ffn),
            "final_layer_norm": ln(h),
        }

    conformer = cfg.encoder_style in ("conformer", "conformer_bert")
    bert = cfg.encoder_style == "conformer_bert"
    deberta = cfg.attention_style == "deberta"
    layer = conformer_layer if conformer else sewd_layer if deberta else enc_layer
    layers = _stack([layer() for _ in range(cfg.num_hidden_layers)])
    # drawn in this order so that a seed gives the weights it gave before
    # the conformer and the other families were added
    if bert:
        feature_projection = {"layer_norm": ln(cfg.feature_projection_input_dim),
                              "projection": dense(cfg.feature_projection_input_dim, h)}
    elif cfg.encoder_style == "sew":
        # SEW projects only when the conv width differs from the hidden size
        feature_projection = {"layer_norm": ln(cfg.conv_dim[-1])}
        if cfg.conv_dim[-1] != h:
            feature_projection["projection"] = dense(cfg.conv_dim[-1], h)
    else:
        feature_projection = {"projection": dense(cfg.conv_dim[-1], h)}
        if cfg.feat_proj_layer_norm:
            feature_projection["layer_norm"] = ln(cfg.conv_dim[-1])
    # SEW-D's DeBERTa encoder and w2v-BERT have no encoder LayerNorm
    encoder = {"layers": layers} if deberta or bert else {"layer_norm": ln(h), "layers": layers}
    if cfg.pos_conv_style == "data2vec":
        n_l, kpos = cfg.num_conv_pos_embeddings, cfg.conv_pos_kernel_size
        encoder["pos_conv_embed"] = {"layers": {
            "weight": normal((n_l, h, h // g, kpos), (1.0 / (h // g * kpos)) ** 0.5),
            "bias": np.zeros((n_l, h), np.float32),
        }}
    elif not conformer:  # the conformer encoders have no positional conv
        encoder["pos_conv_embed"] = {
            "weight": normal((h, h // g, kpos), (1.0 / (h // g * kpos)) ** 0.5),
            "bias": np.zeros((h,), np.float32),
        }
        if cfg.conv_pos_batch_norm:
            encoder["pos_conv_embed"]["batch_norm"] = {
                "scale": np.ones((h,), np.float32), "shift": np.zeros((h,), np.float32)}
    if cfg.encoder_style == "sew":
        encoder["upsample"] = {"projection": dense(h, h * cfg.squeeze_factor)}
    if deberta:
        encoder["rel_embeddings"] = normal((2 * cfg.position_buckets, h), 0.02)
        encoder["rel_embeddings_layer_norm"] = ln(h)
    out_h = (cfg.output_hidden_size or h) if cfg.add_adapter else h
    tree = {
        "feature_projection": feature_projection,
        "encoder": encoder,
        "lm_head": dense(out_h, cfg.vocab_size),
    }
    if not bert:
        tree = {"feature_extractor": {"conv_layers": conv_layers}, **tree}
    if cfg.attention_style == "wavlm":
        encoder["rel_attn_embed"] = normal((cfg.num_buckets, nh), 0.02)
    if cfg.use_intermediate_ffn_before_adapter:
        tree["intermediate_ffn"] = ffn_pair(h, ffn)
    if cfg.add_adapter:
        k = cfg.adapter_kernel_size
        adapter = {}
        if out_h != h:
            adapter["proj"] = dense(h, out_h)
            adapter["proj_layer_norm"] = ln(out_h)

        def glu_conv():
            return {"weight": normal((2 * out_h, out_h, k), (1.0 / (out_h * k)) ** 0.5),
                    "bias": np.zeros((2 * out_h,), np.float32)}

        if bert:
            adapter["layers"] = _stack([{
                "residual_layer_norm": ln(out_h),
                "residual_conv": glu_conv(),
                "self_attn_layer_norm": ln(out_h),
                "self_attn_conv": glu_conv(),
                "self_attn": {name: dense(out_h, out_h) for name in _ATTENTION_PROJECTIONS},
                "ffn_layer_norm": ln(out_h),
                "ffn": ffn_pair(out_h, ffn),
            } for _ in range(cfg.num_adapter_layers)])
        else:
            adapter["layers"] = {
                "weight": normal((cfg.num_adapter_layers, 2 * out_h, out_h, k),
                                 (1.0 / (out_h * k)) ** 0.5),
                "bias": np.zeros((cfg.num_adapter_layers, 2 * out_h), np.float32),
            }
        tree["adapter"] = adapter
    return tree


def _stack(trees: list[dict]) -> dict:
    return {k: (_stack([t[k] for t in trees]) if isinstance(trees[0][k], dict)
                else np.stack([t[k] for t in trees]))
            for k in trees[0]}


def _check_keys(node: dict, expected: set, where: str) -> None:
    if set(node) != expected:
        raise RuntimeBackendError(
            "convert weights",
            f"{where} has keys {sorted(node)}; the port's graph expects "
            f"{sorted(expected)}",
        )


def _check_one_of(node: dict, allowed: tuple[set, ...], where: str) -> None:
    if set(node) not in allowed:
        raise RuntimeBackendError(
            "convert weights",
            f"{where} has keys {sorted(node)}; the port's graph expects one of "
            f"{[sorted(a) for a in allowed]}",
        )


def _check_tree(tree: dict) -> None:
    """Refuse a tree that is not one of the port's layouts — the wav2vec2
    encoder (SEW's squeezed form with its upsampler included), SEW-D's
    DeBERTa encoder, the conformer, w2v-BERT's conformer — told apart by
    the layers' keys: an unknown subtree would otherwise be silently
    ignored."""
    optional = _OPTIONAL_TOP_KEYS & set(tree)
    enc = tree["encoder"] if "encoder" in tree else {}
    layers = enc.get("layers", {})
    bert = "conv_module" in layers and "depthwise_layer_norm" in layers["conv_module"]
    top = (_TOP_KEYS - {"feature_extractor"}) if bert else _TOP_KEYS
    _check_keys(tree, top | optional, "params")
    _check_one_of(tree["feature_projection"],
                  ({"projection"}, {"layer_norm", "projection"}, {"layer_norm"}),
                  "feature_projection")
    if "intermediate_ffn" in tree:
        _check_keys(tree["intermediate_ffn"], _FFN_KEYS, "intermediate_ffn")
    if "adapter" in tree:
        adapter = tree["adapter"]
        _check_one_of(adapter, _ADAPTER_KEYS, "params['adapter']")
        if bert:
            _check_keys(adapter["layers"], _BERT_ADAPTER_LAYER_KEYS, "BERT adapter layers")
            _check_keys(adapter["layers"]["self_attn"], set(_ATTENTION_PROJECTIONS),
                        "BERT adapter self_attn")
        else:
            _check_keys(adapter["layers"], {"weight", "bias"}, "conv adapter layers")
    sew = {"upsample"} if "upsample" in enc else set()
    if "attention" in layers and "query_proj" in layers["attention"]:
        _check_keys(enc, _SEWD_ENCODER_KEYS | ({"rel_embeddings_layer_norm"}
                                               if "rel_embeddings_layer_norm" in enc
                                               else set()), "SEW-D encoder")
        _check_keys(layers, _SEWD_LAYER_KEYS, "SEW-D layers")
        _check_keys(layers["attention"], {*_SEWD_ATTENTION_KEYS, "output_norm"},
                    "SEW-D attention")
        _check_one_of(enc["pos_conv_embed"], _POS_CONV_KEYS[:1], "pos_conv_embed")
        return
    if "self_attn" not in layers:
        wavlm = {"rel_attn_embed"} if "rel_attn_embed" in enc else set()
        _check_keys(enc, _ENCODER_KEYS | wavlm | sew, "params['encoder']")
        _check_one_of(enc["pos_conv_embed"], _POS_CONV_KEYS, "pos_conv_embed")
        mms = "adapter_layer" in layers
        _check_keys(layers, _LAYER_KEYS | ({"adapter_layer"} if mms else set()),
                    "encoder layers")
        _check_keys(layers["attention"], {*_ATTENTION_KEYS, *(_WAVLM_KEYS if wavlm else ())},
                    "encoder attention (WavLM's gates come with its rel_attn_embed)")
        for group, names in (("attention", _ATTENTION_KEYS), ("feed_forward", _FFN_KEYS)):
            for name in sorted(names):
                _check_one_of(layers[group][name], _DENSE_FORMS, f"encoder {group}.{name}")
        if mms:
            _check_keys(layers["adapter_layer"], {"norm", "linear_1", "linear_2"},
                        "adapter_layer")
        return
    _check_keys(enc, {"layers"} if bert else _CONFORMER_ENCODER_KEYS, "params['encoder']")
    _check_keys(layers, _CONFORMER_LAYER_KEYS, "conformer layers")
    attn = set(_ATTENTION_PROJECTIONS)
    if "linear_pos" in layers["self_attn"]:
        attn |= _REL_POS_KEYS
    elif bert and "distance_embedding" in layers["self_attn"]:
        attn |= {"distance_embedding"}
    _check_keys(layers["self_attn"], attn, "conformer self_attn")
    for where, node in [*((f"self_attn.{n}", layers["self_attn"][n])
                          for n in _ATTENTION_PROJECTIONS),
                        *((f"{f}.{n}", layers[f][n]) for f in ("ffn1", "ffn2")
                          for n in sorted(_FFN_KEYS))]:
        _check_one_of(node, _DENSE_FORMS, f"conformer {where}")
    _check_keys(layers["conv_module"], _BERT_CONV_MODULE_KEYS if bert else _CONV_MODULE_KEYS,
                "conformer conv_module")


def params_from_jax(
    tree: dict, device: str | torch.device = "cpu",
    dtype: torch.dtype = torch.float32,
) -> dict:
    """JAX parameter pytree (numpy arrays, or anything `np.asarray` takes)
    → the port's tree of torch tensors on `device`, float leaves as
    `dtype` and the int8 weights of a quantized tree (`kernel_q`) as int8.
    The key set is checked per encoder (told apart by the layers' keys): a
    tree with an unknown subtree is refused."""
    _check_tree(tree)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [convert(v) for v in node]
        arr = np.asarray(node)
        if arr.dtype == np.int8:
            return torch.tensor(arr, device=device)
        return torch.tensor(np.asarray(arr, dtype=np.float32), dtype=dtype, device=device)

    return convert(tree)


def params_to_device(params, device: str | torch.device):
    """The same parameter tree with every tensor on `device`."""
    if isinstance(params, dict):
        return {k: params_to_device(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [params_to_device(v, device) for v in params]
    return params.to(device)


def cast_compute_weights_bf16(params: dict) -> dict:
    """Store compute weights (matmul kernels and biases, conv weights) in
    bf16 and keep the subtrees of `_KEEP_F32_KEYS` (norms, folded
    BatchNorms, WavLM's f32-consumed bias embedding and gate constant, int8
    dequant scales) and the bias of every int8-quantized projection
    (`quantize.linear_int8` adds it in f32) in f32, as
    `wav2vec2_tpu.models.quantize.cast_compute_weights_bf16` does. Under
    bf16 compute every consumption site casts weights to the activation
    dtype anyway, so this only halves the weight memory."""

    def walk(node):
        if isinstance(node, dict):
            quantized = "kernel_q" in node
            return {k: (v if k in _KEEP_F32_KEYS or (quantized and k == "bias") else walk(v))
                    for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node.to(torch.bfloat16) if node.dtype == torch.float32 else node

    return walk(params)


def _jax_tree_from_flat_dict(tensors: dict[str, np.ndarray], cfg) -> dict:
    """HF names → JAX-layout numpy tree, as `wav2vec2_tpu.models.params.
    params_from_flat_dict` builds it. Every family's model prefix (`hubert.`,
    `sew_d.`, `wav2vec2_bert.`, ...) is rewritten to `wav2vec2.` first, then
    the pos-conv's parametrization names to `weight_g` / `weight_v`. The
    conformer's unused positional conv weights, if present, are never read.
    A config-gated piece (the projection LayerNorm, mHuBERT's BatchNorm, an
    adapter, the intermediate FFN) missing from the checkpoint raises; the
    MMS adapters, WavLM's tensors and w2v-BERT's position tensors are read
    where the checkpoint has them. SEW and SEW-D keep their post-extractor
    LayerNorm at the model level (`sew.layer_norm`) and project only when
    the conv width differs from the hidden size; SEW-D's layers are
    DeBERTa's (`encoder.encoder.layer.N.attention.self.query_proj`, ...)."""
    t = {}
    for name, a in tensors.items():
        for prefix in HF_PREFIXES.values():
            if name.startswith(prefix):
                name = "wav2vec2." + name[len(prefix):]
                break
        t[_POS_CONV_ALIASES.get(name, name)] = np.asarray(a)

    def has(name):
        return name in t

    def get(name):
        if name not in t:
            raise RuntimeBackendError("load weights", f"missing tensor {name!r}")
        return np.asarray(t[name], dtype=np.float32)

    def dense(prefix):
        return {"kernel": get(prefix + ".weight").T, "bias": get(prefix + ".bias")}

    def ln(prefix):
        return {"weight": get(prefix + ".weight"), "bias": get(prefix + ".bias")}

    def ffn_pair(prefix):
        return {k: dense(f"{prefix}.{k}") for k in ("intermediate_dense", "output_dense")}

    def glu_conv(prefix):
        return {"weight": get(prefix + ".weight"), "bias": get(prefix + ".bias")}

    def batch_norm(prefix):
        # inference BatchNorm folds to a per-channel affine
        scale = get(prefix + ".weight") / np.sqrt(get(prefix + ".running_var")
                                                  + BATCH_NORM_EPS)
        shift = get(prefix + ".bias") - get(prefix + ".running_mean") * scale
        return {"scale": scale.astype(np.float32), "shift": shift.astype(np.float32)}

    def stacked(fmt, read, probe=".weight"):
        """read(fmt.format(i)) for i = 0, 1, ... while the checkpoint has
        layer i (its tensor fmt.format(i) + probe), stacked on a leading
        axis."""
        items = []
        while has(fmt.format(len(items)) + probe):
            items.append(read(fmt.format(len(items))))
        return _stack(items)

    bert = cfg.encoder_style == "conformer_bert"
    conformer = cfg.encoder_style in ("conformer", "conformer_bert")
    deberta = cfg.attention_style == "deberta"
    conv_layers = []
    for i in range(0 if bert else len(cfg.conv_dim)):
        p = f"wav2vec2.feature_extractor.conv_layers.{i}"
        conv = {"weight": get(p + ".conv.weight")}
        if cfg.conv_bias:
            conv["bias"] = get(p + ".conv.bias")
        layer = {"conv": conv}
        if cfg.feat_extract_norm == "layer" or i == 0:
            layer["layer_norm"] = ln(p + ".layer_norm")
        conv_layers.append(layer)

    def enc_layer(i):
        p = f"wav2vec2.encoder.layers.{i}"
        layer = {
            "attention": {k: dense(f"{p}.attention.{k}")
                          for k in _ATTENTION_KEYS},
            "layer_norm": ln(p + ".layer_norm"),
            "feed_forward": ffn_pair(p + ".feed_forward"),
            "final_layer_norm": ln(p + ".final_layer_norm"),
        }
        if has(p + ".adapter_layer.norm.weight"):
            # MMS attention adapter (per-language weights merged at export)
            a = p + ".adapter_layer"
            layer["adapter_layer"] = {"norm": ln(a + ".norm"), "linear_1": dense(a + ".linear_1"),
                                      "linear_2": dense(a + ".linear_2")}
        if has(p + ".attention.gru_rel_pos_const"):
            # WavLM's gate parameters, per layer
            layer["attention"]["gru_rel_pos_const"] = get(p + ".attention.gru_rel_pos_const")
            layer["attention"]["gru_rel_pos_linear"] = dense(p + ".attention.gru_rel_pos_linear")
        return layer

    def sewd_layer(i):
        p = f"wav2vec2.encoder.encoder.layer.{i}"
        return {
            "attention": {
                "query_proj": dense(p + ".attention.self.query_proj"),
                "key_proj": dense(p + ".attention.self.key_proj"),
                "value_proj": dense(p + ".attention.self.value_proj"),
                "output_dense": dense(p + ".attention.output.dense"),
                "output_norm": ln(p + ".attention.output.LayerNorm"),
            },
            "intermediate_dense": dense(p + ".intermediate.dense"),
            "output_dense": dense(p + ".output.dense"),
            "output_norm": ln(p + ".output.LayerNorm"),
        }

    def conformer_layer(i):
        p = f"wav2vec2.encoder.layers.{i}"
        self_attn = {k: dense(f"{p}.self_attn.{k}") for k in _ATTENTION_PROJECTIONS}
        if cfg.position_embeddings_type == "relative":
            # Transformer-XL extras: linear_pos has no bias; pos_bias_u/v
            # are [num_heads, head_dim]
            self_attn["linear_pos"] = {"kernel": get(p + ".self_attn.linear_pos.weight").T}
            self_attn["pos_bias_u"] = get(p + ".self_attn.pos_bias_u")
            self_attn["pos_bias_v"] = get(p + ".self_attn.pos_bias_v")
        elif cfg.position_embeddings_type == "relative_key":
            # w2v-BERT's clamped-distance embedding [left + right + 1, hd]
            self_attn["distance_embedding"] = get(p + ".self_attn.distance_embedding.weight")
        cm = f"{p}.conv_module"
        conv_module = {
            "layer_norm": ln(cm + ".layer_norm"),
            # kernel-1 convs [out, in, 1] fold to [in, out] matmul kernels
            "pointwise_conv1": {"kernel": get(cm + ".pointwise_conv1.weight")[:, :, 0].T},
            "depthwise_conv": {"weight": get(cm + ".depthwise_conv.weight")},
            "pointwise_conv2": {"kernel": get(cm + ".pointwise_conv2.weight")[:, :, 0].T},
        }
        if bert:
            conv_module["depthwise_layer_norm"] = ln(cm + ".depthwise_layer_norm")
        else:
            conv_module["batch_norm"] = batch_norm(cm + ".batch_norm")
        return {
            "ffn1_layer_norm": ln(p + ".ffn1_layer_norm"),
            "ffn1": ffn_pair(p + ".ffn1"),
            "self_attn_layer_norm": ln(p + ".self_attn_layer_norm"),
            "self_attn": self_attn,
            "conv_module": conv_module,
            "ffn2_layer_norm": ln(p + ".ffn2_layer_norm"),
            "ffn2": ffn_pair(p + ".ffn2"),
            "final_layer_norm": ln(p + ".final_layer_norm"),
        }

    if deberta and has("wav2vec2.encoder.encoder.conv.conv.weight"):
        raise RuntimeBackendError(
            "load weights", "SEW-D checkpoints with a DeBERTa ConvLayer (conv_kernel_size>0) "
            "are not supported; no released SEW-D speech checkpoint uses one")
    layer = conformer_layer if conformer else sewd_layer if deberta else enc_layer
    encoder = {"layers": _stack([layer(i) for i in range(cfg.num_hidden_layers)])}
    if not (deberta or bert):
        encoder["layer_norm"] = ln("wav2vec2.encoder.layer_norm")
    pos_p = "wav2vec2.encoder.pos_conv_embed"
    if not conformer and has(pos_p + ".layers.0.conv.weight"):
        # data2vec-audio: stacked positional convs, no weight norm
        encoder["pos_conv_embed"] = {"layers": stacked(
            pos_p + ".layers.{}.conv",
            lambda c: {"weight": get(c + ".weight"), "bias": get(c + ".bias")})}
    elif not conformer:
        if has(pos_p + ".conv.weight_v"):
            pos_weight = fold_weight_norm(get(pos_p + ".conv.weight_g"),
                                          get(pos_p + ".conv.weight_v"))
        else:
            pos_weight = get(pos_p + ".conv.weight")
        encoder["pos_conv_embed"] = {"weight": pos_weight, "bias": get(pos_p + ".conv.bias")}
        if cfg.conv_pos_batch_norm:
            # gated by the config, so that a checkpoint without the stats
            # fails to load (mHuBERT-147: BatchNorm on the conv input)
            encoder["pos_conv_embed"]["batch_norm"] = batch_norm(pos_p + ".batch_norm")
    rel_embed = "wav2vec2.encoder.layers.0.attention.rel_attn_embed.weight"
    if has(rel_embed):
        # WavLM: layer 0 owns the shared bias embedding; lifted to the
        # encoder so the layer stack stays uniform
        encoder["rel_attn_embed"] = get(rel_embed)
    if cfg.encoder_style == "sew":
        encoder["upsample"] = {"projection": dense("wav2vec2.encoder.upsample.projection")}
    if deberta:
        encoder["rel_embeddings"] = get("wav2vec2.encoder.encoder.rel_embeddings.weight")
        if "layer_norm" in cfg.norm_rel_ebd:
            encoder["rel_embeddings_layer_norm"] = ln("wav2vec2.encoder.encoder.LayerNorm")
    if cfg.encoder_style == "sew":
        feature_projection = {"layer_norm": ln("wav2vec2.layer_norm")}
        if cfg.conv_dim[-1] != cfg.hidden_size:
            feature_projection["projection"] = dense("wav2vec2.feature_projection")
    else:
        feature_projection = {"projection": dense("wav2vec2.feature_projection.projection")}
        if cfg.feat_proj_layer_norm:
            feature_projection["layer_norm"] = ln("wav2vec2.feature_projection.layer_norm")
    tree = {
        "feature_projection": feature_projection,
        "encoder": encoder,
        "lm_head": dense("lm_head"),
    }
    if not bert:
        tree["feature_extractor"] = {"conv_layers": conv_layers}
    if cfg.use_intermediate_ffn_before_adapter:
        tree["intermediate_ffn"] = ffn_pair("wav2vec2.intermediate_ffn")
    if cfg.add_adapter:
        first = "residual_conv" if bert else "conv"
        if not has(f"wav2vec2.adapter.layers.0.{first}.weight"):
            raise RuntimeBackendError(
                "load weights", "config has add_adapter=true but the checkpoint "
                f"carries no adapter weights (wav2vec2.adapter.layers.*.{first})")
        adapter = {}
        if has("wav2vec2.adapter.proj.weight"):
            adapter["proj"] = dense("wav2vec2.adapter.proj")
            adapter["proj_layer_norm"] = ln("wav2vec2.adapter.proj_layer_norm")
        if bert:
            adapter["layers"] = stacked("wav2vec2.adapter.layers.{}", lambda p: {
                "residual_layer_norm": ln(p + ".residual_layer_norm"),
                "residual_conv": glu_conv(p + ".residual_conv"),
                "self_attn_layer_norm": ln(p + ".self_attn_layer_norm"),
                "self_attn_conv": glu_conv(p + ".self_attn_conv"),
                "self_attn": {k: dense(f"{p}.self_attn.{k}") for k in _ATTENTION_PROJECTIONS},
                "ffn_layer_norm": ln(p + ".ffn_layer_norm"),
                "ffn": ffn_pair(p + ".ffn"),
            }, probe=".residual_conv.weight")
        else:
            adapter["layers"] = stacked("wav2vec2.adapter.layers.{}.conv", glu_conv)
        tree["adapter"] = adapter
    return tree


def params_from_flat_dict(
    tensors: dict[str, np.ndarray],
    cfg: Wav2Vec2ModelConfig,
    device: str | torch.device = "cpu",
    compute_weights_dtype: torch.dtype | None = None,
) -> dict:
    """Port parameters from a flat {hf_name: array} mapping (the HF names of
    every family the port runs). Folds the pos-conv weight norm (both
    `weight_g` layouts, and the newer torch parametrization names) and the
    BatchNorms. `compute_weights_dtype=torch.bfloat16` stores the compute
    weights in bf16."""
    params = params_from_jax(_jax_tree_from_flat_dict(tensors, cfg), device)
    if compute_weights_dtype == torch.bfloat16:
        params = cast_compute_weights_bf16(params)
    elif compute_weights_dtype not in (None, torch.float32):
        raise ValueError(f"unsupported compute_weights_dtype {compute_weights_dtype}")
    return params


def load_safetensors_params(
    path: str | Path,
    cfg: Wav2Vec2ModelConfig,
    device: str | torch.device = "cpu",
    compute_weights_dtype: torch.dtype | None = None,
) -> dict:
    """Load an HF safetensors checkpoint with the port's own reader."""
    return params_from_flat_dict(
        load_safetensors(path), cfg, device=device,
        compute_weights_dtype=compute_weights_dtype,
    )


def params_to_hf_flat_dict(params: dict, cfg: Wav2Vec2ModelConfig,
                           model_type: str | None = None) -> dict[str, np.ndarray]:
    """Port parameters (torch tensors or numpy arrays, JAX layout) → flat
    HF-named f32 arrays under `model_type`'s model prefix (`hubert.`,
    `wavlm.`, ...; by default the one of the config's encoder: `wav2vec2.`,
    `wav2vec2_conformer.`, `data2vec_audio.`, `wavlm.`, `sew.`, `sew_d.` or
    `wav2vec2_bert.`). Linear kernels go back to torch's [out, in]. The
    single pos-conv is written weight-normed (`weight_g` of shape (1, 1, K),
    `weight_v`), the layout wav2vec2-base and SEW checkpoints ship, except
    under mHuBERT's BatchNorm, where HF keeps a plain conv `weight`;
    data2vec's stack as plain convs. The conformers' pointwise convs go
    back to [out, in, 1]. Folded BatchNorms are written with running mean 0
    and variance 1 (weight = scale·sqrt(1 + eps), bias = shift), which the
    loader folds back. WavLM's bias embedding goes back to layer 0's
    attention; SEW's feature LayerNorm and projection to the model level;
    SEW-D's layers to DeBERTa's names."""
    out: dict[str, np.ndarray] = {}
    conformer = cfg.encoder_style in ("conformer", "conformer_bert")
    if model_type is None:
        model_type = ("wav2vec2-bert" if cfg.encoder_style == "conformer_bert"
                      else "wav2vec2-conformer" if conformer
                      else "sew-d" if cfg.attention_style == "deberta"
                      else "sew" if cfg.encoder_style == "sew"
                      else "wavlm" if cfg.attention_style == "wavlm"
                      else "data2vec-audio" if cfg.pos_conv_style == "data2vec"
                      else "wav2vec2")
    model = HF_PREFIXES[model_type]

    def arr(x):
        if isinstance(x, torch.Tensor):
            x = x.detach().float().cpu().numpy()
        return np.ascontiguousarray(np.asarray(x, dtype=np.float32))

    def put_dense(prefix, p):
        out[prefix + ".weight"] = arr(arr(p["kernel"]).T)
        out[prefix + ".bias"] = arr(p["bias"])

    def put_ln(prefix, p):
        out[prefix + ".weight"] = arr(p["weight"])
        out[prefix + ".bias"] = arr(p["bias"])

    def put_ffn(prefix, p):
        for k in ("intermediate_dense", "output_dense"):
            put_dense(f"{prefix}.{k}", p[k])

    def put_conv(prefix, p):
        out[prefix + ".weight"] = arr(p["weight"])
        out[prefix + ".bias"] = arr(p["bias"])

    def put_batch_norm(prefix, p):
        shift = arr(p["shift"])
        out[prefix + ".weight"] = arr(arr(p["scale"]).astype(np.float64)
                                      * np.sqrt(1.0 + BATCH_NORM_EPS))
        out[prefix + ".bias"] = shift
        out[prefix + ".running_mean"] = np.zeros_like(shift)
        out[prefix + ".running_var"] = np.ones_like(shift)

    def at(tree, i):
        return {n: (at(v, i) if isinstance(v, dict) else v[i]) for n, v in tree.items()}

    for i, layer in enumerate(params.get("feature_extractor", {}).get("conv_layers", [])):
        p = f"{model}feature_extractor.conv_layers.{i}"
        out[p + ".conv.weight"] = arr(layer["conv"]["weight"])
        if "bias" in layer["conv"]:
            out[p + ".conv.bias"] = arr(layer["conv"]["bias"])
        if "layer_norm" in layer:
            put_ln(p + ".layer_norm", layer["layer_norm"])
    fp = params["feature_projection"]
    if cfg.encoder_style == "sew":
        put_ln(f"{model}layer_norm", fp["layer_norm"])
        if "projection" in fp:
            put_dense(f"{model}feature_projection", fp["projection"])
    else:
        if "layer_norm" in fp:
            put_ln(f"{model}feature_projection.layer_norm", fp["layer_norm"])
        put_dense(f"{model}feature_projection.projection", fp["projection"])

    enc = params["encoder"]
    pos, pos_p = enc.get("pos_conv_embed"), f"{model}encoder.pos_conv_embed"
    if pos is not None and "layers" in pos:
        for i in range(len(pos["layers"]["weight"])):
            put_conv(f"{pos_p}.layers.{i}.conv", at(pos["layers"], i))
    elif pos is not None:
        w = arr(pos["weight"])
        if "batch_norm" in pos:
            out[pos_p + ".conv.weight"] = w
            put_batch_norm(pos_p + ".batch_norm", pos["batch_norm"])
        else:
            out[pos_p + ".conv.weight_g"] = np.sqrt(np.sum(w * w, axis=(0, 1), keepdims=True))
            out[pos_p + ".conv.weight_v"] = w
        out[pos_p + ".conv.bias"] = arr(pos["bias"])
    if "layer_norm" in enc:
        put_ln(f"{model}encoder.layer_norm", enc["layer_norm"])
    if "rel_attn_embed" in enc:
        out[f"{model}encoder.layers.0.attention.rel_attn_embed.weight"] = \
            arr(enc["rel_attn_embed"])
    if "upsample" in enc:
        put_dense(f"{model}encoder.upsample.projection", enc["upsample"]["projection"])
    if "rel_embeddings" in enc:
        out[f"{model}encoder.encoder.rel_embeddings.weight"] = arr(enc["rel_embeddings"])
        if "rel_embeddings_layer_norm" in enc:
            put_ln(f"{model}encoder.encoder.LayerNorm", enc["rel_embeddings_layer_norm"])
    for i in range(cfg.num_hidden_layers):
        lp = at(enc["layers"], i)
        p = f"{model}encoder.layers.{i}"
        if "attention" in lp and "query_proj" in lp["attention"]:
            att, p = lp["attention"], f"{model}encoder.encoder.layer.{i}"
            for ours, theirs in (("query_proj", "self.query_proj"),
                                 ("key_proj", "self.key_proj"),
                                 ("value_proj", "self.value_proj"),
                                 ("output_dense", "output.dense")):
                put_dense(f"{p}.attention.{theirs}", att[ours])
            put_ln(f"{p}.attention.output.LayerNorm", att["output_norm"])
            put_dense(f"{p}.intermediate.dense", lp["intermediate_dense"])
            put_dense(f"{p}.output.dense", lp["output_dense"])
            put_ln(f"{p}.output.LayerNorm", lp["output_norm"])
            continue
        if not conformer:
            att = lp["attention"]
            for k in _ATTENTION_KEYS:
                put_dense(f"{p}.attention.{k}", att[k])
            if "gru_rel_pos_const" in att:
                out[f"{p}.attention.gru_rel_pos_const"] = arr(att["gru_rel_pos_const"])
                put_dense(f"{p}.attention.gru_rel_pos_linear", att["gru_rel_pos_linear"])
            put_ffn(f"{p}.feed_forward", lp["feed_forward"])
            for k in ("layer_norm", "final_layer_norm"):
                put_ln(f"{p}.{k}", lp[k])
            if "adapter_layer" in lp:
                a = lp["adapter_layer"]
                put_ln(f"{p}.adapter_layer.norm", a["norm"])
                for k in ("linear_1", "linear_2"):
                    put_dense(f"{p}.adapter_layer.{k}", a[k])
            continue
        sa = lp["self_attn"]
        for k in _ATTENTION_PROJECTIONS:
            put_dense(f"{p}.self_attn.{k}", sa[k])
        if "linear_pos" in sa:
            out[f"{p}.self_attn.linear_pos.weight"] = arr(arr(sa["linear_pos"]["kernel"]).T)
            out[f"{p}.self_attn.pos_bias_u"] = arr(sa["pos_bias_u"])
            out[f"{p}.self_attn.pos_bias_v"] = arr(sa["pos_bias_v"])
        if "distance_embedding" in sa:
            out[f"{p}.self_attn.distance_embedding.weight"] = arr(sa["distance_embedding"])
        for ffn in ("ffn1", "ffn2"):
            put_ffn(f"{p}.{ffn}", lp[ffn])
        for k in ("ffn1_layer_norm", "self_attn_layer_norm", "ffn2_layer_norm",
                  "final_layer_norm"):
            put_ln(f"{p}.{k}", lp[k])
        cm, cp = lp["conv_module"], f"{p}.conv_module"
        put_ln(cp + ".layer_norm", cm["layer_norm"])
        for k in ("pointwise_conv1", "pointwise_conv2"):
            out[f"{cp}.{k}.weight"] = arr(arr(cm[k]["kernel"]).T[:, :, None])
        out[cp + ".depthwise_conv.weight"] = arr(cm["depthwise_conv"]["weight"])
        if "depthwise_layer_norm" in cm:
            put_ln(cp + ".depthwise_layer_norm", cm["depthwise_layer_norm"])
        else:
            put_batch_norm(cp + ".batch_norm", cm["batch_norm"])
    if "intermediate_ffn" in params:
        put_ffn(f"{model}intermediate_ffn", params["intermediate_ffn"])
    if "adapter" in params:
        ad = params["adapter"]
        if "proj" in ad:
            put_dense(f"{model}adapter.proj", ad["proj"])
            put_ln(f"{model}adapter.proj_layer_norm", ad["proj_layer_norm"])
        layers = ad["layers"]
        bert = "residual_conv" in layers
        for i in range(len(layers["residual_conv"]["weight"] if bert else layers["weight"])):
            p = f"{model}adapter.layers.{i}"
            if not bert:
                put_conv(p + ".conv", at(layers, i))
                continue
            lp = at(layers, i)
            for k in ("residual_layer_norm", "self_attn_layer_norm", "ffn_layer_norm"):
                put_ln(f"{p}.{k}", lp[k])
            for k in ("residual_conv", "self_attn_conv"):
                put_conv(f"{p}.{k}", lp[k])
            for k in _ATTENTION_PROJECTIONS:
                put_dense(f"{p}.self_attn.{k}", lp["self_attn"][k])
            put_ffn(f"{p}.ffn", lp["ffn"])
    put_dense("lm_head", params["lm_head"])
    return out
