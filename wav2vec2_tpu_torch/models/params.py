"""Model parameters: random init, the converter from the JAX pytree, and
the HF safetensors loader.

The port keeps the JAX package's parameter tree (`wav2vec2_tpu.models.
params`) as nested dicts of torch tensors: linear kernels stored [in, out],
conv weights [O, I/G, K], encoder layers stacked on a leading L axis, the
pos-conv weight norm folded into a plain conv weight, the conformer's
kernel-1 pointwise convs as [in, out] kernels and its BatchNorm folded to a
per-channel affine. So the converter from a JAX pytree is a leaf-by-leaf
copy, and a test can run both packages on the same weights. Two families:
wav2vec2 (post-norm, group-norm frontend) and wav2vec2-conformer.
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
_ENCODER_KEYS = {"pos_conv_embed", "layer_norm", "layers"}
_LAYER_KEYS = {"attention", "layer_norm", "feed_forward", "final_layer_norm"}
_CONFORMER_ENCODER_KEYS = {"layer_norm", "layers"}
_CONFORMER_LAYER_KEYS = {"ffn1_layer_norm", "ffn1", "self_attn_layer_norm", "self_attn",
                         "conv_module", "ffn2_layer_norm", "ffn2", "final_layer_norm"}
_ATTENTION_PROJECTIONS = ("linear_q", "linear_k", "linear_v", "linear_out")
_REL_POS_KEYS = {"linear_pos", "pos_bias_u", "pos_bias_v"}
_CONV_MODULE_KEYS = {"layer_norm", "pointwise_conv1", "depthwise_conv", "batch_norm",
                     "pointwise_conv2"}
# subtrees consumed in f32 whatever the compute dtype
_KEEP_F32_KEYS = {"layer_norm", "final_layer_norm", "ffn1_layer_norm",
                  "ffn2_layer_norm", "self_attn_layer_norm", "batch_norm"}
BATCH_NORM_EPS = 1e-5  # torch BatchNorm1d's default, folded in at load
_HF_PREFIX = {"wav2vec2": "wav2vec2.", "conformer": "wav2vec2_conformer."}

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
        return {
            "attention": {k: dense(h, h)
                          for k in ("q_proj", "k_proj", "v_proj", "out_proj")},
            "layer_norm": ln(h),
            "feed_forward": {"intermediate_dense": dense(h, ffn),
                             "output_dense": dense(ffn, h)},
            "final_layer_norm": ln(h),
        }

    def conformer_layer():
        k = cfg.conv_depthwise_kernel_size
        self_attn = {name: dense(h, h) for name in _ATTENTION_PROJECTIONS}
        if cfg.position_embeddings_type == "relative":
            self_attn["linear_pos"] = {"kernel": normal((h, h), (1.0 / h) ** 0.5)}
            self_attn["pos_bias_u"] = np.zeros((nh, h // nh), np.float32)
            self_attn["pos_bias_v"] = np.zeros((nh, h // nh), np.float32)
        return {
            "ffn1_layer_norm": ln(h),
            "ffn1": {"intermediate_dense": dense(h, ffn), "output_dense": dense(ffn, h)},
            "self_attn_layer_norm": ln(h),
            "self_attn": self_attn,
            "conv_module": {
                "layer_norm": ln(h),
                "pointwise_conv1": {"kernel": normal((h, 2 * h), (1.0 / h) ** 0.5)},
                "depthwise_conv": {"weight": normal((h, 1, k), (1.0 / k) ** 0.5)},
                # BatchNorm running stats fold to an identity affine at init
                "batch_norm": {"scale": np.ones((h,), np.float32),
                               "shift": np.zeros((h,), np.float32)},
                "pointwise_conv2": {"kernel": normal((h, h), (1.0 / h) ** 0.5)},
            },
            "ffn2_layer_norm": ln(h),
            "ffn2": {"intermediate_dense": dense(h, ffn), "output_dense": dense(ffn, h)},
            "final_layer_norm": ln(h),
        }

    conformer = cfg.encoder_style == "conformer"
    layer = conformer_layer if conformer else enc_layer
    layers = _stack([layer() for _ in range(cfg.num_hidden_layers)])
    # drawn in this order so that a seed gives the weights it gave before
    # the conformer was added
    feature_projection = {"layer_norm": ln(cfg.conv_dim[-1]),
                          "projection": dense(cfg.conv_dim[-1], h)}
    encoder = {"layer_norm": ln(h), "layers": layers}
    if not conformer:  # the conformer encoder has no positional conv
        encoder["pos_conv_embed"] = {
            "weight": normal((h, h // g, kpos), (1.0 / (h // g * kpos)) ** 0.5),
            "bias": np.zeros((h,), np.float32),
        }
    return {
        "feature_extractor": {"conv_layers": conv_layers},
        "feature_projection": feature_projection,
        "encoder": encoder,
        "lm_head": dense(h, cfg.vocab_size),
    }


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


def _check_tree(tree: dict) -> None:
    """Refuse a tree that is neither the wav2vec2 nor the conformer layout
    (attention adapters, WavLM biases, w2v-BERT blocks, ...): its extra
    subtrees would otherwise be silently ignored."""
    _check_keys(tree, _TOP_KEYS, "params")
    enc = tree["encoder"]
    if "self_attn" not in enc["layers"]:
        _check_keys(enc, _ENCODER_KEYS, "params['encoder']")
        _check_keys(enc["layers"], _LAYER_KEYS, "encoder layers")
        return
    _check_keys(enc, _CONFORMER_ENCODER_KEYS, "params['encoder']")
    layers = enc["layers"]
    _check_keys(layers, _CONFORMER_LAYER_KEYS, "conformer layers")
    attn = set(_ATTENTION_PROJECTIONS)
    if "linear_pos" in layers["self_attn"]:
        attn |= _REL_POS_KEYS
    _check_keys(layers["self_attn"], attn, "conformer self_attn")
    _check_keys(layers["conv_module"], _CONV_MODULE_KEYS, "conformer conv_module")


def params_from_jax(
    tree: dict, device: str | torch.device = "cpu",
    dtype: torch.dtype = torch.float32,
) -> dict:
    """JAX parameter pytree (numpy arrays, or anything `np.asarray` takes)
    → the port's tree of torch tensors on `device`. The key set is checked
    per family (wav2vec2 or conformer, told apart by the layers' keys):
    trees of families the port does not run yet are refused."""
    _check_tree(tree)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [convert(v) for v in node]
        arr = np.asarray(node, dtype=np.float32)
        return torch.tensor(arr, dtype=dtype, device=device)

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
    bf16 and keep the LayerNorm/GroupNorm parameters in f32, as
    `wav2vec2_tpu.models.quantize.cast_compute_weights_bf16` does. Under
    bf16 compute every consumption site casts weights to the activation
    dtype anyway, so this only halves the weight memory."""

    def walk(node):
        if isinstance(node, dict):
            return {k: (v if k in _KEEP_F32_KEYS else walk(v))
                    for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node.to(torch.bfloat16) if node.dtype == torch.float32 else node

    return walk(params)


def _jax_tree_from_flat_dict(tensors: dict[str, np.ndarray], cfg) -> dict:
    """HF names → JAX-layout numpy tree (wav2vec2 or conformer graph).
    Conformer checkpoints name their model `wav2vec2_conformer.`; their
    unused positional conv weights, if present, are never read."""
    t = {}
    for name, a in tensors.items():
        if name.startswith(_HF_PREFIX["conformer"]):
            name = "wav2vec2." + name[len(_HF_PREFIX["conformer"]):]
        t[_POS_CONV_ALIASES.get(name, name)] = np.asarray(a)

    def get(name):
        if name not in t:
            raise RuntimeBackendError("load weights", f"missing tensor {name!r}")
        return np.asarray(t[name], dtype=np.float32)

    def dense(prefix):
        return {"kernel": get(prefix + ".weight").T, "bias": get(prefix + ".bias")}

    def ln(prefix):
        return {"weight": get(prefix + ".weight"), "bias": get(prefix + ".bias")}

    conv_layers = []
    for i in range(len(cfg.conv_dim)):
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
        return {
            "attention": {k: dense(f"{p}.attention.{k}")
                          for k in ("q_proj", "k_proj", "v_proj", "out_proj")},
            "layer_norm": ln(p + ".layer_norm"),
            "feed_forward": {
                "intermediate_dense": dense(p + ".feed_forward.intermediate_dense"),
                "output_dense": dense(p + ".feed_forward.output_dense"),
            },
            "final_layer_norm": ln(p + ".final_layer_norm"),
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
        cm = f"{p}.conv_module"
        # inference BatchNorm folds to a per-channel affine
        scale = get(cm + ".batch_norm.weight") / np.sqrt(
            get(cm + ".batch_norm.running_var") + BATCH_NORM_EPS)
        shift = get(cm + ".batch_norm.bias") - get(cm + ".batch_norm.running_mean") * scale
        return {
            "ffn1_layer_norm": ln(p + ".ffn1_layer_norm"),
            "ffn1": {"intermediate_dense": dense(p + ".ffn1.intermediate_dense"),
                     "output_dense": dense(p + ".ffn1.output_dense")},
            "self_attn_layer_norm": ln(p + ".self_attn_layer_norm"),
            "self_attn": self_attn,
            "conv_module": {
                "layer_norm": ln(cm + ".layer_norm"),
                # kernel-1 convs [out, in, 1] fold to [in, out] matmul kernels
                "pointwise_conv1": {"kernel": get(cm + ".pointwise_conv1.weight")[:, :, 0].T},
                "depthwise_conv": {"weight": get(cm + ".depthwise_conv.weight")},
                "batch_norm": {"scale": scale.astype(np.float32),
                               "shift": shift.astype(np.float32)},
                "pointwise_conv2": {"kernel": get(cm + ".pointwise_conv2.weight")[:, :, 0].T},
            },
            "ffn2_layer_norm": ln(p + ".ffn2_layer_norm"),
            "ffn2": {"intermediate_dense": dense(p + ".ffn2.intermediate_dense"),
                     "output_dense": dense(p + ".ffn2.output_dense")},
            "final_layer_norm": ln(p + ".final_layer_norm"),
        }

    conformer = cfg.encoder_style == "conformer"
    layer = conformer_layer if conformer else enc_layer
    encoder = {"layer_norm": ln("wav2vec2.encoder.layer_norm"),
               "layers": _stack([layer(i) for i in range(cfg.num_hidden_layers)])}
    if not conformer:
        pos_p = "wav2vec2.encoder.pos_conv_embed.conv"
        if pos_p + ".weight_v" in t:
            pos_weight = fold_weight_norm(get(pos_p + ".weight_g"), get(pos_p + ".weight_v"))
        else:
            pos_weight = get(pos_p + ".weight")
        encoder["pos_conv_embed"] = {"weight": pos_weight, "bias": get(pos_p + ".bias")}
    return {
        "feature_extractor": {"conv_layers": conv_layers},
        "feature_projection": {
            "layer_norm": ln("wav2vec2.feature_projection.layer_norm"),
            "projection": dense("wav2vec2.feature_projection.projection"),
        },
        "encoder": encoder,
        "lm_head": dense("lm_head"),
    }


def params_from_flat_dict(
    tensors: dict[str, np.ndarray],
    cfg: Wav2Vec2ModelConfig,
    device: str | torch.device = "cpu",
    compute_weights_dtype: torch.dtype | None = None,
) -> dict:
    """Port parameters from a flat {hf_name: array} mapping (wav2vec2 or
    wav2vec2-conformer HF names). Folds the pos-conv weight norm (both
    `weight_g` layouts, and the newer torch parametrization names) and the
    conformer's BatchNorm. `compute_weights_dtype=torch.bfloat16` stores the
    compute weights in bf16."""
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


def params_to_hf_flat_dict(params: dict, cfg: Wav2Vec2ModelConfig) -> dict[str, np.ndarray]:
    """Port parameters (torch tensors or numpy arrays, JAX layout) → flat
    HF-named f32 arrays. Linear kernels go back to torch's [out, in]. The
    wav2vec2 pos-conv is written weight-normed (`weight_g` of shape
    (1, 1, K), `weight_v`), the layout wav2vec2-base checkpoints ship. The
    conformer's pointwise convs go back to [out, in, 1], and its folded
    BatchNorm is written with running mean 0 and variance 1 (weight =
    scale·sqrt(1 + eps), bias = shift), which the loader folds back."""
    out: dict[str, np.ndarray] = {}
    conformer = cfg.encoder_style == "conformer"
    model = _HF_PREFIX[cfg.encoder_style]

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

    def at(tree, i):
        return {n: (at(v, i) if isinstance(v, dict) else v[i]) for n, v in tree.items()}

    for i, layer in enumerate(params["feature_extractor"]["conv_layers"]):
        p = f"{model}feature_extractor.conv_layers.{i}"
        out[p + ".conv.weight"] = arr(layer["conv"]["weight"])
        if "bias" in layer["conv"]:
            out[p + ".conv.bias"] = arr(layer["conv"]["bias"])
        if "layer_norm" in layer:
            put_ln(p + ".layer_norm", layer["layer_norm"])
    fp = params["feature_projection"]
    put_ln(f"{model}feature_projection.layer_norm", fp["layer_norm"])
    put_dense(f"{model}feature_projection.projection", fp["projection"])

    enc = params["encoder"]
    if not conformer:
        w = arr(enc["pos_conv_embed"]["weight"])
        pos_p = "wav2vec2.encoder.pos_conv_embed.conv"
        out[pos_p + ".weight_g"] = np.sqrt(np.sum(w * w, axis=(0, 1), keepdims=True))
        out[pos_p + ".weight_v"] = w
        out[pos_p + ".bias"] = arr(enc["pos_conv_embed"]["bias"])
    put_ln(f"{model}encoder.layer_norm", enc["layer_norm"])
    for i in range(cfg.num_hidden_layers):
        lp = at(enc["layers"], i)
        p = f"{model}encoder.layers.{i}"
        if not conformer:
            for k in ("q_proj", "k_proj", "v_proj", "out_proj"):
                put_dense(f"{p}.attention.{k}", lp["attention"][k])
            for k in ("intermediate_dense", "output_dense"):
                put_dense(f"{p}.feed_forward.{k}", lp["feed_forward"][k])
            for k in ("layer_norm", "final_layer_norm"):
                put_ln(f"{p}.{k}", lp[k])
            continue
        sa = lp["self_attn"]
        for k in _ATTENTION_PROJECTIONS:
            put_dense(f"{p}.self_attn.{k}", sa[k])
        if "linear_pos" in sa:
            out[f"{p}.self_attn.linear_pos.weight"] = arr(arr(sa["linear_pos"]["kernel"]).T)
            out[f"{p}.self_attn.pos_bias_u"] = arr(sa["pos_bias_u"])
            out[f"{p}.self_attn.pos_bias_v"] = arr(sa["pos_bias_v"])
        for ffn in ("ffn1", "ffn2"):
            for k in ("intermediate_dense", "output_dense"):
                put_dense(f"{p}.{ffn}.{k}", lp[ffn][k])
        for k in ("ffn1_layer_norm", "self_attn_layer_norm", "ffn2_layer_norm",
                  "final_layer_norm"):
            put_ln(f"{p}.{k}", lp[k])
        cm, cp = lp["conv_module"], f"{p}.conv_module"
        put_ln(cp + ".layer_norm", cm["layer_norm"])
        for k in ("pointwise_conv1", "pointwise_conv2"):
            out[f"{cp}.{k}.weight"] = arr(arr(cm[k]["kernel"]).T[:, :, None])
        out[cp + ".depthwise_conv.weight"] = arr(cm["depthwise_conv"]["weight"])
        scale = arr(cm["batch_norm"]["scale"]).astype(np.float64)
        out[cp + ".batch_norm.weight"] = arr(scale * np.sqrt(1.0 + BATCH_NORM_EPS))
        out[cp + ".batch_norm.bias"] = arr(cm["batch_norm"]["shift"])
        out[cp + ".batch_norm.running_mean"] = np.zeros_like(arr(cm["batch_norm"]["shift"]))
        out[cp + ".batch_norm.running_var"] = np.ones_like(arr(cm["batch_norm"]["shift"]))
    put_dense("lm_head", params["lm_head"])
    return out
