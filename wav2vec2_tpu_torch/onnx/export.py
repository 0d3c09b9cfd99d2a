"""wav2vec2 CTC model → ONNX graph exporter.

Counterpart of `wav2vec2_tpu.onnx.export` (the analog of the reference's
scripts/export_ctc_model_to_onnx.py: dynamic batch/time axes, opset 17).
It builds an ONNX ModelProto for the `audio [B, N] f32 → logits [B, T, V]
f32` forward from the port's config and parameter tree, whose keys are the
JAX package's (`models/params.py`), with no torch.onnx or onnx dependency:
the in-repo protobuf codec (`onnx/proto.py`) writes it. Every leaf is first
copied to the host as f32 numpy; from there the graph is built node by node
as the JAX exporter builds it, so on the same f32 weights both packages
write the same bytes. Only primitive ONNX ops are emitted (Conv, MatMul,
LayerNormalization, InstanceNormalization, Softmax, Erf, elementwise,
Transpose/Reshape/Slice), so the file runs under stock onnxruntime and
under the port's session (`onnx/reference_runtime.py`).

Supported: the wav2vec2/HuBERT graph family — both norm orders
(do_stable_layer_norm), both feat_extract_norm modes, optional conv bias,
optional feature-projection LayerNorm, folded batch-norm pos-conv
(conv_pos_batch_norm). WavLM's gated rel-pos attention, data2vec's
pos-conv stack, MMS attention adapters, both conformers, SEW/SEW-D and
add_adapter conv stacks are declined with the JAX exporter's errors.

Precision: f32. Dynamic shapes use Reshape's 0/-1 dim semantics, so one
exported file serves any utterance length and the batch axis stays
symbolic.
"""

from __future__ import annotations

import math

import numpy as np

import torch

from ..config import Wav2Vec2ModelConfig
from ..errors import RuntimeBackendError
from .proto import (
    ATTR_FLOAT,
    ATTR_INT,
    ATTR_INTS,
    FLOAT,
    Attribute,
    Graph,
    Model,
    Node,
)


class _GraphBuilder:
    def __init__(self) -> None:
        self.graph = Graph()
        self._n = 0

    def tensor(self, name: str, array: np.ndarray) -> str:
        self.graph.initializers[name] = np.ascontiguousarray(array)
        return name

    def const_i64(self, name: str, values) -> str:
        return self.tensor(name, np.asarray(values, np.int64))

    def op(self, op_type: str, inputs: list[str], n_out: int = 1, **attrs) -> str:
        self._n += 1
        outputs = [f"{op_type.lower()}_{self._n}_{j}" for j in range(n_out)]
        attributes = {}
        for k, v in attrs.items():
            if isinstance(v, float):
                attributes[k] = Attribute(k, type=ATTR_FLOAT, f=v)
            elif isinstance(v, int):
                attributes[k] = Attribute(k, type=ATTR_INT, i=v)
            elif isinstance(v, (list, tuple)):
                attributes[k] = Attribute(k, type=ATTR_INTS, ints=list(v))
            else:
                raise TypeError(f"attribute {k}={v!r}")
        self.graph.nodes.append(
            Node(op_type=op_type, inputs=list(inputs), outputs=outputs,
                 name=f"{op_type}_{self._n}", attributes=attributes)
        )
        return outputs[0]

    def gelu(self, x: str) -> str:
        """erf-GELU from primitives: x * 0.5 * (1 + erf(x / sqrt(2)))."""
        sqrt2 = self.tensor(f"sqrt2_{self._n}", np.float32(math.sqrt(2.0)))
        half = self.tensor(f"half_{self._n}", np.float32(0.5))
        one = self.tensor(f"one_{self._n}", np.float32(1.0))
        e = self.op("Erf", [self.op("Div", [x, sqrt2])])
        return self.op("Mul", [self.op("Mul", [x, half]),
                               self.op("Add", [one, e])])

    def layer_norm(self, x: str, prefix: str, weight, bias, eps: float) -> str:
        w = self.tensor(f"{prefix}.weight", np.asarray(weight, np.float32))
        b = self.tensor(f"{prefix}.bias", np.asarray(bias, np.float32))
        return self.op("LayerNormalization", [x, w, b], axis=-1, epsilon=eps)

    def dense(self, x: str, prefix: str, p: dict) -> str:
        """[..., I] @ kernel [I, O] + bias — params store jax [in, out]
        kernels, which is MatMul's native layout."""
        k = self.tensor(f"{prefix}.kernel",
                        np.asarray(p["kernel"], np.float32))
        b = self.tensor(f"{prefix}.bias", np.asarray(p["bias"], np.float32))
        return self.op("Add", [self.op("MatMul", [x, k]), b])


def _host_f32(tree):
    """The tree with every float tensor copied to the host as f32 numpy."""
    if isinstance(tree, dict):
        return {k: _host_f32(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_host_f32(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().cpu()
        return tree.float().numpy() if tree.is_floating_point() else tree.numpy()
    return tree


def export_ctc_model(cfg: Wav2Vec2ModelConfig, params: dict) -> Model:
    """Build the ONNX ModelProto from the port's parameter tree (torch
    tensors on any device). Raises RuntimeBackendError for model families
    outside the reference exporter's scope."""
    if getattr(cfg, "attention_style", "wav2vec2") != "wav2vec2":
        raise RuntimeBackendError(
            "onnx export", "WavLM gated rel-pos attention is not part of the "
            "ONNX export surface; use the XLA backend for WavLM"
        )
    if getattr(cfg, "pos_conv_style", "wav2vec2") != "wav2vec2":
        raise RuntimeBackendError(
            "onnx export", "data2vec pos-conv stacks are not part of the "
            "ONNX export surface; use the XLA backend for data2vec"
        )
    if getattr(cfg, "adapter_attn_dim", None):
        raise RuntimeBackendError(
            "onnx export", "MMS attention adapters are not part of the ONNX "
            "export surface; use the XLA backend for MMS"
        )
    if getattr(cfg, "encoder_style", "wav2vec2") == "conformer":
        raise RuntimeBackendError(
            "onnx export", "conformer encoders are not part of the ONNX "
            "export surface; use the XLA backend for Wav2Vec2-Conformer"
        )
    if getattr(cfg, "encoder_style", "wav2vec2") == "conformer_bert":
        raise RuntimeBackendError(
            "onnx export", "the Wav2Vec2-BERT mel frontend + conformer "
            "encoder is not part of the ONNX export surface; use the XLA "
            "backend for w2v-BERT checkpoints"
        )
    if getattr(cfg, "encoder_style", "wav2vec2") != "wav2vec2":
        raise RuntimeBackendError(
            "onnx export", "SEW/SEW-D squeezed encoders are not part of the "
            "ONNX export surface; use the XLA backend for SEW"
        )
    if getattr(cfg, "add_adapter", False):
        raise RuntimeBackendError(
            "onnx export", "add_adapter conv stacks are not part of the ONNX "
            "export surface; use the XLA backend for adapter checkpoints"
        )

    params = _host_f32(params)
    g = _GraphBuilder()
    eps = float(cfg.layer_norm_eps)
    g.graph.add_input("audio", FLOAT, ["batch", "num_samples"])

    x = g.op("Unsqueeze", ["audio", g.const_i64("axes_c", [1])])  # [B,1,N]

    # conv feature extractor (feature_extractor.rs:7-140 semantics)
    fe = params["feature_extractor"]["conv_layers"]
    for i, (out_c, k, s) in enumerate(
        zip(cfg.conv_dim, cfg.conv_kernel, cfg.conv_stride)
    ):
        layer = fe[i]
        prefix = f"feature_extractor.conv_layers.{i}"
        conv_in = [x, g.tensor(f"{prefix}.conv.weight",
                               np.asarray(layer["conv"]["weight"], np.float32))]
        if "bias" in layer["conv"]:
            conv_in.append(g.tensor(
                f"{prefix}.conv.bias",
                np.asarray(layer["conv"]["bias"], np.float32)))
        x = g.op("Conv", conv_in, strides=[s], kernel_shape=[k])
        if cfg.feat_extract_norm == "layer":
            x = g.op("Transpose", [x], perm=[0, 2, 1])
            x = g.layer_norm(x, f"{prefix}.layer_norm",
                             layer["layer_norm"]["weight"],
                             layer["layer_norm"]["bias"], eps)
            x = g.op("Transpose", [x], perm=[0, 2, 1])
        elif cfg.feat_extract_norm == "group" and i == 0:
            # GroupNorm with groups == channels over time IS
            # InstanceNormalization (per-channel stats over L)
            w = g.tensor(f"{prefix}.layer_norm.weight",
                         np.asarray(layer["layer_norm"]["weight"], np.float32))
            b = g.tensor(f"{prefix}.layer_norm.bias",
                         np.asarray(layer["layer_norm"]["bias"], np.float32))
            x = g.op("InstanceNormalization", [x, w, b], epsilon=eps)
        x = g.gelu(x)

    x = g.op("Transpose", [x], perm=[0, 2, 1])  # [B, T, C_last]

    # feature projection
    fp = params["feature_projection"]
    if "layer_norm" in fp:
        x = g.layer_norm(x, "feature_projection.layer_norm",
                         fp["layer_norm"]["weight"],
                         fp["layer_norm"]["bias"], eps)
    x = g.dense(x, "feature_projection.projection", fp["projection"])

    # pos-conv embedding (weight-norm already folded in the params pytree)
    enc = params["encoder"]
    pce = enc["pos_conv_embed"]
    pad = cfg.num_conv_pos_embeddings // 2
    pc_src = x
    if "batch_norm" in pce:
        # conv_pos_batch_norm (mHuBERT-147): the folded inference BatchNorm
        # is a per-channel affine on the conv input (models/params.py)
        pc_src = g.op(
            "Add",
            [g.op("Mul", [x, g.tensor(
                "encoder.pos_conv_embed.batch_norm.scale",
                np.asarray(pce["batch_norm"]["scale"], np.float32))]),
             g.tensor("encoder.pos_conv_embed.batch_norm.shift",
                      np.asarray(pce["batch_norm"]["shift"], np.float32))],
        )
    pc_in = g.op("Transpose", [pc_src], perm=[0, 2, 1])  # [B, H, T]
    pc = g.op(
        "Conv",
        [pc_in,
         g.tensor("encoder.pos_conv_embed.conv.weight",
                  np.asarray(pce["weight"], np.float32)),
         g.tensor("encoder.pos_conv_embed.conv.bias",
                  np.asarray(pce["bias"], np.float32))],
        strides=[1], pads=[pad, pad],
        kernel_shape=[int(cfg.num_conv_pos_embeddings)],
        group=int(cfg.num_conv_pos_embedding_groups),
    )
    if cfg.num_conv_pos_embeddings % 2 == 0:
        # even kernel → length T+1; drop the last frame (encoder.rs:31-37)
        pc = g.op("Slice", [pc, g.const_i64("sl_start", [0]),
                            g.const_i64("sl_end", [-1]),
                            g.const_i64("sl_axes", [2])])
    pc = g.op("Transpose", [pc], perm=[0, 2, 1])
    x = g.op("Add", [x, g.gelu(pc)])

    if not cfg.do_stable_layer_norm:
        # post-norm (wav2vec2-base): encoder-level LN BEFORE the layers
        # (HF order; see models/encoder.py docstring)
        x = g.layer_norm(x, "encoder.layer_norm",
                         enc["layer_norm"]["weight"],
                         enc["layer_norm"]["bias"], eps)

    stacked = enc["layers"]
    nh = int(cfg.num_attention_heads)
    hd = cfg.hidden_size // nh
    scale = g.tensor("attn_scale", np.float32(hd ** -0.5))
    split_shape = g.const_i64("attn_split", [0, 0, nh, hd])
    merge_shape = g.const_i64("attn_merge", [0, 0, int(cfg.hidden_size)])

    def layer_param(path: list[str], i: int) -> np.ndarray:
        p = stacked
        for key in path:
            p = p[key]
        return np.asarray(p[i], np.float32)

    def attention(x_in: str, i: int) -> str:
        pre = f"encoder.layers.{i}.attention"

        def proj(name: str, scaled: bool) -> str:
            k = g.tensor(f"{pre}.{name}.kernel",
                         layer_param(["attention", name, "kernel"], i))
            b = g.tensor(f"{pre}.{name}.bias",
                         layer_param(["attention", name, "bias"], i))
            h = g.op("Add", [g.op("MatMul", [x_in, k]), b])
            if scaled:
                # query pre-scaled by head_dim^-0.5 (encoder.rs:72)
                h = g.op("Mul", [h, scale])
            return g.op("Transpose",
                        [g.op("Reshape", [h, split_shape])],
                        perm=[0, 2, 1, 3])

        q = proj("q_proj", scaled=True)
        k_ = proj("k_proj", scaled=False)
        v = proj("v_proj", scaled=False)
        scores = g.op("MatMul", [q, g.op("Transpose", [k_], perm=[0, 1, 3, 2])])
        attn = g.op("Softmax", [scores], axis=-1)
        ctx = g.op("MatMul", [attn, v])
        ctx = g.op("Reshape",
                   [g.op("Transpose", [ctx], perm=[0, 2, 1, 3]), merge_shape])
        ok = g.tensor(f"{pre}.out_proj.kernel",
                      layer_param(["attention", "out_proj", "kernel"], i))
        ob = g.tensor(f"{pre}.out_proj.bias",
                      layer_param(["attention", "out_proj", "bias"], i))
        return g.op("Add", [g.op("MatMul", [ctx, ok]), ob])

    def feed_forward(x_in: str, i: int) -> str:
        pre = f"encoder.layers.{i}.feed_forward"
        up = g.op("Add", [
            g.op("MatMul", [x_in, g.tensor(
                f"{pre}.intermediate_dense.kernel",
                layer_param(["feed_forward", "intermediate_dense", "kernel"], i))]),
            g.tensor(f"{pre}.intermediate_dense.bias",
                     layer_param(["feed_forward", "intermediate_dense", "bias"], i)),
        ])
        up = g.gelu(up)
        return g.op("Add", [
            g.op("MatMul", [up, g.tensor(
                f"{pre}.output_dense.kernel",
                layer_param(["feed_forward", "output_dense", "kernel"], i))]),
            g.tensor(f"{pre}.output_dense.bias",
                     layer_param(["feed_forward", "output_dense", "bias"], i)),
        ])

    def ln(x_in: str, i: int, which: str) -> str:
        return g.layer_norm(
            x_in, f"encoder.layers.{i}.{which}",
            layer_param([which, "weight"], i), layer_param([which, "bias"], i),
            eps,
        )

    for i in range(cfg.num_hidden_layers):
        if cfg.do_stable_layer_norm:
            # pre-norm: h = x + attn(ln1(x)); y = h + ff(ln2(h))
            h = g.op("Add", [x, attention(ln(x, i, "layer_norm"), i)])
            x = g.op("Add", [h, feed_forward(ln(h, i, "final_layer_norm"), i)])
        else:
            # post-norm: h = ln1(x + attn(x)); y = ln2(h + ff(h))
            h = ln(g.op("Add", [x, attention(x, i)]), i, "layer_norm")
            x = ln(g.op("Add", [h, feed_forward(h, i)]), i, "final_layer_norm")

    if cfg.do_stable_layer_norm:
        x = g.layer_norm(x, "encoder.layer_norm",
                         enc["layer_norm"]["weight"],
                         enc["layer_norm"]["bias"], eps)

    g.dense(x, "lm_head", params["lm_head"])
    # the dense helper names its output internally; re-emit under "logits"
    g.graph.nodes[-1].outputs[0] = "logits"
    g.graph.add_output("logits", FLOAT, ["batch", "time", int(cfg.vocab_size)])
    g.graph.name = "wav2vec2_ctc"
    return Model(graph=g.graph)
