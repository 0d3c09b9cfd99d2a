"""wav2vec2 transformer encoder, post-norm (wav2vec2-base) style.

PyTorch counterpart of the wav2vec2 path of `wav2vec2_tpu.models.encoder`:

- positional conv: grouped Conv1d (kernel num_conv_pos_embeddings, pad K/2,
  groups num_conv_pos_embedding_groups) with the weight norm folded at load
  time; an even kernel gives one extra frame, which is dropped; GELU;
  residual add;
- encoder LayerNorm after the pos-conv residual and BEFORE the layers;
- per layer: h = LN1(x + attn(x)); y = LN2(h + FFN(h)).

Attention is plain `matmul` + softmax, which XLA computed without Pallas.
The layers are stacked on a leading L axis (the JAX layout) and run as a
Python loop over that axis.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import Wav2Vec2ModelConfig
from .layers import gelu, layer_norm, linear


def pos_conv_forward(
    params: dict, x: torch.Tensor, cfg: Wav2Vec2ModelConfig
) -> torch.Tensor:
    """x [B, T, H] → positional embeddings [B, T, H]."""
    seq_len = x.shape[1]
    k = cfg.num_conv_pos_embeddings
    w = params["weight"].to(x.dtype)
    if x.device.type == "cpu" and x.dtype != torch.float32:
        # oneDNN's CPU bf16 grouped conv returns wrong values (errors of the
        # order of the outputs); take the same bf16 operands through the f32
        # conv and round once, which is what the GPU conv computes
        h = F.conv1d(x.transpose(1, 2).float(), w.float(), None, padding=k // 2,
                     groups=cfg.num_conv_pos_embedding_groups).to(x.dtype)
    else:
        h = F.conv1d(x.transpose(1, 2), w, None, padding=k // 2,
                     groups=cfg.num_conv_pos_embedding_groups)
    h = h.transpose(1, 2)
    if k % 2 == 0:
        # SamePad: an even kernel with pad K/2 gives one extra output
        # position; torch drops the last one
        h = h[:, :-1, :]
    if h.shape[1] != seq_len:
        raise AssertionError(f"pos-conv gave {h.shape[1]} frames, want {seq_len}")
    return gelu(h + params["bias"].to(x.dtype))


def _self_attention(
    p: dict, x: torch.Tensor, mask_bias: torch.Tensor | None, num_heads: int
) -> torch.Tensor:
    """Multi-head self-attention; q pre-scaled by head_dim**-0.5, additive
    key mask of 0 / -inf.

    At f32 the scores are f32. At bf16 the [B, H, T, T] scores are stored in
    bf16, as the JAX bf16 path stores them (the GEMM accumulates in f32 and
    rounds once); the softmax takes bf16 in and gives bf16 out, and PyTorch
    evaluates it in f32 inside the kernel, where XLA evaluates it on the
    bf16 values."""
    b, t, h = x.shape
    head_dim = h // num_heads

    def split_heads(y):
        return y.reshape(b, t, num_heads, head_dim).transpose(1, 2)

    scale = torch.tensor(head_dim ** -0.5, dtype=x.dtype)
    q = split_heads(linear(x, p["q_proj"]["kernel"], p["q_proj"]["bias"]) * scale)
    k = split_heads(linear(x, p["k_proj"]["kernel"], p["k_proj"]["bias"]))
    v = split_heads(linear(x, p["v_proj"]["kernel"], p["v_proj"]["bias"]))
    scores = torch.matmul(q, k.transpose(-1, -2))
    if mask_bias is not None:
        scores = scores + mask_bias.to(scores.dtype)
    attn = torch.softmax(scores, dim=-1)
    out = torch.matmul(attn, v).transpose(1, 2).reshape(b, t, h)
    return linear(out, p["out_proj"]["kernel"], p["out_proj"]["bias"])


def _feed_forward(p: dict, x: torch.Tensor) -> torch.Tensor:
    up = gelu(linear(x, p["intermediate_dense"]["kernel"],
                     p["intermediate_dense"]["bias"]))
    return linear(up, p["output_dense"]["kernel"], p["output_dense"]["bias"])


def _encoder_layer(
    lp: dict, x: torch.Tensor, mask_bias: torch.Tensor | None,
    cfg: Wav2Vec2ModelConfig,
) -> torch.Tensor:
    """Post-norm layer: h = ln1(x + attn(x)); y = ln2(h + ff(h))."""
    eps = cfg.layer_norm_eps
    h = layer_norm(
        x + _self_attention(lp["attention"], x, mask_bias, cfg.num_attention_heads),
        lp["layer_norm"]["weight"], lp["layer_norm"]["bias"], eps,
    )
    return layer_norm(
        h + _feed_forward(lp["feed_forward"], h),
        lp["final_layer_norm"]["weight"], lp["final_layer_norm"]["bias"], eps,
    )


def _layer_slice(tree, i: int):
    """Layer i of a tree of tensors stacked on a leading L axis (views)."""
    if isinstance(tree, dict):
        return {k: _layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def encoder_forward(
    params: dict,
    x: torch.Tensor,
    cfg: Wav2Vec2ModelConfig,
    frame_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """x [B, T, H] → [B, T, H].

    `frame_mask` [B, T] (True = valid) zeroes padded frames before the
    pos-conv, masks attention keys, and re-zeroes padded frames after the
    encoder LayerNorm, so a padded batch equals the unpadded forward on the
    valid frames."""
    mask_bias = None
    if frame_mask is not None:
        x = x * frame_mask[:, :, None].to(x.dtype)
        mask_bias = torch.zeros(frame_mask.shape, dtype=torch.float32,
                                device=x.device)
        mask_bias = mask_bias.masked_fill(~frame_mask, float("-inf"))
        mask_bias = mask_bias[:, None, None, :]
    x = x + pos_conv_forward(params["pos_conv_embed"], x, cfg)
    enc_ln = params["layer_norm"]
    x = layer_norm(x, enc_ln["weight"], enc_ln["bias"], cfg.layer_norm_eps)
    if frame_mask is not None:
        x = x * frame_mask[:, :, None].to(x.dtype)
    for i in range(cfg.num_hidden_layers):
        x = _encoder_layer(_layer_slice(params["layers"], i), x, mask_bias, cfg)
    return x
