"""The wav2vec2 conformer with relative positions: per block FFN/2 →
Transformer-XL relative self-attention → conv module (pointwise, GLU,
depthwise, BatchNorm as an affine, swish, pointwise) → FFN/2 → LayerNorm;
the encoder LayerNorm last. The position term is taken the way transformers
writes it: sinusoids of every relative position r = i − k, projected by
`linear_pos`, one column gathered per (query, key) pair."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..forward import layer, linear, ln, mm
from . import dense, ffn, norm, stacked, under


def _rel_positions(t, h, device):
    """Sinusoids of the relative positions T−1, T−2, …, −(T−1) [2T−1, H]:
    sin at the even columns, cos at the odd ones (f64, then f32)."""
    r = torch.arange(t - 1, -t, -1, dtype=torch.float64, device=device)[:, None]
    div = torch.exp(torch.arange(0, h, 2, dtype=torch.float64, device=device)
                    * (-math.log(10000.0) / h))
    pe = torch.zeros(2 * t - 1, h, dtype=torch.float64, device=device)
    pe[:, 0::2] = torch.sin(r * div)
    pe[:, 1::2] = torch.cos(r * div)
    return pe.float()


def _rel_attention(p, x, nh, quant):
    t, h = x.shape
    hd = h // nh
    q = linear(x, p["linear_q"], quant).reshape(t, nh, hd).transpose(0, 1)
    k = linear(x, p["linear_k"], quant).reshape(t, nh, hd).transpose(0, 1)
    v = linear(x, p["linear_v"], quant).reshape(t, nh, hd).transpose(0, 1)
    pos = mm(_rel_positions(t, h, x.device), p["linear_pos"]["kernel"], quant)
    pos = pos.reshape(2 * t - 1, nh, hd).transpose(0, 1)  # [nh, 2T-1, hd]
    ac = mm(q + p["pos_bias_u"][:, None, :], k.transpose(1, 2), quant)
    bd_all = mm(q + p["pos_bias_v"][:, None, :], pos.transpose(1, 2), quant)  # [nh, T, 2T-1]
    i = torch.arange(t, device=x.device)
    col = (t - 1) - i[:, None] + i[None, :]  # the column of r = i - k
    bd = torch.gather(bd_all, 2, col[None].expand(nh, t, t))
    del bd_all
    attn = torch.softmax((ac + bd) / math.sqrt(hd), dim=-1)
    out = mm(attn, v, quant).transpose(0, 1).reshape(t, h)
    return linear(out, p["linear_out"], quant)


def _conv_module(p, x, kernel, quant):
    h = x.shape[-1]
    x = mm(ln(x, p["layer_norm"], 1e-5), p["pointwise_conv1"]["kernel"], quant)
    x = x[:, :h] * torch.sigmoid(x[:, h:])
    x = F.conv1d(x.transpose(0, 1)[None], p["depthwise_conv"]["weight"],
                 padding=(kernel - 1) // 2, groups=h)[0].transpose(0, 1)
    x = x * p["batch_norm"]["scale"] + p["batch_norm"]["shift"]
    return mm(F.silu(x), p["pointwise_conv2"]["kernel"], quant)


def encoder(enc, x, cfg, quant):
    if cfg.get("position_embeddings_type") != "relative":
        raise NotImplementedError("the reference conformer has relative positions only")
    nh = cfg["num_attention_heads"]

    def ffn_(fp, y):
        return linear(F.silu(linear(y, fp["intermediate_dense"], quant)), fp["output_dense"],
                      quant)

    for i in range(cfg["num_hidden_layers"]):
        lp = layer(enc["layers"], i)
        x = x + 0.5 * ffn_(lp["ffn1"], ln(x, lp["ffn1_layer_norm"], 1e-5))
        x = x + _rel_attention(lp["self_attn"], ln(x, lp["self_attn_layer_norm"], 1e-5), nh,
                               quant)
        x = x + _conv_module(lp["conv_module"], x, cfg["conv_depthwise_kernel_size"], quant)
        x = x + 0.5 * ffn_(lp["ffn2"], ln(x, lp["ffn2_layer_norm"], 1e-5))
        x = ln(x, lp["final_layer_norm"], 1e-5)
    return ln(x, enc["layer_norm"], cfg.get("layer_norm_eps", 1e-5))


def encoder_leaves(cfg):
    h, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    k = cfg["conv_depthwise_kernel_size"]
    lay = under("ffn1_layer_norm", norm(h)) + under("ffn1", ffn(h, cfg["intermediate_size"]))
    lay += under("self_attn_layer_norm", norm(h))
    for name in ("linear_q", "linear_k", "linear_v", "linear_out"):
        lay += under(("self_attn", name), dense(h, h))
    lay += [(("self_attn", "linear_pos", "kernel"), (h, h), ((1.0 / h) ** 0.5, 0.0)),
            (("self_attn", "pos_bias_u"), (nh, h // nh), (0.2, 0.0)),
            (("self_attn", "pos_bias_v"), (nh, h // nh), (0.2, 0.0))]
    conv = under("layer_norm", norm(h))
    conv += [(("pointwise_conv1", "kernel"), (h, 2 * h), ((1.0 / h) ** 0.5, 0.0)),
             (("depthwise_conv", "weight"), (h, 1, k), ((1.0 / k) ** 0.5, 0.0)),
             (("batch_norm", "scale"), (h,), (0.2, 1.0)),
             (("batch_norm", "shift"), (h,), (0.2, 0.0)),
             (("pointwise_conv2", "kernel"), (h, h), ((1.0 / h) ** 0.5, 0.0))]
    lay += under("conv_module", conv)
    lay += under("ffn2_layer_norm", norm(h)) + under("ffn2", ffn(h, cfg["intermediate_size"]))
    lay += under("final_layer_norm", norm(h))
    return stacked(cfg["num_hidden_layers"], lay) + under("layer_norm", norm(h))


def encoder_flops(cfg, t):
    """Per block the four projections, attention at T (q·kᵀ and P·V), two
    FFNs, the position term (the projection of the 2T − 1 relative
    positions and one q·p a query-key pair) and the conv module."""
    h, inner = cfg["hidden_size"], cfg["intermediate_size"]
    k_dw = cfg["conv_depthwise_kernel_size"]
    proj = 2.0 * t * 4 * h * h
    attn = 4.0 * t * t * h
    ffns = 2 * (2.0 * t * 2 * h * inner)
    pos = 2.0 * (2 * t - 1) * h * h + 2.0 * t * t * h
    conv = 2.0 * t * h * 2 * h + 2.0 * t * h * k_dw + 2.0 * t * h * h
    return cfg["num_hidden_layers"] * (proj + attn + ffns + pos + conv)
