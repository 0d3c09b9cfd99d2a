"""wav2vec2 with post-norm layers (wav2vec2-base): a grouped positional
conv (SamePad drops the last frame of an even kernel, GELU) added to the
input, the encoder LayerNorm, then h = LN(x + attn(x)), y = LN(h + FFN(h))."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..forward import layer, linear, ln, mm
from . import dense, ffn, norm, stacked, under


def _attention(p, x, nh, quant):
    t, h = x.shape
    hd = h // nh
    q = (linear(x, p["q_proj"], quant) * hd ** -0.5).reshape(t, nh, hd).transpose(0, 1)
    k = linear(x, p["k_proj"], quant).reshape(t, nh, hd).transpose(0, 1)
    v = linear(x, p["v_proj"], quant).reshape(t, nh, hd).transpose(0, 1)
    out = mm(torch.softmax(mm(q, k.transpose(1, 2), quant), dim=-1), v, quant)
    return linear(out.transpose(0, 1).reshape(t, h), p["out_proj"], quant)


def encoder(enc, x, cfg, quant):
    if cfg.get("do_stable_layer_norm"):
        raise NotImplementedError("no reference forward for pre-norm wav2vec2")
    eps = cfg.get("layer_norm_eps", 1e-5)
    pos = enc["pos_conv_embed"]
    k, g = cfg["num_conv_pos_embeddings"], cfg["num_conv_pos_embedding_groups"]
    y = F.conv1d(x.transpose(0, 1)[None], pos["weight"], pos["bias"], padding=k // 2, groups=g)
    if k % 2 == 0:
        y = y[..., :-1]
    x = x + F.gelu(y[0].transpose(0, 1))
    x = ln(x, enc["layer_norm"], eps)
    for i in range(cfg["num_hidden_layers"]):
        lp = layer(enc["layers"], i)
        h = ln(x + _attention(lp["attention"], x, cfg["num_attention_heads"], quant),
               lp["layer_norm"], eps)
        ff = lp["feed_forward"]
        up = F.gelu(linear(h, ff["intermediate_dense"], quant))
        x = ln(h + linear(up, ff["output_dense"], quant), lp["final_layer_norm"], eps)
    return x


def encoder_leaves(cfg):
    h = cfg["hidden_size"]
    lay = []
    for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
        lay += under(("attention", name), dense(h, h))
    lay += under("layer_norm", norm(h))
    lay += under("feed_forward", ffn(h, cfg["intermediate_size"]))
    lay += under("final_layer_norm", norm(h))
    g, kpos = cfg["num_conv_pos_embedding_groups"], cfg["num_conv_pos_embeddings"]
    return (stacked(cfg["num_hidden_layers"], lay) + under("layer_norm", norm(h))
            + [(("pos_conv_embed", "weight"), (h, h // g, kpos),
                ((1.0 / (h // g * kpos)) ** 0.5, 0.0)),
               (("pos_conv_embed", "bias"), (h,), (0.2, 0.0))])


def encoder_flops(cfg, t):
    """The positional conv, then per layer the four projections, attention
    at T (q·kᵀ and P·V) and the FFN."""
    h, inner = cfg["hidden_size"], cfg["intermediate_size"]
    g, kpos = cfg["num_conv_pos_embedding_groups"], cfg["num_conv_pos_embeddings"]
    per_layer = 2.0 * t * 4 * h * h + 4.0 * t * t * h + 2.0 * t * 2 * h * inner
    return 2.0 * t * h * (h // g) * kpos + cfg["num_hidden_layers"] * per_layer
