"""wav2vec2 transformer encoder (post-norm, wav2vec2-base style) and the
wav2vec2-conformer encoder.

PyTorch counterpart of the wav2vec2 and conformer paths of
`wav2vec2_tpu.models.encoder`. The wav2vec2 encoder:

- positional conv: grouped Conv1d (kernel num_conv_pos_embeddings, pad K/2,
  groups num_conv_pos_embedding_groups) with the weight norm folded at load
  time; an even kernel gives one extra frame, which is dropped; GELU;
  residual add;
- encoder LayerNorm after the pos-conv residual and BEFORE the layers;
- per layer: h = LN1(x + attn(x)); y = LN2(h + FFN(h)).

Its attention is plain `matmul` + softmax, which XLA computed without
Pallas.

The conformer encoder (`conformer_encoder_forward`): no positional conv;
per block, half-step FFN → self-attention (Transformer-XL relative, rotary
or no position embeddings) → conv module → half-step FFN → LayerNorm; the
encoder LayerNorm after the blocks. With `cfg.use_flash_attention` and the
relative style, attention runs the fused kernel K5
(`ops.flash_attention`); otherwise the relative position term is the
exact factorized U·G product.

The layers are stacked on a leading L axis (the JAX layout) and run as a
Python loop over that axis.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..config import Wav2Vec2ModelConfig
from ..ops import flash_attention as fa
from .layers import act_fn, gelu, layer_norm, linear


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


def _conformer_rotary(t: int, head_dim: int, base: float, device) -> tuple:
    """Rotary cos/sin tables [T, head_dim] (emb = concat(freqs, freqs))."""
    inv = 1.0 / (base ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                       device=device) / head_dim))
    freqs = torch.arange(t, dtype=torch.float32, device=device)[:, None] * inv[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _relative_bd(p: dict, q: torch.Tensor, t: int, h: int) -> torch.Tensor:
    """The Transformer-XL position term bd[b, h, i, k] = (q_i + v)·W_pos·
    pe_{i−k}, factorized exactly: the angle-difference identities split it
    into U[i, :]·G[k, :] with inner dimension H (no [B, nh, T, 2T−1] tensor
    and no shift). In the compute dtype (f32 products at f32)."""
    b, nh, _, hd = q.shape
    bias_v = p["pos_bias_v"].to(q.dtype)[None, :, None, :]
    # a_bar[b, h, i, C] = Σ_d (q + v)[b, h, i, d] · W_pos[C, h·hd + d]
    w_pos = p["linear_pos"]["kernel"].to(q.dtype).reshape(h, nh, hd)
    a_bar = torch.matmul(q + bias_v, w_pos.permute(1, 2, 0)).reshape(b, nh, t, h // 2, 2)
    inv = torch.exp(torch.arange(0, h, 2, dtype=torch.float32, device=q.device)
                    * (-math.log(10000.0) / h))
    ang = torch.arange(t, dtype=torch.float32, device=q.device)[:, None] * inv[None, :]
    sin_t, cos_t = torch.sin(ang).to(q.dtype), torch.cos(ang).to(q.dtype)  # [T, H/2]
    a_sin, a_cos = a_bar[..., 0], a_bar[..., 1]  # pe even = sin, odd = cos
    u = torch.cat([a_sin * sin_t + a_cos * cos_t,    # pairs with cos(k·w)
                   a_cos * sin_t - a_sin * cos_t],   # pairs with sin(k·w)
                  dim=-1)  # [B, nh, T, H]
    del a_bar, a_sin, a_cos
    g = torch.cat([cos_t, sin_t], dim=-1)  # [T, H]
    return torch.matmul(u, g.transpose(0, 1))


def _attention_core(
    p: dict, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    mask_bias: torch.Tensor | None, style: str, h: int,
) -> torch.Tensor:
    """Conformer attention on projected q, k, v [B, nh, T, hd] without the
    kernel: scores (ac + bd)/sqrt(hd) (relative) or q·kᵀ/sqrt(hd), the key
    mask, softmax, · v. Scores are kept in the compute dtype, as the JAX
    XLA path keeps them."""
    t, hd = q.shape[2], q.shape[3]
    root = torch.tensor(hd ** 0.5, dtype=q.dtype)
    if style == "relative":
        bias_u = p["pos_bias_u"].to(q.dtype)[None, :, None, :]
        ac = torch.matmul(q + bias_u, k.transpose(-1, -2))
        scores = (ac + _relative_bd(p, q, t, h)) / root
    else:
        scores = torch.matmul(q, k.transpose(-1, -2)) / root
    if mask_bias is not None:
        scores = scores + mask_bias.to(scores.dtype)
    attn = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(attn, v)


def _conformer_attention(
    p: dict,
    x: torch.Tensor,
    mask_bias: torch.Tensor | None,
    cfg: Wav2Vec2ModelConfig,
    pos: tuple | None,
) -> torch.Tensor:
    """Wav2Vec2ConformerSelfAttention. `pos` is the rotary (cos, sin) pair,
    or None. The query is not pre-scaled: scores are divided by
    sqrt(head_dim) after the position term is added. With
    `cfg.use_flash_attention` and a shape `fa.use_flash` takes, the core
    runs the fused kernel; q + pos_bias_u and q + pos_bias_v are formed in
    the compute dtype before it."""
    b, t, h = x.shape
    nh = cfg.num_attention_heads
    hd = h // nh
    style = cfg.position_embeddings_type

    qk_states = x
    if style == "rotary":
        # rotation in the full hidden space before the q/k projections (HF
        # quirk); values attend from the unrotated states
        cos, sin = pos
        cos = cos.to(x.dtype)[None, :, None, :]
        sin = sin.to(x.dtype)[None, :, None, :]
        hh = x.reshape(b, t, nh, hd)
        rot = torch.cat([-hh[..., hd // 2:], hh[..., : hd // 2]], dim=-1)
        qk_states = (hh * cos + rot * sin).reshape(b, t, h)

    def split_heads(y):
        return y.reshape(b, t, nh, hd).transpose(1, 2)

    q = split_heads(linear(qk_states, p["linear_q"]["kernel"], p["linear_q"]["bias"]))
    k = split_heads(linear(qk_states, p["linear_k"]["kernel"], p["linear_k"]["bias"]))
    v = split_heads(linear(x, p["linear_v"]["kernel"], p["linear_v"]["bias"]))

    rel = style == "relative"
    if cfg.use_flash_attention and fa.use_flash(hd, rel=rel, dtype=x.dtype):
        mb = None if mask_bias is None else mask_bias.reshape(b, t)
        if rel:
            bias_u = p["pos_bias_u"].to(x.dtype)[None, :, None, :]
            bias_v = p["pos_bias_v"].to(x.dtype)[None, :, None, :]
            rel_r = fa.rel_table_rev(p["linear_pos"]["kernel"], nh, fa.pad_len(t), x.dtype)
            out = fa.flash_attention(q + bias_u, k, v, mb, q_pos=q + bias_v, rel_r=rel_r,
                                     scale=hd ** -0.5)
        else:
            out = fa.flash_attention(q, k, v, mb, scale=hd ** -0.5)
    else:
        out = _attention_core(p, q, k, v, mask_bias, style, h)
    out = out.transpose(1, 2).reshape(b, t, h)
    return linear(out, p["linear_out"]["kernel"], p["linear_out"]["bias"])


def _conformer_conv_module(
    p: dict, x: torch.Tensor, cfg: Wav2Vec2ModelConfig,
    frame_mask: torch.Tensor | None,
) -> torch.Tensor:
    """Wav2Vec2ConformerConvolutionModule: LN (eps 1e-5) → pointwise (H →
    2H, no bias) → GLU → depthwise conv (kernel conv_depthwise_kernel_size,
    SAME) → BatchNorm (folded to a per-channel affine at load) → act →
    pointwise (H → H). Padded frames are re-zeroed right before the
    depthwise conv, the only cross-frame op, so a padded batch equals the
    unpadded forward on the valid frames."""
    h_dim = x.shape[-1]
    x = layer_norm(x, p["layer_norm"]["weight"], p["layer_norm"]["bias"], 1e-5)
    x = torch.matmul(x, p["pointwise_conv1"]["kernel"].to(x.dtype))
    gate = torch.sigmoid(x[..., h_dim:].float()).to(x.dtype)
    x = x[..., :h_dim] * gate
    if frame_mask is not None:
        x = x * frame_mask[:, :, None].to(x.dtype)
    k = cfg.conv_depthwise_kernel_size
    w = p["depthwise_conv"]["weight"].to(x.dtype)  # [H, 1, K]
    xt = x.transpose(1, 2)
    if x.device.type == "cpu" and x.dtype != torch.float32:
        # the CPU's bf16 grouped conv is wrong (see pos_conv_forward): the
        # same bf16 operands through the f32 conv, rounded once
        y = F.conv1d(xt.float(), w.float(), None, padding=(k - 1) // 2,
                     groups=h_dim).to(x.dtype)
    else:
        y = F.conv1d(xt, w, None, padding=(k - 1) // 2, groups=h_dim)
    x = y.transpose(1, 2)
    bn = p["batch_norm"]
    x = x * bn["scale"].to(x.dtype) + bn["shift"].to(x.dtype)
    x = act_fn(cfg.hidden_act)(x)
    return torch.matmul(x, p["pointwise_conv2"]["kernel"].to(x.dtype))


def _conformer_layer(
    lp: dict, x: torch.Tensor, mask_bias: torch.Tensor | None,
    cfg: Wav2Vec2ModelConfig, pos, frame_mask: torch.Tensor | None,
) -> torch.Tensor:
    """One conformer block: half-step FFN → self-attention → conv module →
    half-step FFN → LN (the block's LNs use eps 1e-5)."""
    act = act_fn(cfg.hidden_act)

    def ff(fp, y):
        up = act(linear(y, fp["intermediate_dense"]["kernel"],
                        fp["intermediate_dense"]["bias"]))
        return linear(up, fp["output_dense"]["kernel"], fp["output_dense"]["bias"])

    def ln(name, y):
        return layer_norm(y, lp[name]["weight"], lp[name]["bias"], 1e-5)

    x = x + 0.5 * ff(lp["ffn1"], ln("ffn1_layer_norm", x))
    x = x + _conformer_attention(lp["self_attn"], ln("self_attn_layer_norm", x),
                                 mask_bias, cfg, pos)
    x = x + _conformer_conv_module(lp["conv_module"], x, cfg, frame_mask)
    x = x + 0.5 * ff(lp["ffn2"], ln("ffn2_layer_norm", x))
    return ln("final_layer_norm", x)


def _conformer_stack(
    params: dict, x: torch.Tensor, cfg: Wav2Vec2ModelConfig,
    frame_mask: torch.Tensor | None,
) -> torch.Tensor:
    """Mask, position tables computed once, conformer blocks."""
    mask_bias = None
    if frame_mask is not None:
        x = x * frame_mask[:, :, None].to(x.dtype)
        mask_bias = torch.zeros(frame_mask.shape, dtype=torch.float32, device=x.device)
        mask_bias = mask_bias.masked_fill(~frame_mask, float("-inf"))[:, None, None, :]
    style = cfg.position_embeddings_type
    if style not in ("relative", "rotary", "none"):
        raise NotImplementedError(
            f"position_embeddings_type {style!r} is not supported "
            "(expected relative/rotary/none)"
        )
    pos = None
    if style == "rotary":
        pos = _conformer_rotary(x.shape[1], cfg.hidden_size // cfg.num_attention_heads,
                                float(cfg.rotary_embedding_base), x.device)
    for i in range(cfg.num_hidden_layers):
        x = _conformer_layer(_layer_slice(params["layers"], i), x, mask_bias, cfg, pos,
                             frame_mask)
    return x


def conformer_encoder_forward(
    params: dict,
    x: torch.Tensor,
    cfg: Wav2Vec2ModelConfig,
    frame_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Wav2Vec2-Conformer encoder: x [B, T, H] → [B, T, H]. No positional
    conv (HF builds one for this encoder but never calls it); the encoder
    LayerNorm comes after the blocks, at cfg.layer_norm_eps."""
    x = _conformer_stack(params, x, cfg, frame_mask)
    ln = params["layer_norm"]
    return layer_norm(x, ln["weight"], ln["bias"], cfg.layer_norm_eps)
