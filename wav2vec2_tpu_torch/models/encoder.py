"""The wav2vec2 transformer encoder (its families), SEW / SEW-D, the
wav2vec2-conformer encoder and w2v-BERT's conformer.

PyTorch counterpart of `wav2vec2_tpu.models.encoder`. The wav2vec2 encoder
(`encoder_forward`):

- positional embedding: one grouped Conv1d (kernel
  num_conv_pos_embeddings, pad K/2, groups num_conv_pos_embedding_groups)
  with the weight norm folded at load time (an even kernel gives one extra
  frame, which is dropped) and GELU; mHuBERT's folded BatchNorm on its
  input; or data2vec-audio's stack of grouped convs, each with a non-affine
  LayerNorm and GELU; residual add;
- post-norm (wav2vec2-base): the encoder LayerNorm after the pos-conv
  residual and BEFORE the layers, per layer h = LN1(x + attn(x)),
  y = LN2(h + FFN(h));
- pre-norm (`do_stable_layer_norm`): per layer h = x + attn(LN1(x)),
  y = h + FFN(LN2(h)), and the encoder LayerNorm AFTER the layers;
- MMS attention adapters (LN → down → ReLU → up) added at the end of each
  layer; WavLM's gated relative position bias (T5-style buckets of layer
  0's embedding, gated per layer, head and query).

Its attention is plain `matmul` + softmax, which XLA computed without
Pallas; under WAV2VEC2_FLASH_FORCE=1 with `cfg.use_flash_attention` it runs
the fused kernel K5 instead (never with a WavLM bias), as the JAX package
does. `adapter_forward` is the GLU conv adapter after the encoder.

SEW / SEW-D (`sew_encoder_forward`): the same frames average-pooled by
squeeze_factor plus a strided positional conv, SEW's post-norm wav2vec2
layers or SEW-D's DeBERTa-v2 stack (`sew_d_layers_forward`: c2p / p2c
terms per diagonal, laid on the score grid by `_rel_shift`, never K5) at
the pooled rate, and an upsampler back to the conv rate.

The conformer encoder (`conformer_encoder_forward`): no positional conv;
per block, half-step FFN → self-attention (Transformer-XL relative, rotary
or no position embeddings) → conv module → half-step FFN → LayerNorm; the
encoder LayerNorm after the blocks. With `cfg.use_flash_attention` and the
relative style (or any style but relative_key when forced), attention runs
the fused kernel K5 (`ops.flash_attention`); otherwise the relative
position term is the exact factorized U·G product. w2v-BERT's encoder
(`conformer_bert_encoder_forward`) has the same blocks with its causal
depthwise conv and LayerNorm, the relative_key term, and no encoder
LayerNorm; `bert_adapter_forward` is its downsampling adapter.

The layers are stacked on a leading L axis (the JAX layout) and run as a
Python loop over that axis.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..config import POSITION_STYLES, Wav2Vec2ModelConfig
from ..ops import flash_attention as fa
from ..ops.norm_gelu import norm_gelu
from ..parallel.mesh import head_local, whole_local
from .layers import act_fn, layer_norm, linear
from .quantize import linear_maybe_quantized


def _conv1d(x: torch.Tensor, w: torch.Tensor, padding: int, groups: int = 1,
            stride: int = 1) -> torch.Tensor:
    """Conv1d of x [B, C, T] with w [O, C/groups, K] in x's dtype, no bias.
    oneDNN's CPU bf16 grouped conv returns wrong values (errors of the
    order of the outputs), so on the CPU the same bf16 operands go through
    the f32 conv and are rounded once, which is what the GPU conv
    computes."""
    w = w.to(x.dtype)
    if x.device.type == "cpu" and x.dtype != torch.float32:
        return F.conv1d(x.float(), w.float(), None, stride=stride, padding=padding,
                        groups=groups).to(x.dtype)
    return F.conv1d(x, w, None, stride=stride, padding=padding, groups=groups)


def _masked(x: torch.Tensor, frame_mask: torch.Tensor | None) -> torch.Tensor:
    """x [B, T, C] with the frames outside `frame_mask` [B, T] zeroed."""
    return x if frame_mask is None else x * frame_mask[:, :, None].to(x.dtype)


def pos_conv_forward(
    params: dict, x: torch.Tensor, cfg: Wav2Vec2ModelConfig,
    frame_mask: torch.Tensor | None = None, stride: int = 1,
) -> torch.Tensor:
    """x [B, T, H] → positional embeddings [B, T, H], or about [B, T /
    stride, H] for SEW's strided conv.

    With `batch_norm` (mHuBERT-147's conv_pos_batch_norm) the folded
    inference BatchNorm is applied to the conv input; its shift moves
    padded frames off zero, so they are re-masked, as the unpadded conv
    sees its own zero padding there."""
    seq_len = x.shape[1]
    k = cfg.num_conv_pos_embeddings
    if "batch_norm" in params:
        bn = params["batch_norm"]
        x = _masked(x * bn["scale"].to(x.dtype) + bn["shift"].to(x.dtype), frame_mask)
    h = _conv1d(x.transpose(1, 2), params["weight"], k // 2,
                cfg.num_conv_pos_embedding_groups, stride=stride).transpose(1, 2)
    if k % 2 == 0:
        # SamePad: an even kernel with pad K/2 gives one extra output
        # position; torch drops the last one
        h = h[:, :-1, :]
    if stride == 1 and h.shape[1] != seq_len:
        raise AssertionError(f"pos-conv gave {h.shape[1]} frames, want {seq_len}")
    return norm_gelu(h + params["bias"].to(x.dtype))


def pos_conv_stack_forward(
    params: dict, x: torch.Tensor, cfg: Wav2Vec2ModelConfig,
    frame_mask: torch.Tensor | None,
) -> torch.Tensor:
    """data2vec-audio positional embedding: the stacked grouped convs of
    `params["layers"]` (kernel cfg.conv_pos_kernel_size), each followed by
    a non-affine LayerNorm over channels in f32 and GELU. Padded frames are
    re-zeroed after every layer: the next conv's taps would otherwise read
    them where the unpadded conv reads zeros."""
    pad = cfg.conv_pos_kernel_size // 2
    seq_len = x.shape[1]
    layers = params["layers"]
    h = x
    for i in range(layers["weight"].shape[0]):
        y = _conv1d(h.transpose(1, 2), layers["weight"][i], pad,
                    cfg.num_conv_pos_embedding_groups).transpose(1, 2)
        y = y[:, :seq_len] + layers["bias"][i].to(h.dtype)  # an even kernel gives T + 1
        y = F.layer_norm(y.float(), (y.shape[-1],), None, None,
                         cfg.layer_norm_eps).to(h.dtype)
        h = _masked(norm_gelu(y), frame_mask)
    return h


@functools.lru_cache(maxsize=16)
def wavlm_offset_buckets(t: int, num_buckets: int, max_distance: int) -> torch.Tensor:
    """WavLM's T5-style bucket of each key − query offset −(t−1) … t−1
    (int64, on the host). The log-spaced buckets are computed in f32 in
    the JAX package's order of operations, log(rel / max_exact) /
    log(max_distance / max_exact) · (n − max_exact), then truncated: a
    bucket is a table index, and a different rounding at a boundary would
    change the bias silently."""
    rel = torch.arange(-(t - 1), t, dtype=torch.int64)
    n = num_buckets // 2
    buckets = (rel > 0).to(torch.int64) * n
    rel = rel.abs()
    max_exact = n // 2
    scaled = (torch.log(rel.clamp(min=1).to(torch.float32) / max_exact)
              / math.log(max_distance / max_exact) * (n - max_exact))
    large = (max_exact + scaled.to(torch.int64)).clamp(max=n - 1)
    return buckets + torch.where(rel < max_exact, rel, large)


@functools.lru_cache(maxsize=16)
def wavlm_buckets(t: int, num_buckets: int, max_distance: int,
                  device: torch.device) -> torch.Tensor:
    """The [T, T] bucket table (query i, key j → the bucket of j − i) on
    `device`, built once per T."""
    offsets = wavlm_offset_buckets(t, num_buckets, max_distance)
    pos = torch.arange(t)
    return offsets[pos[None, :] - pos[:, None] + (t - 1)].to(device)


def wavlm_position_bias(
    rel_attn_embed: torch.Tensor, t: int, num_buckets: int, max_distance: int
) -> torch.Tensor:
    """WavLM's shared relative position bias [H, T, T], from layer 0's
    embedding [num_buckets, H]; computed once per forward, each layer
    gates it."""
    buckets = wavlm_buckets(t, num_buckets, max_distance, rel_attn_embed.device)
    return whole_local(lambda e: e[buckets].permute(2, 0, 1), rel_attn_embed)


def _self_attention(
    p: dict, x: torch.Tensor, mask_bias: torch.Tensor | None, num_heads: int,
    position_bias: torch.Tensor | None = None, use_flash: bool = False,
    flash_spmd=None,
) -> torch.Tensor:
    """Multi-head self-attention; q pre-scaled by head_dim**-0.5, additive
    key mask of 0 / -inf.

    WavLM (`position_bias` [H, T, T]): the bias is gated per batch, head and
    query from the layer input — gates sigmoid(Σ₄ proj) in f32,
    ga·(gb·const − 1) + 2 — and added to the mask as an f32 [B, H, T, T]
    term.

    At f32 the scores are f32. At bf16 the [B, H, T, T] scores are stored in
    bf16, as the JAX bf16 path stores them (the GEMM accumulates in f32 and
    rounds once), and the mask (with a WavLM bias) is added after a cast to
    bf16; the softmax takes bf16 in and gives bf16 out, and PyTorch
    evaluates it in f32 inside the kernel, where XLA evaluates it on the
    bf16 values.

    `use_flash` (the config's switch) with a shape `fa.use_flash` takes —
    plain attention, so only under WAV2VEC2_FLASH_FORCE=1 — and no WavLM
    bias runs the fused kernel K5 on the pre-scaled q with scale 1, on each
    rank's shard under `flash_spmd` (the config's mesh)."""
    b, t, h = x.shape
    head_dim = h // num_heads

    if position_bias is not None:
        g = x.reshape(b, t, num_heads, head_dim).transpose(1, 2)
        proj = linear_maybe_quantized(g, p["gru_rel_pos_linear"])
        gates = torch.sigmoid(proj.reshape(b, num_heads, t, 2, 4).sum(-1).float())
        ga, gb = gates[..., 0:1], gates[..., 1:2]
        const = p["gru_rel_pos_const"].reshape(1, num_heads, 1, 1).float()
        gated_bias = (ga * (gb * const - 1.0) + 2.0) * position_bias[None].float()
        mask_bias = gated_bias if mask_bias is None else gated_bias + mask_bias

    def split_heads(y):
        return y.reshape(b, t, num_heads, head_dim).transpose(1, 2)

    scale = torch.tensor(head_dim ** -0.5, dtype=x.dtype)
    q = split_heads(linear_maybe_quantized(x, p["q_proj"]) * scale)
    k = split_heads(linear_maybe_quantized(x, p["k_proj"]))
    v = split_heads(linear_maybe_quantized(x, p["v_proj"]))
    if use_flash and position_bias is None and fa.use_flash(head_dim, dtype=x.dtype):
        mb = None if mask_bias is None else mask_bias.reshape(b, t)
        out = fa.flash_attention(q, k, v, mb, scale=1.0, spmd_mesh=flash_spmd)
    elif mask_bias is not None and mask_bias.shape[1] != 1:  # WavLM's [B, H, T, T]
        out = head_local(_dot_attention, (q, k, v, mask_bias), (), {}, {})
    else:
        out = head_local(_dot_attention, (q, k, v), (mask_bias,), {}, {})
    out = out.transpose(1, 2).reshape(b, t, h)
    return linear_maybe_quantized(out, p["out_proj"])


def _dot_attention(q, k, v, bias, _weights=None):
    """softmax(q·kᵀ + bias)·v over [B, NH, T, hd] (q pre-scaled); under a
    mesh on each rank's (rows, heads) tile (`parallel.mesh.head_local`)."""
    scores = torch.matmul(q, k.transpose(-1, -2))
    if bias is not None:
        scores = scores + bias.to(scores.dtype)
    attn = torch.softmax(scores, dim=-1)
    return torch.matmul(attn, v)


def _feed_forward(p: dict, x: torch.Tensor) -> torch.Tensor:
    up = norm_gelu(linear_maybe_quantized(x, p["intermediate_dense"]))
    return linear_maybe_quantized(up, p["output_dense"])


def _attn_adapter(a: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    """MMS attention adapter (Wav2Vec2AttnAdapterLayer): LN → down-proj →
    ReLU → up-proj."""
    h = layer_norm(x, a["norm"]["weight"], a["norm"]["bias"], eps)
    h = torch.relu(linear_maybe_quantized(h, a["linear_1"]))
    return linear_maybe_quantized(h, a["linear_2"])


def _encoder_layer(
    lp: dict, x: torch.Tensor, mask_bias: torch.Tensor | None,
    cfg: Wav2Vec2ModelConfig, position_bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """Pre-norm (do_stable_layer_norm): h = x + attn(ln1(x)); y = h +
    ff(ln2(h)). Post-norm: h = ln1(x + attn(x)); y = ln2(h + ff(h)). An MMS
    adapter is added to y."""
    eps = cfg.layer_norm_eps

    def attn(y):
        return _self_attention(lp["attention"], y, mask_bias, cfg.num_attention_heads,
                               position_bias, cfg.use_flash_attention,
                               getattr(cfg, "flash_spmd", None))

    def ln(name, y):
        return layer_norm(y, lp[name]["weight"], lp[name]["bias"], eps)

    if cfg.do_stable_layer_norm:
        h = x + attn(ln("layer_norm", x))
        y = h + _feed_forward(lp["feed_forward"], ln("final_layer_norm", h))
    else:
        h = ln("layer_norm", x + attn(x))
        y = ln("final_layer_norm", h + _feed_forward(lp["feed_forward"], h))
    if "adapter_layer" in lp:
        y = y + _attn_adapter(lp["adapter_layer"], y, eps)
    return y


def _layer_slice(tree, i: int):
    """Layer i of a tree of tensors stacked on a leading L axis (views)."""
    if isinstance(tree, dict):
        return {k: _layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def _key_mask_bias(frame_mask: torch.Tensor) -> torch.Tensor:
    """[B, T] validity → the [B, 1, 1, T] f32 additive key mask (0 / -inf)."""
    bias = torch.zeros(frame_mask.shape, dtype=torch.float32, device=frame_mask.device)
    return bias.masked_fill(~frame_mask, float("-inf"))[:, None, None, :]


def encoder_forward(
    params: dict,
    x: torch.Tensor,
    cfg: Wav2Vec2ModelConfig,
    frame_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """x [B, T, H] → [B, T, H].

    `frame_mask` [B, T] (True = valid) zeroes padded frames before the
    positional embedding and masks attention keys; in the post-norm order
    it re-zeroes padded frames after the encoder LayerNorm too. So a padded
    batch equals the unpadded forward on the valid frames."""
    mask_bias = None
    if frame_mask is not None:
        x = _masked(x, frame_mask)
        mask_bias = _key_mask_bias(frame_mask)
    pos = params["pos_conv_embed"]
    if "layers" in pos:
        x = x + pos_conv_stack_forward(pos, x, cfg, frame_mask)
    else:
        x = x + pos_conv_forward(pos, x, cfg, frame_mask)
    enc_ln = params["layer_norm"]
    if not cfg.do_stable_layer_norm:
        x = layer_norm(x, enc_ln["weight"], enc_ln["bias"], cfg.layer_norm_eps)
        x = _masked(x, frame_mask)
    position_bias = None
    if "rel_attn_embed" in params:
        position_bias = wavlm_position_bias(params["rel_attn_embed"], x.shape[1],
                                            cfg.num_buckets, cfg.max_bucket_distance)
    for i in range(cfg.num_hidden_layers):
        x = _encoder_layer(_layer_slice(params["layers"], i), x, mask_bias, cfg,
                           position_bias)
    if cfg.do_stable_layer_norm:
        x = layer_norm(x, enc_ln["weight"], enc_ln["bias"], cfg.layer_norm_eps)
    return x


def adapter_forward(
    params: dict,
    x: torch.Tensor,
    cfg: Wav2Vec2ModelConfig,
    frame_lens: torch.Tensor | None = None,
) -> torch.Tensor:
    """The wav2vec2 conv adapter (Wav2Vec2Adapter, add_adapter=true): an
    optional projection + LayerNorm (eps 1e-5, torch's default: the adapter
    does not read layer_norm_eps), then num_adapter_layers convs of kernel
    adapter_kernel_size, pad 1, stride adapter_stride, each with a GLU over
    channels. x [B, T, H] → [B, T', O].

    `frame_lens` [B] keeps a padded batch exact: padded frames are
    re-zeroed before every conv, with the lengths shrinking as the frames
    do ((L − 1) // stride + 1)."""
    if "proj" in params:
        x = linear(x, params["proj"]["kernel"], params["proj"]["bias"])
        ln = params["proj_layer_norm"]
        x = layer_norm(x, ln["weight"], ln["bias"], 1e-5)

    def mask(z, lens):
        valid = torch.arange(z.shape[1], device=z.device)[None, :] < lens[:, None]
        return _masked(z, valid)

    lens = frame_lens
    if lens is not None:
        x = mask(x, lens)
    convs = params["layers"]
    stride = cfg.adapter_stride
    for i in range(convs["weight"].shape[0]):
        x = _conv1d(x.transpose(1, 2), convs["weight"][i], 1, stride=stride).transpose(1, 2)
        x = x + convs["bias"][i].to(x.dtype)
        o = x.shape[-1] // 2
        x = x[..., :o] * torch.sigmoid(x[..., o:].float()).to(x.dtype)
        if lens is not None:
            lens = torch.div(lens - 1, stride, rounding_mode="floor") + 1
            x = mask(x, lens)
    return x


def _deberta_log_bucket_positions(rel, bucket_size: int, max_position: int) -> np.ndarray:
    """DeBERTa-v2 signed log-bucketed relative positions (transformers
    make_log_bucket_position) of a numpy array of q − k offsets, on the
    host in f64, in the JAX package's operations: the buckets are table
    indices, equal to JAX's for every T."""
    rel = np.asarray(rel, dtype=np.int64)
    mid = bucket_size // 2
    abs_pos = np.where(
        (rel < mid) & (rel > -mid), float(mid - 1), np.abs(rel).astype(np.float64)
    )
    with np.errstate(divide="ignore"):
        log_pos = (
            np.ceil(
                np.log(abs_pos / mid) / np.log((max_position - 1) / mid)
                * (mid - 1)
            )
            + mid
        )
    bucket = np.where(abs_pos <= mid, rel.astype(np.float64),
                      log_pos * np.sign(rel))
    return bucket.astype(np.int64)


@functools.lru_cache(maxsize=16)
def _deberta_selectors(t: int, span: int, max_position: int, device: torch.device):
    """The rows of the [2·span] position table that the c2p and p2c terms
    lay on the diagonals of their [T, 2T − 1] tensors (diagonal e carries
    offset q − k = (T − 1) − e), on `device`, built once per T."""
    diag_bucket = _deberta_log_bucket_positions(np.arange(t - 1, -t, -1), span, max_position)
    c2p = np.clip(diag_bucket + span, 0, 2 * span - 1)
    p2c = np.clip(-diag_bucket + span, 0, 2 * span - 1)
    return torch.from_numpy(c2p).to(device), torch.from_numpy(p2c).to(device)


def _rel_shift(z: torch.Tensor) -> torch.Tensor:
    """y[..., r, c] = z[..., r, c + (T − 1) − r] for z [..., T, 2T − 1]
    contiguous: the flatten, a contiguous slice and a reshape, all views
    (no gather, no [T, T] index). It lays a term computed per diagonal onto
    the (q, k) score grid."""
    *lead, t, w = z.shape
    if w != 2 * t - 1:
        raise ValueError(f"_rel_shift takes [..., T, 2T - 1], got {tuple(z.shape)}")
    if t == 1:
        return z
    flat = z.reshape(*lead, t * w)[..., t - 1: t - 1 + t * (2 * t - 2)]
    return flat.reshape(*lead, t, 2 * t - 2)[..., :t]


def sew_d_layers_forward(
    params: dict, h: torch.Tensor, cfg: Wav2Vec2ModelConfig,
    mask_bias: torch.Tensor | None,
) -> torch.Tensor:
    """SEW-D's DeBERTa-v2 stack (SEWDTransformerEncoder): post-norm layers
    (`output_norm` at cfg.layer_norm_eps) whose attention adds the
    content→position (c2p) and position→content (p2c) terms of a shared
    position embedding, LayerNormed in f32 and cast to the compute dtype,
    projected by each layer's own key / query projections
    (share_att_key). Scores are divided by sqrt(head_dim · (1 +
    |pos_att_type|)): the key before q·kᵀ, c2p and p2c after (divisions,
    not reciprocal multiplies, in HF's order, for f32 closeness).

    The bucket of q − k depends on the diagonal only, so each layer
    projects the [2·span, H] table, picks its rows per diagonal, contracts
    q or k against them into [B, nh, T, 2T − 1], and `_rel_shift` lays the
    result onto the (q, k) grid. Under bf16 compute the scores and both
    wide terms stay bf16, as in the JAX package. This attention never runs
    K5, there as here."""
    if not cfg.share_att_key:
        raise NotImplementedError(
            "SEW-D with share_att_key=false (separate pos_key/pos_query "
            "projections) is not supported; all released SEW-D checkpoints "
            "share the attention keys"
        )
    b, t, _ = h.shape
    nh = cfg.num_attention_heads
    hd = cfg.hidden_size // nh
    span = cfg.position_buckets
    pos_att = tuple(cfg.pos_att_type)
    scale = float(np.float32((hd * (1 + len(pos_att))) ** 0.5))
    c2p_sel, p2c_sel = _deberta_selectors(t, span, cfg.max_position_embeddings, h.device)

    rel_emb = params["rel_embeddings"].float()  # [2·span, H]
    if "rel_embeddings_layer_norm" in params:
        ln = params["rel_embeddings_layer_norm"]
        rel_emb = layer_norm(rel_emb, ln["weight"], ln["bias"], cfg.layer_norm_eps)
    rel_emb = rel_emb.to(h.dtype)

    def split_heads(y):  # [..., T, H] → [..., nh, T, hd]
        return y.reshape(*y.shape[:-1], nh, hd).transpose(-3, -2)

    eps = cfg.layer_norm_eps
    root = torch.tensor(scale, dtype=h.dtype)
    for i in range(cfg.num_hidden_layers):
        lp = _layer_slice(params["layers"], i)
        a = lp["attention"]
        qh = split_heads(linear(h, a["query_proj"]["kernel"], a["query_proj"]["bias"]))
        kh = split_heads(linear(h, a["key_proj"]["kernel"], a["key_proj"]["bias"]))
        vh = split_heads(linear(h, a["value_proj"]["kernel"], a["value_proj"]["bias"]))
        pos = {}
        if "c2p" in pos_att:
            pos["k"] = split_heads(linear(rel_emb, a["key_proj"]["kernel"],
                                          a["key_proj"]["bias"]))  # [nh, 2·span, hd]
        if "p2c" in pos_att:
            pos["q"] = split_heads(linear(rel_emb, a["query_proj"]["kernel"],
                                          a["query_proj"]["bias"]))

        def core(qh, kh, vh, mask_bias, pos):
            scores = torch.matmul(qh, (kh / root).transpose(-1, -2))
            if "k" in pos:
                c2p = torch.matmul(qh, pos["k"][:, c2p_sel].transpose(-1, -2))
                scores = scores + _rel_shift(c2p) / root
                del c2p
            if "q" in pos:
                p2c = torch.matmul(kh, pos["q"][:, p2c_sel].transpose(-1, -2))
                # [B, nh, T(k), T(q)] → onto the (q, k) grid
                scores = scores + _rel_shift(p2c).transpose(-1, -2) / root
                del p2c
            if mask_bias is not None:
                scores = scores + mask_bias.to(scores.dtype)
            attn = torch.softmax(scores, dim=-1)
            del scores
            return torch.matmul(attn.to(vh.dtype), vh)

        out = head_local(core, (qh, kh, vh), (mask_bias,), pos, {"k": 0, "q": 0})
        out = out.transpose(1, 2).reshape(h.shape)
        out = linear(out, a["output_dense"]["kernel"], a["output_dense"]["bias"])
        x = layer_norm(out + h, a["output_norm"]["weight"], a["output_norm"]["bias"], eps)
        up = norm_gelu(linear(x, lp["intermediate_dense"]["kernel"],
                              lp["intermediate_dense"]["bias"]))
        down = linear(up, lp["output_dense"]["kernel"], lp["output_dense"]["bias"])
        h = layer_norm(down + x, lp["output_norm"]["weight"], lp["output_norm"]["bias"], eps)
    return h


def sew_encoder_forward(
    params: dict, x: torch.Tensor, cfg: Wav2Vec2ModelConfig,
    frame_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """SEW / SEW-D squeezed encoder (SEWEncoder, SEWDEncoder): x [B, T, H]
    → [B, T, H]. The frames are average-pooled by squeeze_factor in f32
    and added to the strided positional conv over their common length;
    SEW runs the encoder LayerNorm and wav2vec2's post-norm layers at the
    pooled rate (so WAV2VEC2_FLASH_FORCE=1 sends their attention through
    K5 at the pooled length), SEW-D its DeBERTa stack; the upsampler (H →
    H·sf, GELU) folds channels back into time and the tail is zero-padded
    to T.

    A padded batch: the pooled lengths are Σmask // sf (HF's rule) and mask
    the keys; pooled rows past them carry junk that lands exactly on the
    upsampled frames at or past enc_lens·sf, which are zeroed, as the
    unpadded run's zero tail."""
    sf = cfg.squeeze_factor
    b, t_in, h_dim = x.shape
    x = _masked(x, frame_mask)
    pos = pos_conv_forward(params["pos_conv_embed"], x, cfg, stride=sf)
    t_pool = t_in // sf
    pooled = x[:, : t_pool * sf].reshape(b, t_pool, sf, h_dim).float().mean(dim=2)
    min_len = min(pos.shape[1], t_pool)
    h = pooled[:, :min_len].to(x.dtype) + pos[:, :min_len]
    enc_lens = mask_bias = None
    if frame_mask is not None:
        enc_lens = torch.div(frame_mask.sum(dim=1), sf, rounding_mode="floor")
        mask_bias = _key_mask_bias(
            torch.arange(min_len, device=x.device)[None, :] < enc_lens[:, None])
    if cfg.attention_style == "deberta":
        h = sew_d_layers_forward(params, h, cfg, mask_bias)
    else:
        ln = params["layer_norm"]
        h = layer_norm(h, ln["weight"], ln["bias"], cfg.layer_norm_eps)
        for i in range(cfg.num_hidden_layers):
            h = _encoder_layer(_layer_slice(params["layers"], i), h, mask_bias, cfg)
    up = params["upsample"]["projection"]
    h = norm_gelu(linear(h, up["kernel"], up["bias"]))  # [B, min_len, H·sf]
    h = h.reshape(b, min_len * sf, h.shape[-1] // sf)
    if enc_lens is not None:
        h = _masked(h, torch.arange(h.shape[1], device=x.device)[None, :]
                    < (enc_lens * sf)[:, None])
    if h.shape[1] < t_in:
        h = F.pad(h, (0, 0, 0, t_in - h.shape[1]))
    return h


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


@functools.lru_cache(maxsize=16)
def _clamped_distances(t: int, left: int, right: int, device: torch.device) -> torch.Tensor:
    """[T, T] rows of the relative_key table: clamp(k − q, −left, right) +
    left for query q and key k, on `device`, built once per T."""
    pos = torch.arange(t)
    return (torch.clamp(pos[None, :] - pos[:, None], -left, right) + left).to(device)


def _relative_key_term(p: dict, q: torch.Tensor, cfg: Wav2Vec2ModelConfig) -> torch.Tensor:
    """w2v-BERT's position term rel[b, h, l, r] = q[b, h, l] · E[clamp(r −
    l, −left, right)] over the layer's `distance_embedding` E, in the
    compute dtype. Kept in HF's gather form on purpose (the JAX package's
    measured choice): the [T, T, hd] gathered table does not depend on the
    batch, and the term lands on the score grid with no [B, nh, T, 2T − 1]
    intermediate."""
    t = q.shape[2]
    idx = _clamped_distances(t, cfg.left_max_position_embeddings,
                             cfg.right_max_position_embeddings, q.device)
    posemb = p["distance_embedding"].to(q.dtype)[idx]  # [T, T, hd]
    return torch.einsum("bhld,lrd->bhlr", q, posemb)


# the attention weights `_attention_core` reads, each with its heads axis
# (None: it has none)
_CORE_HEAD_AXES = {"pos_bias_u": 0, "pos_bias_v": 0, "linear_pos": 1,
                   "distance_embedding": None}


def _attention_core(
    p: dict, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    mask_bias: torch.Tensor | None, style: str, h: int,
    cfg: Wav2Vec2ModelConfig | None = None,
) -> torch.Tensor:
    """Conformer attention on projected q, k, v [B, nh, T, hd] without the
    kernel: scores (ac + bd)/sqrt(hd) (relative), q·kᵀ/sqrt(hd) +
    rel/sqrt(hd) (relative_key, whose distance limits `cfg` gives) or
    q·kᵀ/sqrt(hd), the key mask, softmax, · v. Scores are kept in the
    compute dtype, as the JAX XLA path keeps them."""
    t, hd = q.shape[2], q.shape[3]
    root = torch.tensor(hd ** 0.5, dtype=q.dtype)
    if style == "relative":
        bias_u = p["pos_bias_u"].to(q.dtype)[None, :, None, :]
        ac = torch.matmul(q + bias_u, k.transpose(-1, -2))
        scores = (ac + _relative_bd(p, q, t, h)) / root
    else:
        scores = torch.matmul(q, k.transpose(-1, -2)) / root
    if style == "relative_key":
        scores = scores + _relative_key_term(p, q, cfg) / root
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
    style: str | None = None,
) -> torch.Tensor:
    """Wav2Vec2ConformerSelfAttention / Wav2Vec2BertSelfAttention. `pos` is
    the rotary (cos, sin) pair, or None; `style` overrides
    cfg.position_embeddings_type (the BERT adapter's attention is
    position-free). The query is not pre-scaled: scores are divided by
    sqrt(head_dim) after the position term is added. With
    `cfg.use_flash_attention` and a shape `fa.use_flash` takes, the core
    runs the fused kernel; q + pos_bias_u and q + pos_bias_v are formed in
    the compute dtype before it. relative_key never reaches the kernel,
    forced or not: the kernel has no term for it."""
    b, t, h = x.shape
    nh = cfg.num_attention_heads
    hd = h // nh
    if style is None:
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

    q = split_heads(linear_maybe_quantized(qk_states, p["linear_q"]))
    k = split_heads(linear_maybe_quantized(qk_states, p["linear_k"]))
    v = split_heads(linear_maybe_quantized(x, p["linear_v"]))

    rel = style == "relative"
    if (cfg.use_flash_attention and style != "relative_key"
            and fa.use_flash(hd, rel=rel, dtype=x.dtype)):
        mb = None if mask_bias is None else mask_bias.reshape(b, t)
        spmd = getattr(cfg, "flash_spmd", None)
        if rel:
            bias_u = p["pos_bias_u"].to(x.dtype)[None, :, None, :]
            bias_v = p["pos_bias_v"].to(x.dtype)[None, :, None, :]
            rel_r = fa.rel_table_rev(p["linear_pos"]["kernel"], nh, fa.pad_len(t), x.dtype)
            out = fa.flash_attention(q + bias_u, k, v, mb, q_pos=q + bias_v, rel_r=rel_r,
                                     scale=hd ** -0.5, spmd_mesh=spmd)
        else:
            out = fa.flash_attention(q, k, v, mb, scale=hd ** -0.5, spmd_mesh=spmd)
    else:
        out = head_local(
            lambda q_, k_, v_, mb, w: _attention_core(w, q_, k_, v_, mb, style, h, cfg),
            (q, k, v), (mask_bias,),
            {name: p[name] for name in _CORE_HEAD_AXES if name in p}, _CORE_HEAD_AXES)
    out = out.transpose(1, 2).reshape(b, t, h)
    return linear_maybe_quantized(out, p["linear_out"])


def _conformer_conv_module(
    p: dict, x: torch.Tensor, cfg: Wav2Vec2ModelConfig,
    frame_mask: torch.Tensor | None,
) -> torch.Tensor:
    """Wav2Vec2ConformerConvolutionModule: LN (eps 1e-5) → pointwise (H →
    2H, no bias) → GLU → depthwise conv (kernel conv_depthwise_kernel_size,
    SAME) → BatchNorm (folded to a per-channel affine at load) → act →
    pointwise (H → H). Padded frames are re-zeroed right before the
    depthwise conv, the only cross-frame op, so a padded batch equals the
    unpadded forward on the valid frames.

    w2v-BERT (Wav2Vec2BertConvolutionModule): every LN at cfg.layer_norm_eps,
    the mask at module entry (before pointwise_conv1, as HF's
    conv_attention_mask), a causal depthwise conv (left pad K − 1), and
    `depthwise_layer_norm` in place of the BatchNorm."""
    bert = cfg.encoder_style == "conformer_bert"
    eps = cfg.layer_norm_eps if bert else 1e-5
    h_dim = x.shape[-1]
    x = layer_norm(x, p["layer_norm"]["weight"], p["layer_norm"]["bias"], eps)
    if bert:
        x = _masked(x, frame_mask)
    x = torch.matmul(x, p["pointwise_conv1"]["kernel"].to(x.dtype))
    gate = torch.sigmoid(x[..., h_dim:].float()).to(x.dtype)
    x = x[..., :h_dim] * gate
    k = cfg.conv_depthwise_kernel_size
    if bert:
        x = _conv1d(F.pad(x.transpose(1, 2), (k - 1, 0)), p["depthwise_conv"]["weight"], 0,
                    h_dim).transpose(1, 2)
        ln = p["depthwise_layer_norm"]
        x = layer_norm(x, ln["weight"], ln["bias"], eps)
    else:
        x = _masked(x, frame_mask)
        x = _conv1d(x.transpose(1, 2), p["depthwise_conv"]["weight"], (k - 1) // 2,
                    h_dim).transpose(1, 2)
        bn = p["batch_norm"]
        x = x * bn["scale"].to(x.dtype) + bn["shift"].to(x.dtype)
    x = act_fn(cfg.hidden_act)(x)
    return torch.matmul(x, p["pointwise_conv2"]["kernel"].to(x.dtype))


def _conformer_layer(
    lp: dict, x: torch.Tensor, mask_bias: torch.Tensor | None,
    cfg: Wav2Vec2ModelConfig, pos, frame_mask: torch.Tensor | None,
) -> torch.Tensor:
    """One conformer block: half-step FFN → self-attention → conv module →
    half-step FFN → LN. The block's LNs use eps 1e-5 (torch's default, the
    conformer's), cfg.layer_norm_eps in w2v-BERT."""
    act = act_fn(cfg.hidden_act)
    eps = cfg.layer_norm_eps if cfg.encoder_style == "conformer_bert" else 1e-5

    def ff(fp, y):
        up = act(linear_maybe_quantized(y, fp["intermediate_dense"]))
        return linear_maybe_quantized(up, fp["output_dense"])

    def ln(name, y):
        return layer_norm(y, lp[name]["weight"], lp[name]["bias"], eps)

    x = x + 0.5 * ff(lp["ffn1"], ln("ffn1_layer_norm", x))
    x = x + _conformer_attention(lp["self_attn"], ln("self_attn_layer_norm", x),
                                 mask_bias, cfg, pos)
    x = x + _conformer_conv_module(lp["conv_module"], x, cfg, frame_mask)
    x = x + 0.5 * ff(lp["ffn2"], ln("ffn2_layer_norm", x))
    return ln("final_layer_norm", x)


def _conformer_stack(
    params: dict, x: torch.Tensor, cfg: Wav2Vec2ModelConfig,
    frame_mask: torch.Tensor | None, allowed_styles: tuple[str, ...],
) -> torch.Tensor:
    """Mask, position tables computed once (relative_key reads its
    distance embedding per layer), conformer blocks. The two conformer
    encoders differ in their position styles and the LayerNorm after."""
    mask_bias = None
    if frame_mask is not None:
        x = _masked(x, frame_mask)
        mask_bias = _key_mask_bias(frame_mask)
    style = cfg.position_embeddings_type
    if style not in allowed_styles:
        raise NotImplementedError(
            f"position_embeddings_type {style!r} is not supported "
            f"(expected {'/'.join(allowed_styles)})"
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
    x = _conformer_stack(params, x, cfg, frame_mask, POSITION_STYLES["conformer"])
    ln = params["layer_norm"]
    return layer_norm(x, ln["weight"], ln["bias"], cfg.layer_norm_eps)


def conformer_bert_encoder_forward(
    params: dict,
    x: torch.Tensor,
    cfg: Wav2Vec2ModelConfig,
    frame_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """w2v-BERT encoder (Wav2Vec2BertEncoder): x [B, T, H] → [B, T, H].
    Conformer blocks with relative_key, relative, rotary or no position
    term, no positional conv and no encoder LayerNorm after the blocks
    (each block ends in its own)."""
    return _conformer_stack(params, x, cfg, frame_mask, POSITION_STYLES["conformer_bert"])


def bert_adapter_forward(
    params: dict,
    x: torch.Tensor,
    cfg: Wav2Vec2ModelConfig,
    frame_lens: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """w2v-BERT's adapter (Wav2Vec2BertAdapter): an optional projection
    with `proj_layer_norm` at cfg.layer_norm_eps, then per layer a strided
    GLU conv (kernel adapter_kernel_size, stride adapter_stride, pad
    stride // 2) on the residual branch and another one feeding a
    position-free self-attention, then an `adapter_act` FFN at full step.
    Returns (hidden [B, T', O], the new lengths or None).

    A padded batch: each conv's input is masked after its LayerNorm (LN of
    a zeroed row is its bias), so the taps read the zeros the unpadded
    conv's own padding gives; the attention masks keys by the new lengths
    (L + 2·pad − K) // stride + 1. Under WAV2VEC2_FLASH_FORCE=1 with
    `cfg.use_flash_attention` that attention runs K5."""
    eps = cfg.layer_norm_eps
    if "proj" in params:
        x = linear(x, params["proj"]["kernel"], params["proj"]["bias"])
        ln = params["proj_layer_norm"]
        x = layer_norm(x, ln["weight"], ln["bias"], eps)
    stride, k = cfg.adapter_stride, cfg.adapter_kernel_size
    pad = stride // 2
    act = act_fn(cfg.adapter_act)

    def mask(z, lens):
        if lens is None:
            return z
        return _masked(z, torch.arange(z.shape[1], device=z.device)[None, :] < lens[:, None])

    def glu_conv(z, cp):  # cp["weight"]: torch's [2O, O, K]
        z = _conv1d(z.transpose(1, 2), cp["weight"], pad, stride=stride).transpose(1, 2)
        z = z + cp["bias"].to(z.dtype)
        o = z.shape[-1] // 2
        return z[..., :o] * torch.sigmoid(z[..., o:].float()).to(z.dtype)

    def ln(lp, name, z):
        return layer_norm(z, lp[name]["weight"], lp[name]["bias"], eps)

    lens = frame_lens
    layers = params["layers"]
    for i in range(layers["residual_conv"]["weight"].shape[0]):
        lp = _layer_slice(layers, i)
        new_lens = None if lens is None else torch.div(lens + 2 * pad - k, stride,
                                                       rounding_mode="floor") + 1
        res = glu_conv(mask(ln(lp, "residual_layer_norm", x), lens), lp["residual_conv"])
        h = glu_conv(mask(ln(lp, "self_attn_layer_norm", x), lens), lp["self_attn_conv"])
        mask_bias = None
        if new_lens is not None:
            mask_bias = _key_mask_bias(
                torch.arange(h.shape[1], device=h.device)[None, :] < new_lens[:, None])
        lens = new_lens
        x = _conformer_attention(lp["self_attn"], h, mask_bias, cfg, None, style="none") + res
        f = lp["ffn"]
        up = act(linear_maybe_quantized(ln(lp, "ffn_layer_norm", x), f["intermediate_dense"]))
        x = linear_maybe_quantized(up, f["output_dense"]) + x
    return x, lens
