"""Wav2Vec2ForCTC: the full acoustic model graph.

PyTorch counterpart of `wav2vec2_tpu.models.ctc_model`: audio [B, N] →
the conv feature extractor [B, C, T] or w2v-BERT's log-mel frontend
[B, T, 160] (`models/mel.py`) → feature projection [B, T, H] → the encoder
of `cfg.encoder_style` (wav2vec2's, SEW's squeezed one, the conformer or
w2v-BERT's conformer) → w2v-BERT's intermediate FFN → the conv adapter or
the BERT adapter (`add_adapter`) → lm_head → logits [B, T, V] in f32.

Precision. The JAX f32 forward runs at HIGHEST matmul precision. On the
card PyTorch's f32 matmuls are full f32 by default, but cuDNN's f32
convolutions default to TF32 (`torch.backends.cudnn.allow_tf32` is True),
which keeps about three decimal digits. An f32 forward therefore turns
TF32 off for both matmuls and convolutions while it runs, and restores the
flags after. A bf16 forward casts activations to bf16 and leaves the flags
alone.

Under a device mesh (`parallel.mesh`) the audio and the weights are
DTensors and the forward runs on them as written; plain tensors made inside
it count as replicated. The mel frontend and the conv feature extractor
run on each rank's rows (`mesh.batch_local`): DTensor has no rule for the
frame view (`unfold`), nor, in the card's torch, for the norms' `var_mean`.
`with_flash_spmd` carries the mesh to K5's launch beside the config.
"""

from __future__ import annotations

import contextlib
import copy

import torch

from ..config import Wav2Vec2ModelConfig
from . import mel
from .encoder import (
    adapter_forward,
    bert_adapter_forward,
    conformer_bert_encoder_forward,
    conformer_encoder_forward,
    encoder_forward,
    sew_encoder_forward,
)
from .feature_extractor import feature_extractor_forward, feature_projection_forward
from ..parallel.mesh import batch_local, is_dtensor
from .layers import full_f32_precision, linear

_ENCODERS = {"wav2vec2": encoder_forward, "sew": sew_encoder_forward,
             "conformer": conformer_encoder_forward,
             "conformer_bert": conformer_bert_encoder_forward}


def wav2vec2_forward(
    params: dict,
    audio: torch.Tensor,
    cfg: Wav2Vec2ModelConfig,
    audio_lens: torch.Tensor | None = None,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """audio [B, N] normalized waveform → logits [B, T, V] (float32).

    `audio_lens` [B] makes batch execution padding-exact: masked GroupNorm
    statistics, zeroed padded frames, masked attention keys."""
    precision = (
        full_f32_precision() if compute_dtype == torch.float32
        else contextlib.nullcontext()
    )
    with precision, _replicating(audio):
        x = audio.to(compute_dtype)
        if cfg.frontend_style == "mel":
            feats = batch_local(lambda a, lens: mel.mel_frontend(a, cfg, audio_lens=lens)[0],
                                x, audio_lens)
            feats = feats.to(compute_dtype)
        else:
            feats = batch_local(
                lambda p, a, lens: feature_extractor_forward(p, a, cfg, audio_lens=lens),
                params["feature_extractor"], x, audio_lens,
            ).transpose(1, 2)
        hidden = feature_projection_forward(params["feature_projection"], feats, cfg)
        frame_mask = conv_lens = None
        if audio_lens is not None:
            conv_lens = conv_frame_lengths(cfg, audio_lens)
            frame_mask = (
                torch.arange(hidden.shape[1], device=hidden.device)[None, :]
                < conv_lens[:, None]
            )
        hidden = _ENCODERS[cfg.encoder_style](params["encoder"], hidden, cfg,
                                              frame_mask=frame_mask)
        if "intermediate_ffn" in params:
            # w2v-BERT's use_intermediate_ffn_before_adapter: relu, half step
            p = params["intermediate_ffn"]
            up = torch.relu(linear(hidden, p["intermediate_dense"]["kernel"],
                                   p["intermediate_dense"]["bias"]))
            hidden = hidden + 0.5 * linear(up, p["output_dense"]["kernel"],
                                           p["output_dense"]["bias"])
        if cfg.add_adapter and cfg.encoder_style == "conformer_bert":
            hidden, _ = bert_adapter_forward(params["adapter"], hidden, cfg,
                                             frame_lens=conv_lens)
        elif cfg.add_adapter:
            hidden = adapter_forward(params["adapter"], hidden, cfg, frame_lens=conv_lens)
        logits = linear(hidden, params["lm_head"]["kernel"], params["lm_head"]["bias"])
        return logits.float()


def _replicating(audio):
    """Inside a forward on DTensors, plain tensors count as replicated."""
    if not is_dtensor(audio):
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


def with_flash_spmd(cfg: Wav2Vec2ModelConfig, mesh) -> Wav2Vec2ModelConfig:
    """A copy of `cfg` whose `flash_spmd` attribute (not a field: it is never
    serialised) names the mesh K5 launches under, as the JAX package's
    `_FrozenCfg.flash_spmd` does; `mesh` None clears it."""
    out = copy.copy(cfg)
    out.flash_spmd = mesh
    return out


def conv_frame_lengths(
    cfg: Wav2Vec2ModelConfig, audio_lens: torch.Tensor
) -> torch.Tensor:
    """Feature-extractor output lengths (before the adapter) — the rate the
    encoder runs at, used for its frame mask; the mel frontend's stacked
    frames (1 + (N − 400) // 160) // 2."""
    if cfg.frontend_style == "mel":
        lens = torch.clamp(1 + torch.div(audio_lens - 400, 160, rounding_mode="floor"), min=0)
        return torch.div(lens, 2, rounding_mode="floor")
    lens = audio_lens
    for k, s in zip(cfg.conv_kernel, cfg.conv_stride):
        lens = torch.div(lens - k, s, rounding_mode="floor") + 1
    return torch.clamp(lens, min=0)


def frame_lengths(cfg: Wav2Vec2ModelConfig, audio_lens: torch.Tensor) -> torch.Tensor:
    """Model output frame counts [B]: the vector form of
    `Wav2Vec2ModelConfig.conv_output_length`, with the adapter's
    downsampling."""
    lens = conv_frame_lengths(cfg, audio_lens)
    if cfg.add_adapter:
        for _ in range(cfg.num_adapter_layers):
            if cfg.frontend_style == "mel":
                # the BERT adapter's convs: pad stride // 2, kernel K
                lens = torch.div(lens + 2 * (cfg.adapter_stride // 2) - cfg.adapter_kernel_size,
                                 cfg.adapter_stride, rounding_mode="floor") + 1
            else:
                lens = torch.div(lens - 1, cfg.adapter_stride, rounding_mode="floor") + 1
    return lens


def log_softmax_logits(logits: torch.Tensor) -> torch.Tensor:
    """Log-softmax over the vocab axis in float32."""
    return torch.log_softmax(logits.float(), dim=-1)
