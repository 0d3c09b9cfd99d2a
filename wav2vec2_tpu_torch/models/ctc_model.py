"""Wav2Vec2ForCTC: the full acoustic model graph.

PyTorch counterpart of `wav2vec2_tpu.models.ctc_model` for the conv
frontend and the wav2vec2 encoder: audio [B, N] → feature extractor
[B, C, T] → feature projection [B, T, H] → encoder → lm_head → logits
[B, T, V] in f32.

Precision. The JAX f32 forward runs at HIGHEST matmul precision. On the
card PyTorch's f32 matmuls are full f32 by default, but cuDNN's f32
convolutions default to TF32 (`torch.backends.cudnn.allow_tf32` is True),
which keeps about three decimal digits. An f32 forward therefore turns
TF32 off for both matmuls and convolutions while it runs, and restores the
flags after. A bf16 forward casts activations to bf16 and leaves the flags
alone.
"""

from __future__ import annotations

import contextlib

import torch

from ..config import Wav2Vec2ModelConfig
from .encoder import encoder_forward
from .feature_extractor import feature_extractor_forward, feature_projection_forward
from .layers import linear


@contextlib.contextmanager
def full_f32_precision():
    """TF32 off for matmuls and cuDNN convolutions inside the block."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


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
    with precision:
        x = audio.to(compute_dtype)
        feats = feature_extractor_forward(
            params["feature_extractor"], x, cfg, audio_lens=audio_lens
        )
        hidden = feature_projection_forward(
            params["feature_projection"], feats.transpose(1, 2), cfg
        )
        frame_mask = None
        if audio_lens is not None:
            conv_lens = conv_frame_lengths(cfg, audio_lens)
            frame_mask = (
                torch.arange(hidden.shape[1], device=hidden.device)[None, :]
                < conv_lens[:, None]
            )
        hidden = encoder_forward(params["encoder"], hidden, cfg, frame_mask=frame_mask)
        logits = linear(hidden, params["lm_head"]["kernel"], params["lm_head"]["bias"])
        return logits.float()


def conv_frame_lengths(
    cfg: Wav2Vec2ModelConfig, audio_lens: torch.Tensor
) -> torch.Tensor:
    """Feature-extractor output lengths — the rate the encoder runs at."""
    lens = audio_lens
    for k, s in zip(cfg.conv_kernel, cfg.conv_stride):
        lens = torch.div(lens - k, s, rounding_mode="floor") + 1
    return torch.clamp(lens, min=0)


def frame_lengths(cfg: Wav2Vec2ModelConfig, audio_lens: torch.Tensor) -> torch.Tensor:
    """Model output frame counts [B] (no adapter in this slice, so equal to
    the conv lengths)."""
    return conv_frame_lengths(cfg, audio_lens)


def log_softmax_logits(logits: torch.Tensor) -> torch.Tensor:
    """Log-softmax over the vocab axis in float32."""
    return torch.log_softmax(logits.float(), dim=-1)
