"""wav2vec2 conv feature extractor + feature projection.

PyTorch counterpart of `wav2vec2_tpu.models.feature_extractor`:

- a stack of VALID Conv1d layers (in_c = 1 for layer 0), per-layer kernel
  and stride from the config, optional bias;
- `feat_extract_norm == "group"` (wav2vec2-base): GroupNorm(groups =
  channels) on layer 0 only, with statistics masked to the valid frames of
  each utterance, so a padded batch equals per-utterance execution;
- `feat_extract_norm == "layer"` (the conformer checkpoints): LayerNorm
  over channels after every conv (per frame, so padding needs no mask);
- erf-GELU after every conv;
- projection: LayerNorm(conv_dim[-1]) → Linear(conv_dim[-1] → hidden).

The convs go to `torch.nn.functional.conv1d` (cuDNN on the card), as the
JAX package left them to XLA.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import Wav2Vec2ModelConfig
from .layers import gelu, group_norm_1d, layer_norm, layer_norm_channels, linear


def feature_extractor_forward(
    params: dict,
    audio: torch.Tensor,
    cfg: Wav2Vec2ModelConfig,
    audio_lens: torch.Tensor | None = None,
) -> torch.Tensor:
    """audio [B, N] → features [B, C_last, T].

    `audio_lens` [B] enables masked GroupNorm statistics (the layer-norm
    frontend normalizes each frame alone and needs no mask)."""
    x = audio[:, None, :]
    lens = audio_lens
    # one epsilon for the frontend and the encoder (the JAX package's
    # separate feature epsilon belongs to SEW-D, which the port refuses)
    eps = cfg.layer_norm_eps
    for i, (out_c, k, s) in enumerate(
        zip(cfg.conv_dim, cfg.conv_kernel, cfg.conv_stride)
    ):
        conv = params["conv_layers"][i]["conv"]
        bias = conv.get("bias")
        x = F.conv1d(
            x, conv["weight"].to(x.dtype),
            None if bias is None else bias.to(x.dtype), stride=s,
        )
        if cfg.feat_extract_norm == "layer":
            ln = params["conv_layers"][i]["layer_norm"]
            x = layer_norm_channels(x, ln["weight"], ln["bias"], eps)
        elif i == 0:
            time_mask = None
            if lens is not None:
                lens = (lens - k) // s + 1
                time_mask = (
                    torch.arange(x.shape[2], device=x.device)[None, :]
                    < lens[:, None]
                )
            gn = params["conv_layers"][0]["layer_norm"]
            x = group_norm_1d(
                x, gn["weight"], gn["bias"], num_groups=out_c,
                eps=eps, time_mask=time_mask,
            )
        x = gelu(x)
    return x


def feature_projection_forward(
    params: dict, features: torch.Tensor, cfg: Wav2Vec2ModelConfig
) -> torch.Tensor:
    """features [B, T, C_last] → hidden [B, T, H]."""
    ln = params["layer_norm"]
    x = layer_norm(features, ln["weight"], ln["bias"], cfg.layer_norm_eps)
    return linear(x, params["projection"]["kernel"], params["projection"]["bias"])
