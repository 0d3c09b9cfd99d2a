"""wav2vec2 conv feature extractor + feature projection.

PyTorch counterpart of `wav2vec2_tpu.models.feature_extractor`:

- a stack of VALID Conv1d layers (in_c = 1 for layer 0), per-layer kernel
  and stride from the config, optional bias;
- `feat_extract_norm == "group"` (wav2vec2-base): GroupNorm(groups =
  channels) on layer 0 only, with statistics masked to the valid frames of
  each utterance, so a padded batch equals per-utterance execution;
- `feat_extract_norm == "layer"` (the large pre-norm, data2vec and
  conformer checkpoints): LayerNorm over channels after every conv (per
  frame, so padding needs no mask);
- erf-GELU after every conv;
- projection: LayerNorm(conv_dim[-1]) → Linear(conv_dim[-1] → hidden); the
  LayerNorm is absent for HuBERT configs with feat_proj_layer_norm=false,
  the Linear for SEW with conv_dim[-1] == hidden_size; SEW-D's frontend
  norms use `feature_layer_norm_eps` (the encoder's epsilon is 1e-7).

The convs go to `torch.nn.functional.conv1d` (cuDNN on the card), as the
JAX package left them to XLA. Each conv's norm and GELU are one
`ops.norm_gelu` call (K6 on the card, `layers`' composition on the CPU);
the elements of the conv outputs are counted on the span the frontend runs
in (`forward.frontend`) as `elems`, beside K6's own count `elems_fused`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import Wav2Vec2ModelConfig
from ..ops.norm_gelu import norm_gelu
from ..utils import spans
from .layers import layer_norm, linear


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
    # SEW-D keeps its feature-path norms at feature_layer_norm_eps while its
    # encoder runs at 1e-7; every other family has one epsilon for both
    eps = cfg.feature_layer_norm_eps or cfg.layer_norm_eps
    for i, (k, s) in enumerate(zip(cfg.conv_kernel, cfg.conv_stride)):
        conv = params["conv_layers"][i]["conv"]
        bias = conv.get("bias")
        x = F.conv1d(
            x, conv["weight"].to(x.dtype),
            None if bias is None else bias.to(x.dtype), stride=s,
        )
        norm, norm_params, frame_lens = None, (), None
        if cfg.feat_extract_norm == "layer":
            ln = params["conv_layers"][i]["layer_norm"]
            norm, norm_params = "channel", (ln["weight"], ln["bias"])
        elif i == 0:
            if lens is not None:
                lens = frame_lens = (lens - k) // s + 1
            gn = params["conv_layers"][0]["layer_norm"]
            norm, norm_params = "group", (gn["weight"], gn["bias"])
        x = norm_gelu(x, norm, *norm_params, eps=eps, lens=frame_lens)
        spans.tally(elems=x.numel())
    return x


def feature_projection_forward(
    params: dict, features: torch.Tensor, cfg: Wav2Vec2ModelConfig
) -> torch.Tensor:
    """features [B, T, C_last] → hidden [B, T, H], normed at
    `feature_layer_norm_eps` where it is set; no projection where the tree
    has none (SEW with conv_dim[-1] == hidden_size)."""
    x = features
    eps = cfg.feature_layer_norm_eps or cfg.layer_norm_eps
    if "layer_norm" in params:
        ln = params["layer_norm"]
        x = layer_norm(x, ln["weight"], ln["bias"], eps)
    if "projection" in params:
        x = linear(x, params["projection"]["kernel"], params["projection"]["bias"])
    return x
