"""The plain forward of the reference: one utterance at its own length,
in f32 with TF32 off, written from the published architectures
(transformers' Wav2Vec2ForCTC and its relatives, eval mode): the conv
feature extractor (GroupNorm over time on the first conv, or LayerNorm over
channels after each), LayerNorm + projection, the encoder of the config's
`model_type` (`models/<model_type>.py`, found by name), the CTC head.

One utterance at a time, unpadded: no mask is needed. The parameter tree is
the one the harness hands the program (weights stored [in, out]).
`quant="fp8"` is the lower precision the control runs in: every matrix
product's operands (the projections, FFNs and head, q·kᵀ, the position
term and P·V) rounded to float8 e4m3, each row (each weight column) scaled
so that its largest magnitude is the format's largest, 448.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from . import models


@contextlib.contextmanager
def exact_f32():
    """TF32 off for matmuls and cuDNN convs while the reference runs."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def normalize(samples: np.ndarray) -> np.ndarray:
    """Zero mean, unit variance (f64 statistics, σ floor 1e-7), as f32."""
    x = np.asarray(samples, np.float64)
    x = x - x.mean()
    return (x / max(float(np.sqrt(np.mean(x * x))), 1e-7)).astype(np.float32)


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    scale = torch.clamp(x.abs().amax(dim=dim, keepdim=True) / 448.0, min=1e-30)
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def mm(a, b, quant):
    """a @ b, with the operands rounded to `quant` first (rows of a, columns
    of b)."""
    if quant == "fp8":
        a, b = _fp8(a, -1), _fp8(b, -2)
    return a @ b


def linear(x, p, quant=None):
    y = mm(x, p["kernel"], quant)
    return y + p["bias"] if "bias" in p else y


def ln(x, p, eps):
    return F.layer_norm(x, (x.shape[-1],), p["weight"], p["bias"], eps)


def _features(fe, audio, cfg):
    x = audio[None, None, :]
    eps = cfg.get("layer_norm_eps", 1e-5)
    for i, (layer, stride) in enumerate(zip(fe["conv_layers"], cfg["conv_stride"])):
        conv = layer["conv"]
        x = F.conv1d(x, conv["weight"], conv.get("bias"), stride=stride)
        if cfg["feat_extract_norm"] == "layer":
            x = ln(x.transpose(1, 2), layer["layer_norm"], eps).transpose(1, 2)
        elif i == 0:
            gn = layer["layer_norm"]
            x = F.group_norm(x, x.shape[1], gn["weight"], gn["bias"], eps)
        x = F.gelu(x)
    return x[0].transpose(0, 1)  # [T, C]


def layer(tree, i):
    """The i-th layer of a tree whose leaves are stacked on a leading axis."""
    return {k: layer(v, i) for k, v in tree.items()} if isinstance(tree, dict) else tree[i]


def frames(n_samples: int, cfg: dict) -> int:
    """Frames the conv feature extractor makes of `n_samples`."""
    for k, s in zip(cfg["conv_kernel"], cfg["conv_stride"]):
        n_samples = (n_samples - k) // s + 1
    return max(n_samples, 0)


def log_probs(params: dict, audio: np.ndarray, cfg: dict, quant: str | None = None,
              device: str | torch.device = "cpu", prenormalized: bool = False) -> torch.Tensor:
    """[T, V] f32 log-probs of one utterance: `audio` the raw samples,
    normalized here unless `prenormalized`; `cfg` the model's config.json
    keys."""
    with torch.inference_mode(), exact_f32():
        x = torch.from_numpy(np.ascontiguousarray(
            audio if prenormalized else normalize(audio), np.float32)).to(device)
        feats = _features(params["feature_extractor"], x, cfg)
        fp = params["feature_projection"]
        hidden = linear(ln(feats, fp["layer_norm"], cfg.get("layer_norm_eps", 1e-5)),
                         fp["projection"], quant)
        hidden = models.load(cfg["model_type"]).encoder(params["encoder"], hidden, cfg, quant)
        return torch.log_softmax(linear(hidden, params["lm_head"], quant), dim=-1)
