"""Configuration types, carried over from `wav2vec2_tpu.config`.

Only what the port runs: the wav2vec2 CTC model config (group-norm conv
frontend, post-norm encoder, plain attention) and the wav2vec2-conformer
one (layer-norm or group-norm frontend, conformer blocks with relative,
rotary or no position embeddings), the aligner's tunables with the same
defaults, and the vocab loader. Model types whose graphs the port does not
run yet are refused when the config is parsed instead of silently running
the wrong graph.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

from .errors import InvalidInputError, IoError, JsonError

DEFAULT_SAMPLE_RATE_HZ = 16_000

# config.json model type → the encoder the port runs for it
_ENCODER_STYLES = {None: "wav2vec2", "wav2vec2": "wav2vec2",
                   "wav2vec2-conformer": "conformer"}


@dataclass
class Wav2Vec2Config:
    """User-facing aligner configuration: where the model files live and
    which device runs it ("cuda" or "cpu")."""

    model_path: str = ""
    config_path: str = ""
    vocab_path: str = ""
    device: str = "cuda"
    expected_sample_rate_hz: int = DEFAULT_SAMPLE_RATE_HZ


@dataclass
class Wav2Vec2ModelConfig:
    """Deserialized HF `config.json` of a wav2vec2 CTC model."""

    hidden_size: int
    num_hidden_layers: int
    num_attention_heads: int
    intermediate_size: int
    conv_dim: list[int]
    conv_kernel: list[int]
    conv_stride: list[int]
    num_conv_pos_embeddings: int
    num_conv_pos_embedding_groups: int
    pad_token_id: int
    vocab_size: int
    do_stable_layer_norm: bool = False
    layer_norm_eps: float = 1e-5
    dtype: Optional[str] = None
    feat_extract_norm: str = "layer"
    conv_bias: bool = True
    # "wav2vec2" | "conformer" (set from config.json's model_type)
    encoder_style: str = "wav2vec2"
    # Wav2Vec2-Conformer (Wav2Vec2ConformerConfig): conformer blocks with
    # Transformer-XL relative, rotary or no position embeddings; hidden_act
    # is the FFN and conv-module activation (released checkpoints: "swish")
    position_embeddings_type: str = "relative"  # "relative"|"rotary"|"none"
    rotary_embedding_base: int = 10000
    max_source_positions: int = 5000
    conv_depthwise_kernel_size: int = 31
    hidden_act: str = "gelu"
    # serving-path switch (not a checkpoint field): route the conformer's
    # attention through the fused kernel (ops/flash_attention.py). Set by
    # BatchAligner on a CUDA device.
    use_flash_attention: bool = False

    @classmethod
    def from_dict(cls, d: dict) -> "Wav2Vec2ModelConfig":
        required = [
            "hidden_size", "num_hidden_layers", "num_attention_heads",
            "intermediate_size", "conv_dim", "conv_kernel", "conv_stride",
            "num_conv_pos_embeddings", "num_conv_pos_embedding_groups",
            "pad_token_id", "vocab_size",
        ]
        missing = [k for k in required if k not in d]
        if missing:
            raise JsonError("parse config.json", f"missing fields: {missing}")
        if d.get("model_type") not in _ENCODER_STYLES:
            raise InvalidInputError(
                f"model_type {d.get('model_type')!r} is not supported by the "
                "PyTorch port yet (wav2vec2 and wav2vec2-conformer only)"
            )
        kwargs = {k: d[k] for k in required}
        for opt in ["do_stable_layer_norm", "layer_norm_eps", "dtype",
                    "feat_extract_norm", "conv_bias", "rotary_embedding_base",
                    "max_source_positions", "conv_depthwise_kernel_size",
                    "hidden_act"]:
            if opt in d and d[opt] is not None:
                kwargs[opt] = d[opt]
        kwargs["encoder_style"] = _ENCODER_STYLES[d.get("model_type")]
        if kwargs["encoder_style"] == "conformer":
            # Wav2Vec2ConformerConfig allows position_embeddings_type=None
            # (position-free attention); normalize to "none"
            kwargs["position_embeddings_type"] = (
                d.get("position_embeddings_type") or "none"
            )
        cfg = cls(**kwargs)
        # the port runs the post-norm, group-norm wav2vec2 graph and the
        # conformer graph (layer-norm or group-norm frontend); no adapter
        conformer = cfg.encoder_style == "conformer"
        frontends = ("group", "layer") if conformer else ("group",)
        if d.get("add_adapter") or cfg.do_stable_layer_norm or (
            cfg.feat_extract_norm not in frontends
        ):
            raise InvalidInputError(
                "the PyTorch port runs only the post-norm, group-norm "
                "wav2vec2 graph and the wav2vec2-conformer graph so far (no "
                "stable-layer-norm, no layer-norm frontend outside the "
                "conformer, no adapter)"
            )
        if conformer and cfg.position_embeddings_type not in (
            "relative", "rotary", "none"
        ):
            raise InvalidInputError(
                f"position_embeddings_type {cfg.position_embeddings_type!r} "
                "is not supported (expected relative/rotary/none)"
            )
        return cfg

    @classmethod
    def load(cls, path: str | Path) -> "Wav2Vec2ModelConfig":
        try:
            data = Path(path).read_text()
        except OSError as e:
            raise IoError("read config.json", e) from e
        try:
            d = json.loads(data)
        except json.JSONDecodeError as e:
            raise JsonError("parse config.json", e) from e
        return cls.from_dict(d)

    def frame_stride_ms(self, sample_rate: int) -> float:
        """Frame stride in ms = product(conv_stride) / sample_rate * 1000
        (20 ms for wav2vec2 at 16 kHz)."""
        return self.frame_stride_samples() / sample_rate * 1000.0

    def frame_stride_samples(self) -> int:
        """Input samples per output frame — the chunk-alignment unit of the
        long-form path (320 for wav2vec2). The JAX package also covers the
        mel frontend and adapter downsampling; the port refuses both
        configs, so the conv strides are the whole product."""
        stride_samples = 1
        for s in self.conv_stride:
            stride_samples *= s
        return stride_samples

    def conv_output_length(self, num_samples: int) -> int:
        """Output frames T for `num_samples` input samples (per conv layer:
        floor((L - K) / stride) + 1)."""
        length = num_samples
        for k, s in zip(self.conv_kernel, self.conv_stride):
            length = (length - k) // s + 1
        return max(length, 0)


@dataclass(frozen=True)
class ExpansionPolicyConfig:
    """One blank-expansion policy's frame budgets."""

    name: str
    max_left_expansion_frames: int
    max_right_pullback_frames: int
    min_interior_silence_frames: int


@dataclass
class AlignerHyperParams:
    """Alignment tunables, with the JAX package's defaults."""

    expansion_policies: tuple[ExpansionPolicyConfig, ...] = (
        ExpansionPolicyConfig("balanced", 12, 6, 4),
        ExpansionPolicyConfig("conservative_start", 10, 2, 6),
        ExpansionPolicyConfig("aggressive_tail", 16, 4, 2),
    )
    weight_boundary_confidence: float = 3.2
    weight_boundary_shift: float = 0.8
    weight_pause_plausibility: float = 1.3
    large_gap_threshold_frames: int = 8
    overlap_penalty_per_frame: float = 12.0
    near_collapse_penalty: float = 4.0
    weight_geo_mean: float = 0.40
    weight_margin: float = 0.30
    weight_p10: float = 0.20
    weight_boundary: float = 0.10
    calibration_knots: tuple[tuple[float, float], ...] = (
        (0.00, 0.02), (0.20, 0.12), (0.35, 0.28), (0.50, 0.50),
        (0.65, 0.72), (0.80, 0.88), (0.95, 0.97), (1.00, 0.99),
    )
    # T*S below which the host numpy oracle runs instead of the device DP
    # (the JAX package's value, kept so both packages dispatch alike)
    kernel_dp_threshold: int = 25_000


def load_vocab(path: str | Path, single_char_only: bool = True) -> dict[str, int]:
    """Load HF vocab.json, keeping only single-character keys by default."""
    try:
        data = Path(path).read_text()
    except OSError as e:
        raise IoError("read vocab.json", e) from e
    try:
        raw = json.loads(data)
    except json.JSONDecodeError as e:
        raise JsonError("parse vocab.json", e) from e
    if single_char_only:
        return {k: int(v) for k, v in raw.items() if len(k) == 1}
    return {k: int(v) for k, v in raw.items()}
