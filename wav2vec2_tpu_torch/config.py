"""Configuration types, carried over from `wav2vec2_tpu.config`.

The CTC model config of every family the JAX package runs: the wav2vec2
transformer encoder families (wav2vec2 post-norm and pre-norm with a
group-norm or layer-norm conv frontend, MMS attention adapters, the GLU
conv adapter, HuBERT, data2vec-audio, WavLM, mHuBERT's pos-conv BatchNorm,
UniSpeech and UniSpeech-SAT), SEW and SEW-D (the squeezed encoder, SEW-D
with DeBERTa disentangled attention), wav2vec2-conformer (relative, rotary
or no position embeddings) and w2v-BERT 2.0 (log-mel frontend, relative_key
conformer, BERT adapter); the aligner's tunables with the same defaults, and
the vocab loader. What the JAX package refuses (SEW-D without shared
attention keys, a position style outside an encoder's set) is refused when
the config is parsed instead of silently running the wrong graph.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

from .errors import InvalidInputError, IoError, JsonError

DEFAULT_SAMPLE_RATE_HZ = 16_000

# config.json model types the port runs. UniSpeech(-SAT) and HuBERT share
# wav2vec2's CTC graph (only the checkpoint prefix differs, models/params.py);
# the others set the style fields below.
_MODEL_TYPES = (None, "wav2vec2", "wav2vec2-conformer", "hubert", "data2vec-audio",
                "wavlm", "unispeech", "unispeech-sat", "sew", "sew-d", "wav2vec2-bert")
_STYLES = {"encoder_style": ("wav2vec2", "conformer", "sew", "conformer_bert"),
           "pos_conv_style": ("wav2vec2", "data2vec"),
           "attention_style": ("wav2vec2", "wavlm", "deberta"),
           "frontend_style": ("conv", "mel")}
# position styles each conformer encoder runs
POSITION_STYLES = {"conformer": ("relative", "rotary", "none"),
                    "conformer_bert": ("relative_key", "relative", "rotary", "none")}


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
    # HuBERT (HubertConfig.feat_proj_layer_norm): no LayerNorm before the
    # feature projection when false
    feat_proj_layer_norm: bool = True
    # data2vec-audio: the positional embedding is a stack of
    # num_conv_pos_embeddings grouped convs of kernel conv_pos_kernel_size
    # (non-affine LayerNorm + GELU each); set from model_type
    pos_conv_style: str = "wav2vec2"  # "wav2vec2" | "data2vec"
    conv_pos_kernel_size: int = 19
    # MMS (Wav2Vec2Config.adapter_attn_dim): per-layer attention adapters
    adapter_attn_dim: Optional[int] = None
    # WavLM: gated relative-position-bias attention; set from model_type
    attention_style: str = "wav2vec2"  # "wav2vec2" | "wavlm"
    num_buckets: int = 320
    max_bucket_distance: int = 800
    # mHuBERT-147 (HubertConfig.conv_pos_batch_norm): inference BatchNorm on
    # the pos-conv input, folded to a per-channel affine at load
    conv_pos_batch_norm: bool = False
    # the GLU conv adapter (Wav2Vec2Config.add_adapter): downsamples the
    # output frame rate by adapter_stride**num_adapter_layers
    add_adapter: bool = False
    adapter_kernel_size: int = 3
    adapter_stride: int = 2
    num_adapter_layers: int = 3
    output_hidden_size: Optional[int] = None
    # "wav2vec2" | "conformer" | "sew" | "conformer_bert" (set from
    # config.json's model_type)
    encoder_style: str = "wav2vec2"
    # SEW / SEW-D (SEWConfig.squeeze_factor): the encoder runs at a
    # squeeze_factor-pooled frame rate and an upsampler restores the conv
    # rate
    squeeze_factor: int = 1
    # SEW-D (SEWDConfig): DeBERTa-v2 attention knobs. The encoder's
    # layer_norm_eps is 1e-7 while the feature path keeps its own epsilon
    # (None = layer_norm_eps)
    feature_layer_norm_eps: Optional[float] = None
    position_buckets: int = 256
    max_position_embeddings: int = 512
    share_att_key: bool = True
    pos_att_type: tuple = ("p2c", "c2p")
    norm_rel_ebd: str = "layer_norm"
    # Wav2Vec2-Conformer (Wav2Vec2ConformerConfig): conformer blocks with
    # Transformer-XL relative, rotary or no position embeddings; hidden_act
    # is the FFN and conv-module activation (released checkpoints: "swish")
    position_embeddings_type: str = "relative"  # "relative"|"rotary"|"none"
    rotary_embedding_base: int = 10000
    max_source_positions: int = 5000
    conv_depthwise_kernel_size: int = 31
    hidden_act: str = "gelu"
    # w2v-BERT 2.0 (Wav2Vec2BertConfig): the log-mel frontend (models/mel.py)
    # in place of the conv stack, relative_key attention over clamped
    # distances, an optional intermediate FFN and the BERT adapter
    frontend_style: str = "conv"  # "conv" | "mel"
    feature_projection_input_dim: int = 160
    left_max_position_embeddings: int = 64
    right_max_position_embeddings: int = 8
    use_intermediate_ffn_before_adapter: bool = False
    adapter_act: str = "relu"
    # serving-path switch (not a checkpoint field): route attention through
    # the fused kernel (ops/flash_attention.py) where `use_flash` takes it:
    # the conformer's rel-pos attention, and any other style under
    # WAV2VEC2_FLASH_FORCE=1 (never a WavLM bias, SEW-D's disentangled
    # attention or relative_key). Set by BatchAligner on a CUDA device.
    use_flash_attention: bool = False

    @classmethod
    def from_dict(cls, d: dict) -> "Wav2Vec2ModelConfig":
        model_type = d.get("model_type")
        if model_type not in _MODEL_TYPES:
            raise InvalidInputError(
                f"model_type {model_type!r} is not supported (expected one of "
                f"{[t for t in _MODEL_TYPES if t]})"
            )
        if model_type == "wav2vec2-bert":
            # the mel frontend has no conv stack: Wav2Vec2BertConfig ships
            # none of the conv fields
            d = {"conv_dim": [], "conv_kernel": [], "conv_stride": [],
                 "num_conv_pos_embeddings": 0, "num_conv_pos_embedding_groups": 1, **d}
        required = [
            "hidden_size", "num_hidden_layers", "num_attention_heads",
            "intermediate_size", "conv_dim", "conv_kernel", "conv_stride",
            "num_conv_pos_embeddings", "num_conv_pos_embedding_groups",
            "pad_token_id", "vocab_size",
        ]
        missing = [k for k in required if k not in d]
        if missing:
            raise JsonError("parse config.json", f"missing fields: {missing}")
        kwargs = {k: d[k] for k in required}
        for opt in ["do_stable_layer_norm", "layer_norm_eps", "dtype",
                    "feat_extract_norm", "conv_bias", "feat_proj_layer_norm",
                    "pos_conv_style", "conv_pos_kernel_size",
                    "adapter_attn_dim", "attention_style", "num_buckets",
                    "max_bucket_distance", "conv_pos_batch_norm",
                    "add_adapter", "adapter_kernel_size", "adapter_stride",
                    "num_adapter_layers", "output_hidden_size",
                    "encoder_style", "squeeze_factor", "feature_layer_norm_eps",
                    "position_buckets", "max_position_embeddings", "share_att_key",
                    "norm_rel_ebd", "rotary_embedding_base",
                    "max_source_positions", "conv_depthwise_kernel_size",
                    "hidden_act", "feature_projection_input_dim",
                    "left_max_position_embeddings", "right_max_position_embeddings",
                    "use_intermediate_ffn_before_adapter", "adapter_act"]:
            if opt in d and d[opt] is not None:
                kwargs[opt] = d[opt]
        if d.get("pos_att_type") is not None:
            kwargs["pos_att_type"] = tuple(d["pos_att_type"])
        if model_type == "data2vec-audio":
            kwargs["pos_conv_style"] = "data2vec"
        if model_type == "wavlm":
            kwargs["attention_style"] = "wavlm"
        if model_type == "wav2vec2-conformer":
            kwargs["encoder_style"] = "conformer"
            # Wav2Vec2ConformerConfig allows position_embeddings_type=None
            # (position-free attention); normalize to "none"
            kwargs["position_embeddings_type"] = (
                d.get("position_embeddings_type") or "none"
            )
        if model_type in ("sew", "sew-d"):
            kwargs["encoder_style"] = "sew"
            kwargs.setdefault("squeeze_factor", 2)
        if model_type == "sew-d":
            kwargs["attention_style"] = "deberta"
            # SEWDConfig's feature-path norms keep their own epsilon
            kwargs.setdefault("feature_layer_norm_eps", 1e-5)
        if model_type == "wav2vec2-bert":
            kwargs["encoder_style"] = "conformer_bert"
            kwargs["frontend_style"] = "mel"
            kwargs["position_embeddings_type"] = (
                d.get("position_embeddings_type") or "none"
            )
            kwargs.setdefault("hidden_act", "swish")
            # Wav2Vec2BertConfig's defaults that differ from wav2vec2's
            kwargs.setdefault("num_adapter_layers", 1)
            if kwargs.get("output_hidden_size") is None:
                kwargs["output_hidden_size"] = d["hidden_size"]
        cfg = cls(**kwargs)
        for field, allowed in _STYLES.items():
            if getattr(cfg, field) not in allowed:
                raise InvalidInputError(
                    f"{field} {getattr(cfg, field)!r} is not supported by the "
                    f"PyTorch port (expected one of {allowed})"
                )
        if cfg.feat_extract_norm not in ("group", "layer"):
            raise InvalidInputError(
                f"feat_extract_norm {cfg.feat_extract_norm!r} is not supported "
                "(expected group/layer)"
            )
        allowed = POSITION_STYLES.get(cfg.encoder_style)
        if allowed and cfg.position_embeddings_type not in allowed:
            raise InvalidInputError(
                f"position_embeddings_type {cfg.position_embeddings_type!r} "
                f"is not supported by the {cfg.encoder_style} encoder "
                f"(expected {'/'.join(allowed)})"
            )
        if cfg.attention_style == "deberta" and not cfg.share_att_key:
            raise InvalidInputError(
                "SEW-D with share_att_key=false (separate pos_key/pos_query "
                "projections) is not supported; all released SEW-D checkpoints "
                "share the attention keys"
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
        """Frame stride in ms = frame_stride_samples() / sample_rate * 1000
        (20 ms for wav2vec2 and the mel frontend at 16 kHz; SEW's squeeze
        and upsample cancel)."""
        return self.frame_stride_samples() / sample_rate * 1000.0

    def frame_stride_samples(self) -> int:
        """Input samples per output frame — the chunk-alignment unit of the
        long-form path (320 for wav2vec2, and for the mel frontend's
        160-sample hops stacked by 2; × adapter_stride**num_adapter_layers
        with an adapter)."""
        if self.frontend_style == "mel":
            stride_samples = 160 * 2
        else:
            stride_samples = 1
            for s in self.conv_stride:
                stride_samples *= s
        if self.add_adapter:
            stride_samples *= self.adapter_stride ** self.num_adapter_layers
        return stride_samples

    def conv_output_length(self, num_samples: int) -> int:
        """Output frames T for `num_samples` input samples (per conv layer:
        floor((L - K) / stride) + 1; the mel frontend's 25 ms / 10 ms frames
        stacked by 2; conv adapter layers (L - 1) // stride + 1, exact for
        their kernel-3, pad-1 convs; the BERT adapter's layers
        (L + 2·(stride // 2) - K) // stride + 1)."""
        mel = self.frontend_style == "mel"
        if mel:
            length = (1 + (num_samples - 400) // 160) // 2 if num_samples >= 400 else 0
        else:
            length = num_samples
            for k, s in zip(self.conv_kernel, self.conv_stride):
                length = (length - k) // s + 1
        if self.add_adapter:
            for _ in range(self.num_adapter_layers):
                if mel:
                    length = (length + 2 * (self.adapter_stride // 2)
                              - self.adapter_kernel_size) // self.adapter_stride + 1
                else:
                    length = (length - 1) // self.adapter_stride + 1
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
