"""Model-family presets (the north-star configs, BASELINE.json):

- wav2vec2-base-960h: post-norm encoder, GroupNorm feature extractor
  (do_stable_layer_norm=False, feat_extract_norm="group", conv_bias=False);
- wav2vec2-large-960h-lv60: pre-norm encoder, per-layer LayerNorm
  (do_stable_layer_norm=True, feat_extract_norm="layer", conv_bias=True);
- xlsr-53: large geometry, multilingual CTC vocab sizes vary per fine-tune.

These mirror the HF config.json values the reference's loader reads
(config.rs:30-76); `Wav2Vec2ModelConfig.load` on a real checkpoint dir is
always authoritative — presets exist for tests, benchmarks, and random-init
experiments.
"""

from __future__ import annotations

from ..config import Wav2Vec2ModelConfig

_CONV_7 = dict(
    conv_kernel=[10, 3, 3, 3, 3, 2, 2],
    conv_stride=[5, 2, 2, 2, 2, 2, 2],
    num_conv_pos_embeddings=128,
    num_conv_pos_embedding_groups=16,
)


def wav2vec2_base_960h(vocab_size: int = 32) -> Wav2Vec2ModelConfig:
    return Wav2Vec2ModelConfig.from_dict(
        dict(
            hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
            intermediate_size=3072, conv_dim=[512] * 7, **_CONV_7,
            pad_token_id=0, vocab_size=vocab_size,
            do_stable_layer_norm=False, feat_extract_norm="group",
            conv_bias=False,
        )
    )


def wav2vec2_large_960h_lv60(vocab_size: int = 32) -> Wav2Vec2ModelConfig:
    return Wav2Vec2ModelConfig.from_dict(
        dict(
            hidden_size=1024, num_hidden_layers=24, num_attention_heads=16,
            intermediate_size=4096, conv_dim=[512] * 7, **_CONV_7,
            pad_token_id=0, vocab_size=vocab_size,
            do_stable_layer_norm=True, feat_extract_norm="layer",
            conv_bias=True,
        )
    )


def xlsr_53(vocab_size: int) -> Wav2Vec2ModelConfig:
    """XLSR-53 fine-tunes share the -large geometry; vocab size depends on
    the target language's CTC head."""
    return wav2vec2_large_960h_lv60(vocab_size)


def hubert_base_ls960(vocab_size: int = 32) -> Wav2Vec2ModelConfig:
    """HuBERT's CTC graph is wav2vec2's with a different weight prefix and
    no pre-projection LayerNorm on some fine-tunes (HubertConfig
    feat_proj_layer_norm); hubert-base keeps it on."""
    return Wav2Vec2ModelConfig.from_dict(
        dict(
            hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
            intermediate_size=3072, conv_dim=[512] * 7, **_CONV_7,
            pad_token_id=0, vocab_size=vocab_size,
            do_stable_layer_norm=False, feat_extract_norm="group",
            conv_bias=False, feat_proj_layer_norm=True,
        )
    )


def hubert_large_ls960_ft(vocab_size: int = 32) -> Wav2Vec2ModelConfig:
    return Wav2Vec2ModelConfig.from_dict(
        dict(
            hidden_size=1024, num_hidden_layers=24, num_attention_heads=16,
            intermediate_size=4096, conv_dim=[512] * 7, **_CONV_7,
            pad_token_id=0, vocab_size=vocab_size,
            do_stable_layer_norm=True, feat_extract_norm="layer",
            conv_bias=True, feat_proj_layer_norm=True,
        )
    )


def data2vec_audio_base_960h(vocab_size: int = 32) -> Wav2Vec2ModelConfig:
    """data2vec-audio: LayerNorm on every extractor conv, post-norm encoder,
    and a 19-layer stack of kernel-19 grouped positional convs."""
    return Wav2Vec2ModelConfig.from_dict(
        dict(
            hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
            intermediate_size=3072, conv_dim=[512] * 7,
            conv_kernel=[10, 3, 3, 3, 3, 2, 2],
            conv_stride=[5, 2, 2, 2, 2, 2, 2],
            num_conv_pos_embeddings=19, num_conv_pos_embedding_groups=16,
            conv_pos_kernel_size=19, pad_token_id=0, vocab_size=vocab_size,
            do_stable_layer_norm=False, feat_extract_norm="layer",
            conv_bias=False, model_type="data2vec-audio",
        )
    )


def mms_1b(vocab_size: int) -> Wav2Vec2ModelConfig:
    """facebook/mms-1b-all geometry: 48-layer pre-norm encoder with
    per-language attention adapters (adapter_attn_dim=16); vocab size is
    per-language (export with --target-lang to merge adapter + lm_head)."""
    return Wav2Vec2ModelConfig.from_dict(
        dict(
            hidden_size=1280, num_hidden_layers=48, num_attention_heads=16,
            intermediate_size=5120, conv_dim=[512] * 7, **_CONV_7,
            pad_token_id=0, vocab_size=vocab_size,
            do_stable_layer_norm=True, feat_extract_norm="layer",
            conv_bias=True, adapter_attn_dim=16,
        )
    )


def wavlm_base_plus(vocab_size: int = 32) -> Wav2Vec2ModelConfig:
    """WavLM: wav2vec2-base geometry + gated relative-position-bias
    attention (num_buckets=320, max_bucket_distance=800)."""
    return Wav2Vec2ModelConfig.from_dict(
        dict(
            hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
            intermediate_size=3072, conv_dim=[512] * 7, **_CONV_7,
            pad_token_id=0, vocab_size=vocab_size,
            do_stable_layer_norm=False, feat_extract_norm="group",
            conv_bias=False, model_type="wavlm",
        )
    )


def wavlm_large(vocab_size: int = 32) -> Wav2Vec2ModelConfig:
    return Wav2Vec2ModelConfig.from_dict(
        dict(
            hidden_size=1024, num_hidden_layers=24, num_attention_heads=16,
            intermediate_size=4096, conv_dim=[512] * 7, **_CONV_7,
            pad_token_id=0, vocab_size=vocab_size,
            do_stable_layer_norm=True, feat_extract_norm="layer",
            conv_bias=True, model_type="wavlm",
        )
    )


def mhubert_147(vocab_size: int = 32) -> Wav2Vec2ModelConfig:
    """utter-project/mHuBERT-147 fine-tunes: hubert-base geometry with
    conv_pos_batch_norm=true (inference BatchNorm on the pos-conv input,
    folded to a per-channel affine at load — models/params.py)."""
    return Wav2Vec2ModelConfig.from_dict(
        dict(
            hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
            intermediate_size=3072, conv_dim=[512] * 7, **_CONV_7,
            pad_token_id=0, vocab_size=vocab_size,
            do_stable_layer_norm=False, feat_extract_norm="group",
            conv_bias=False, feat_proj_layer_norm=True,
            conv_pos_batch_norm=True,
        )
    )


def wav2vec2_large_adapter(vocab_size: int = 32) -> Wav2Vec2ModelConfig:
    """XLS-R-style add_adapter=true head: -large geometry + the HF-default
    GLU conv adapter (kernel 3, stride 2, 3 layers) downsampling the output
    frame rate 8x to 160 ms."""
    return Wav2Vec2ModelConfig.from_dict(
        dict(
            hidden_size=1024, num_hidden_layers=24, num_attention_heads=16,
            intermediate_size=4096, conv_dim=[512] * 7, **_CONV_7,
            pad_token_id=0, vocab_size=vocab_size,
            do_stable_layer_norm=True, feat_extract_norm="layer",
            conv_bias=True, add_adapter=True, adapter_kernel_size=3,
            adapter_stride=2, num_adapter_layers=3,
        )
    )


_SEW_FE = dict(
    # SEW's 13-layer mixed-stride extractor (transformers SEWConfig
    # defaults; the asapp CTC fine-tunes keep this structure)
    conv_dim=[64, 128, 128, 128, 128, 256, 256, 256, 256, 512, 512, 512, 512],
    conv_kernel=[10, 3, 1, 3, 1, 3, 1, 3, 1, 2, 1, 2, 1],
    conv_stride=[5, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1],
    num_conv_pos_embeddings=128,
    num_conv_pos_embedding_groups=16,
)


def sew_base(vocab_size: int = 32) -> Wav2Vec2ModelConfig:
    """SEW (squeezed encoder, transformers SEWConfig defaults): the encoder
    runs at a squeeze_factor=2-pooled frame rate and a linear upsampler
    restores the 20 ms conv rate."""
    return Wav2Vec2ModelConfig.from_dict(
        dict(
            hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
            intermediate_size=3072, **_SEW_FE,
            pad_token_id=0, vocab_size=vocab_size,
            do_stable_layer_norm=False, feat_extract_norm="group",
            conv_bias=False, model_type="sew", squeeze_factor=2,
        )
    )


def sew_d_base(vocab_size: int = 32) -> Wav2Vec2ModelConfig:
    """SEW-D (transformers SEWDConfig defaults): SEW's squeeze plumbing +
    DeBERTa-v2 disentangled attention; encoder layer_norm_eps 1e-7 while
    the feature path keeps 1e-5."""
    return Wav2Vec2ModelConfig.from_dict(
        dict(
            hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
            intermediate_size=3072, **_SEW_FE,
            pad_token_id=0, vocab_size=vocab_size,
            do_stable_layer_norm=False, feat_extract_norm="group",
            conv_bias=False, model_type="sew-d", squeeze_factor=2,
            layer_norm_eps=1e-7, position_buckets=256,
            max_position_embeddings=512,
        )
    )


def wav2vec2_conformer_rope_large_960h(vocab_size: int = 32) -> Wav2Vec2ModelConfig:
    """facebook/wav2vec2-conformer-rope-large-960h-ft: conformer blocks
    (FFN-half / attn / depthwise-conv module / FFN-half) with rotary
    position embeddings and swish activations."""
    return Wav2Vec2ModelConfig.from_dict(
        dict(
            hidden_size=1024, num_hidden_layers=24, num_attention_heads=16,
            intermediate_size=4096, conv_dim=[512] * 7, **_CONV_7,
            pad_token_id=0, vocab_size=vocab_size,
            feat_extract_norm="layer", conv_bias=True,
            model_type="wav2vec2-conformer",
            position_embeddings_type="rotary", hidden_act="swish",
            conv_depthwise_kernel_size=31,
        )
    )


def wav2vec2_conformer_rel_pos_large_960h(vocab_size: int = 32) -> Wav2Vec2ModelConfig:
    """facebook/wav2vec2-conformer-rel-pos-large-960h-ft: same geometry with
    Transformer-XL relative position attention (linear_pos + pos_bias_u/v)."""
    return Wav2Vec2ModelConfig.from_dict(
        dict(
            hidden_size=1024, num_hidden_layers=24, num_attention_heads=16,
            intermediate_size=4096, conv_dim=[512] * 7, **_CONV_7,
            pad_token_id=0, vocab_size=vocab_size,
            feat_extract_norm="layer", conv_bias=True,
            model_type="wav2vec2-conformer",
            position_embeddings_type="relative", hidden_act="swish",
            conv_depthwise_kernel_size=31, max_source_positions=5000,
        )
    )


def unispeech_sat_base_100h(vocab_size: int = 32) -> Wav2Vec2ModelConfig:
    """microsoft/unispeech-sat-base-100h-libri-ft: wav2vec2-base CTC graph
    exactly (transformers modular_unispeech_sat.py inherits every module);
    only the checkpoint prefix differs (models/params.py)."""
    return Wav2Vec2ModelConfig.from_dict(
        dict(
            hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
            intermediate_size=3072, conv_dim=[512] * 7, **_CONV_7,
            pad_token_id=0, vocab_size=vocab_size,
            do_stable_layer_norm=False, feat_extract_norm="group",
            conv_bias=False, model_type="unispeech-sat",
        )
    )


def unispeech_large_phoneme(vocab_size: int) -> Wav2Vec2ModelConfig:
    """microsoft/unispeech-1350-en-*-ft multilingual phoneme-CTC fine-tunes
    (large pre-norm geometry; vocab is a phoneme set — pair with the CLI's
    --units phoneme mode)."""
    return Wav2Vec2ModelConfig.from_dict(
        dict(
            hidden_size=1024, num_hidden_layers=24, num_attention_heads=16,
            intermediate_size=4096, conv_dim=[512] * 7, **_CONV_7,
            pad_token_id=0, vocab_size=vocab_size,
            do_stable_layer_norm=True, feat_extract_norm="layer",
            conv_bias=True, model_type="unispeech",
        )
    )


def w2v_bert_2_0(vocab_size: int = 32) -> Wav2Vec2ModelConfig:
    """facebook/w2v-bert-2.0 CTC fine-tunes (the Seamless speech encoder,
    580M params): log-mel frontend (no conv stack), conformer blocks with
    relative_key clamped-distance attention and causal depthwise convs,
    plus the stride-2 conformer adapter the published CTC fine-tuning
    recipe enables (frames are 40 ms with it, 20 ms without)."""
    return Wav2Vec2ModelConfig.from_dict(
        dict(
            model_type="wav2vec2-bert",
            hidden_size=1024, num_hidden_layers=24, num_attention_heads=16,
            intermediate_size=4096, pad_token_id=0, vocab_size=vocab_size,
            position_embeddings_type="relative_key",
            left_max_position_embeddings=64,
            right_max_position_embeddings=8,
            conv_depthwise_kernel_size=31, hidden_act="swish",
            feature_projection_input_dim=160,
            add_adapter=True, adapter_kernel_size=3, adapter_stride=2,
            num_adapter_layers=1,
        )
    )


PRESETS = {
    "wav2vec2-base-960h": wav2vec2_base_960h,
    "wav2vec2-large-960h-lv60": wav2vec2_large_960h_lv60,
    "xlsr-53": xlsr_53,
    "hubert-base-ls960": hubert_base_ls960,
    "hubert-large-ls960-ft": hubert_large_ls960_ft,
    "data2vec-audio-base-960h": data2vec_audio_base_960h,
    "mms-1b": mms_1b,
    "wavlm-base-plus": wavlm_base_plus,
    "wavlm-large": wavlm_large,
    "mhubert-147": mhubert_147,
    "wav2vec2-large-adapter": wav2vec2_large_adapter,
    "sew-base": sew_base,
    "sew-d-base": sew_d_base,
    "wav2vec2-conformer-rope-large-960h": wav2vec2_conformer_rope_large_960h,
    "wav2vec2-conformer-rel-pos-large-960h":
        wav2vec2_conformer_rel_pos_large_960h,
    "unispeech-sat-base-100h": unispeech_sat_base_100h,
    "unispeech-large-phoneme": unispeech_large_phoneme,
    "w2v-bert-2.0": w2v_bert_2_0,
}
