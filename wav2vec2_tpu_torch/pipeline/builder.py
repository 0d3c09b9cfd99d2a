"""ForcedAlignerBuilder — wires config artifacts and stage implementations
(counterpart of `wav2vec2_tpu.pipeline.builder`).

- loads config.json (Wav2Vec2ModelConfig) and vocab.json (single-char keys);
- blank_id = pad_token_id, word_sep_id = vocab['|'] or 0, frame_stride_ms
  from the conv stride product;
- every stage is injectable, defaulting to CaseAwareTokenizer /
  ViterbiSequenceAligner / DefaultWordGrouper;
- the runtime backend is a TorchRuntimeBackend on `config.device`.
"""

from __future__ import annotations

from ..config import (
    DEFAULT_SAMPLE_RATE_HZ,
    AlignerHyperParams,
    Wav2Vec2Config,
    Wav2Vec2ModelConfig,
    load_vocab,
)
from .defaults import CaseAwareTokenizer, DefaultWordGrouper, ViterbiSequenceAligner
from .runtime import ForcedAligner
from .traits import RuntimeBackend, SequenceAligner, Tokenizer, WordGrouper


class ForcedAlignerBuilder:
    def __init__(self, config: Wav2Vec2Config | None = None):
        self.config = config or Wav2Vec2Config()
        self._runtime_backend: RuntimeBackend | None = None
        self._tokenizer: Tokenizer | None = None
        self._sequence_aligner: SequenceAligner | None = None
        self._word_grouper: WordGrouper | None = None
        self._hp: AlignerHyperParams | None = None
        self._backend_kwargs: dict = {}

    def with_runtime_backend(self, backend: RuntimeBackend) -> "ForcedAlignerBuilder":
        self._runtime_backend = backend
        return self

    def with_tokenizer(self, tokenizer: Tokenizer) -> "ForcedAlignerBuilder":
        self._tokenizer = tokenizer
        return self

    def with_sequence_aligner(self, aligner: SequenceAligner) -> "ForcedAlignerBuilder":
        self._sequence_aligner = aligner
        return self

    def with_word_grouper(self, grouper: WordGrouper) -> "ForcedAlignerBuilder":
        self._word_grouper = grouper
        return self

    def with_hyper_params(self, hp: AlignerHyperParams) -> "ForcedAlignerBuilder":
        self._hp = hp
        return self

    def with_backend_options(self, **kwargs) -> "ForcedAlignerBuilder":
        """Options forwarded to the runtime backend (compute_dtype,
        pad_multiple, device)."""
        self._backend_kwargs.update(kwargs)
        return self

    def build(self) -> ForcedAligner:
        model_cfg = Wav2Vec2ModelConfig.load(self.config.config_path)
        expected_sr = self.config.expected_sample_rate_hz or DEFAULT_SAMPLE_RATE_HZ
        vocab = load_vocab(self.config.vocab_path)
        hp = self._hp or AlignerHyperParams()
        if self._runtime_backend is not None:
            runtime_backend = self._runtime_backend
        else:
            from .model_runtime import TorchRuntimeBackend

            runtime_backend = TorchRuntimeBackend.from_config(
                self.config, model_cfg, **self._backend_kwargs
            )
        return ForcedAligner(
            runtime_backend=runtime_backend,
            vocab=vocab,
            blank_id=model_cfg.pad_token_id,
            word_sep_id=vocab.get("|", 0),
            frame_stride_ms=model_cfg.frame_stride_ms(expected_sr),
            expected_sample_rate_hz=expected_sr,
            tokenizer=self._tokenizer or CaseAwareTokenizer(),
            sequence_aligner=self._sequence_aligner or ViterbiSequenceAligner(hp),
            word_grouper=self._word_grouper or DefaultWordGrouper(hp),
            hp=hp,
        )
