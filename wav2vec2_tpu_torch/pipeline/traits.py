"""Pipeline stage interfaces (counterpart of `wav2vec2_tpu.pipeline.traits`).

Every stage is swappable through the builder. `ForwardOutput` is the
hand-off from the acoustic model to the aligner: its log-probs are a torch
tensor that stays on the device through Viterbi and evidence extraction,
or a host numpy array.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Protocol, runtime_checkable

import numpy as np

from ..align.grouping.path_to_words import FrameEvidence
from ..types import TokenSequence, WordTiming


@dataclass
class ForwardOutput:
    """Acoustic model output: log-softmaxed log-probs [T_pad, V] and the
    number of valid frames `t_len` (≤ T_pad)."""

    log_probs: "np.ndarray | object"
    t_len: int
    vocab_size: int
    dtype: str = "float32"
    forward_ms: float = 0.0
    post_ms: float = 0.0


@runtime_checkable
class RuntimeBackend(Protocol):
    """Acoustic model runtime."""

    def infer(self, normalized: np.ndarray) -> ForwardOutput: ...

    def infer_profiled(self, normalized: np.ndarray) -> ForwardOutput:
        """Like infer, but fills forward_ms/post_ms with device-synced wall
        times."""
        ...

    def synchronize(self) -> None: ...

    def device_label(self) -> str: ...


@runtime_checkable
class Tokenizer(Protocol):
    def tokenize(
        self, transcript: str, vocab: dict[str, int], blank_id: int, word_sep_id: int
    ) -> TokenSequence: ...


@runtime_checkable
class SequenceAligner(Protocol):
    """CTC DP: returns the state path [t_len] as int states."""

    def align_path(
        self, forward_output: ForwardOutput, tokens: list[int]
    ) -> np.ndarray: ...


@runtime_checkable
class WordGrouper(Protocol):
    def group_words(
        self,
        path_states: np.ndarray,
        token_sequence: TokenSequence,
        evidence: FrameEvidence,
        blank_id: int,
        word_sep_id: int,
        frame_stride_ms: float,
    ) -> list[WordTiming]: ...
