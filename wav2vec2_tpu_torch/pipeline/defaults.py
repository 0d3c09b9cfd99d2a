"""Default pipeline stage implementations (counterpart of
`wav2vec2_tpu.pipeline.defaults`): CaseAwareTokenizer,
ViterbiSequenceAligner, DefaultWordGrouper."""

from __future__ import annotations

import numpy as np
import torch

from ..align import tokenization
from ..align.grouping import ProfiledWordGroupingOutput, group_into_words_profiled
from ..align.grouping.path_to_words import FrameEvidence
from ..config import AlignerHyperParams
from ..ops import viterbi_cuda, viterbi_ref
from ..ops.evidence import fused_path_evidence
from ..parallel.batching import _round_up_pow2
from ..types import TokenSequence, WordTiming
from .traits import ForwardOutput


class CaseAwareTokenizer:
    def tokenize(self, transcript, vocab, blank_id, word_sep_id) -> TokenSequence:
        return tokenization.build_token_sequence_case_aware(
            transcript, vocab, blank_id, word_sep_id
        )


class ViterbiSequenceAligner:
    """Banded CTC Viterbi with the JAX package's dispatch: below
    `kernel_dp_threshold` T·S the host numpy oracle runs; above it the
    device DP runs (the K1 kernel for CUDA log-probs, its plain PyTorch
    version for CPU ones). `force_backend` is None, "numpy" or "device".
    Every backend gives bit-identical paths."""

    def __init__(self, hp: AlignerHyperParams | None = None,
                 force_backend: str | None = None):
        if force_backend not in (None, "numpy", "device"):
            raise ValueError(f"unknown force_backend {force_backend!r}")
        self.hp = hp or AlignerHyperParams()
        self.force_backend = force_backend

    def _use_host(self, t_len: int, s_len: int) -> bool:
        if self.force_backend is not None:
            return self.force_backend == "numpy"
        return t_len * s_len < self.hp.kernel_dp_threshold

    @staticmethod
    def _device_inputs(forward_output: ForwardOutput, tokens: list[int]):
        lp = forward_output.log_probs
        if not isinstance(lp, torch.Tensor):
            lp = torch.from_numpy(np.ascontiguousarray(lp, dtype=np.float32))
        # tokens padded to a pow2 grid of 128, as the JAX path pads them
        tok = np.zeros(_round_up_pow2(len(tokens), 128), np.int32)
        tok[: len(tokens)] = tokens
        return lp, torch.from_numpy(tok).to(lp.device)

    def align_path(self, forward_output: ForwardOutput, tokens: list[int]) -> np.ndarray:
        t_len = forward_output.t_len
        if self._use_host(t_len, len(tokens)):
            lp = forward_output.log_probs
            lp = lp.cpu().numpy() if isinstance(lp, torch.Tensor) else np.asarray(lp)
            path = viterbi_ref.viterbi_numpy(lp[:t_len], np.asarray(tokens))
            return np.asarray([s for s, _ in path], dtype=np.int32)
        lp, tok = self._device_inputs(forward_output, tokens)
        path = viterbi_cuda.viterbi_single(lp, tok, t_len, len(tokens))
        return path[:t_len].cpu().numpy()

    def align_path_with_evidence(
        self, forward_output: ForwardOutput, tokens: list[int], blank_id: int
    ):
        """Latency path: DP + evidence on the device with a single copy back.
        Returns (path_states [t_len], FrameEvidence), or None when the
        dispatch picks the host oracle — the caller then runs the two-step
        path."""
        t_len = forward_output.t_len
        if self._use_host(t_len, len(tokens)):
            return None
        lp, tok = self._device_inputs(forward_output, tokens)
        return fused_path_evidence(lp, tok, t_len, len(tokens), blank_id)


class DefaultWordGrouper:
    def __init__(self, hp: AlignerHyperParams | None = None):
        self.hp = hp or AlignerHyperParams()

    def group_words(
        self,
        path_states: np.ndarray,
        token_sequence: TokenSequence,
        evidence: FrameEvidence,
        blank_id: int,
        word_sep_id: int,
        frame_stride_ms: float,
    ) -> list[WordTiming]:
        return self.group_words_profiled(
            path_states, token_sequence, evidence, blank_id, word_sep_id,
            frame_stride_ms,
        ).words

    def group_words_profiled(
        self,
        path_states: np.ndarray,
        token_sequence: TokenSequence,
        evidence: FrameEvidence,
        blank_id: int,
        word_sep_id: int,
        frame_stride_ms: float,
    ) -> ProfiledWordGroupingOutput:
        path = [(int(s), t) for t, s in enumerate(path_states)]
        return group_into_words_profiled(
            path,
            token_sequence.tokens,
            token_sequence.chars,
            token_sequence.normalized_words,
            evidence,
            blank_id,
            word_sep_id,
            frame_stride_ms,
            self.hp,
        )
