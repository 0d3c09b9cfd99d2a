"""ForcedAligner runtime: normalize → forward → tokenize → Viterbi →
grouping (counterpart of `wav2vec2_tpu.pipeline.runtime`).

- empty samples or a blank transcript give an empty output;
- a sample-rate mismatch only warns;
- normalization is zero-mean/unit-variance with f64 accumulation and a
  1e-7 σ floor, skipped when the input carries a pre-normalized buffer;
- the min-frames guard rejects T < ceil(S/2) as InvalidInput;
- `align_profiled` brackets every stage with a device sync, and folds
  tokenization and residual time into group_ms so dp+conf+group ==
  align_ms exactly.

Log-probs on the device are recognised as torch tensors: DP and evidence
then run on the device and come back with one copy.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..align.grouping import ProfiledWordGroupingOutput, frame_evidence_from_log_probs
from ..config import AlignerHyperParams
from ..errors import InvalidInputError
from ..types import AlignmentInput, AlignmentOutput, UtteranceFrameStats
from .traits import ForwardOutput, RuntimeBackend, SequenceAligner, Tokenizer, WordGrouper

logger = logging.getLogger(__name__)


@dataclass
class AlignmentStageTimings:
    forward_ms: float = 0.0
    post_ms: float = 0.0
    dp_ms: float = 0.0
    group_ms: float = 0.0
    conf_ms: float = 0.0
    align_ms: float = 0.0
    total_ms: float = 0.0


@dataclass
class ProfiledAlignmentOutput:
    output: AlignmentOutput
    timings: AlignmentStageTimings
    num_frames_t: int
    state_len: int
    ts_product: int
    vocab_size: int
    dtype: str
    device: str
    frame_stride_ms: float


def normalize_audio(samples: np.ndarray) -> np.ndarray:
    """Zero-mean/unit-variance with f64 accumulation, σ floor 1e-7 (the
    same in-place f64 passes as the JAX package, bitwise)."""
    xd = np.asarray(samples, dtype=np.float32).astype(np.float64)
    mean = xd.mean()
    xd -= mean
    var = np.square(xd).mean()
    std = max(np.sqrt(var), 1e-7)
    xd /= std
    return xd.astype(np.float32)


def _utterance_frame_stats(path_states, tokens, blank_id, evidence):
    states = np.asarray(path_states)
    if states.size == 0:
        return None
    tok = np.asarray(tokens)
    blank_ratio = float(np.mean(tok[states] == blank_id))
    entropy_mean = (
        float(np.asarray(evidence.entropy, dtype=np.float64).mean())
        if evidence.entropy is not None and len(evidence.entropy)
        else None
    )
    return UtteranceFrameStats(
        blank_frame_ratio=blank_ratio, token_entropy_mean=entropy_mean
    )


class ForcedAligner:
    def __init__(
        self,
        runtime_backend: RuntimeBackend,
        vocab: dict[str, int],
        blank_id: int,
        word_sep_id: int,
        frame_stride_ms: float,
        expected_sample_rate_hz: int,
        tokenizer: Tokenizer,
        sequence_aligner: SequenceAligner,
        word_grouper: WordGrouper,
        hp: AlignerHyperParams | None = None,
    ):
        self.runtime_backend = runtime_backend
        self.vocab = vocab
        self.blank_id = blank_id
        self.word_sep_id = word_sep_id
        self._frame_stride_ms = frame_stride_ms
        self.expected_sample_rate_hz = expected_sample_rate_hz
        self.tokenizer = tokenizer
        self.sequence_aligner = sequence_aligner
        self.word_grouper = word_grouper
        self.hp = hp or AlignerHyperParams()

    def frame_stride_ms(self) -> float:
        return self._frame_stride_ms

    def _normalized(self, input: AlignmentInput) -> np.ndarray:
        if input.normalized is not None:
            return np.asarray(input.normalized, dtype=np.float32)
        return normalize_audio(input.samples)

    def _check_input(self, input: AlignmentInput) -> bool:
        if len(input.samples) == 0 or not input.transcript.strip():
            return False
        if input.sample_rate_hz != self.expected_sample_rate_hz:
            logger.warning(
                "wav2vec2 aligner expects %d Hz, got %d Hz; quality may degrade",
                self.expected_sample_rate_hz, input.sample_rate_hz,
            )
        return True

    def _tokenize_checked(self, input: AlignmentInput, t_len: int):
        token_sequence = self.tokenizer.tokenize(
            input.transcript, self.vocab, self.blank_id, self.word_sep_id
        )
        min_frames = -(-len(token_sequence.tokens) // 2)
        if token_sequence.tokens and t_len < min_frames:
            raise InvalidInputError(
                f"audio too short for transcript: {t_len} frames < {min_frames} required"
            )
        return token_sequence

    def align(self, input: AlignmentInput) -> AlignmentOutput:
        if not self._check_input(input):
            return AlignmentOutput(words=[])
        forward_output = self.runtime_backend.infer(self._normalized(input))
        token_sequence = self._tokenize_checked(input, forward_output.t_len)
        if not token_sequence.tokens:
            return AlignmentOutput(words=[])
        path_states, evidence = self._path_and_evidence(forward_output, token_sequence)
        grouped = self._group(path_states, token_sequence, evidence)
        stats = _utterance_frame_stats(
            path_states, token_sequence.tokens, self.blank_id, evidence
        )
        return AlignmentOutput(words=grouped.words, frame_stats=stats)

    def _path_and_evidence(self, forward_output: ForwardOutput, token_sequence):
        """DP + evidence with as few device syncs as possible: the default
        sequence aligner runs both on the device with one copy back; other
        aligners (or the host oracle below the dispatch threshold) run the
        two-step sequence."""
        fused = getattr(self.sequence_aligner, "align_path_with_evidence", None)
        if fused is not None:
            res = fused(forward_output, token_sequence.tokens, self.blank_id)
            if res is not None:
                return res
        path_states = self.sequence_aligner.align_path(
            forward_output, token_sequence.tokens
        )
        evidence = self._frame_evidence(forward_output, token_sequence, path_states)
        return path_states, evidence

    def _group(self, path_states, token_sequence, evidence) -> ProfiledWordGroupingOutput:
        if hasattr(self.word_grouper, "group_words_profiled"):
            return self.word_grouper.group_words_profiled(
                path_states, token_sequence, evidence,
                self.blank_id, self.word_sep_id, self._frame_stride_ms,
            )
        words = self.word_grouper.group_words(
            path_states, token_sequence, evidence,
            self.blank_id, self.word_sep_id, self._frame_stride_ms,
        )
        return ProfiledWordGroupingOutput(words, 0.0, 0.0, 0.0)

    def _frame_evidence(self, forward_output, token_sequence, path_states):
        lp = forward_output.log_probs
        t_len = forward_output.t_len
        if isinstance(lp, torch.Tensor) and lp.device.type != "cpu":
            from ..ops.evidence import compute_frame_evidence_device

            path = np.zeros(lp.shape[0], np.int32)
            path[:t_len] = path_states
            tok = torch.tensor(token_sequence.tokens, dtype=torch.int32,
                               device=lp.device)
            return compute_frame_evidence_device(
                lp, tok, torch.from_numpy(path).to(lp.device), self.blank_id, t_len
            )
        if isinstance(lp, torch.Tensor):
            lp = lp.numpy()
        return frame_evidence_from_log_probs(
            np.asarray(lp)[:t_len], token_sequence.tokens, path_states, self.blank_id
        )

    def align_profiled(self, input: AlignmentInput) -> ProfiledAlignmentOutput:
        """Instrumented pass: device sync at every stage boundary;
        dp + conf + group == align_ms exactly."""
        backend = self.runtime_backend
        if not self._check_input(input):
            return self._empty_profiled()
        normalized = self._normalized(input)
        backend.synchronize()
        t_total0 = time.perf_counter()
        forward_output = backend.infer_profiled(normalized)

        t_align0 = time.perf_counter()
        token_sequence = self._tokenize_checked(input, forward_output.t_len)
        if not token_sequence.tokens:
            return self._empty_profiled()
        t0 = time.perf_counter()
        path_states, evidence = self._path_and_evidence(forward_output, token_sequence)
        dp_ms = (time.perf_counter() - t0) * 1000.0

        grouped = self._group(path_states, token_sequence, evidence)
        backend.synchronize()
        align_ms = (time.perf_counter() - t_align0) * 1000.0
        total_ms = (time.perf_counter() - t_total0) * 1000.0
        t_len, s_len = forward_output.t_len, len(token_sequence.tokens)
        return ProfiledAlignmentOutput(
            output=AlignmentOutput(
                words=grouped.words,
                frame_stats=_utterance_frame_stats(
                    path_states, token_sequence.tokens, self.blank_id, evidence
                ),
            ),
            timings=AlignmentStageTimings(
                forward_ms=forward_output.forward_ms,
                post_ms=forward_output.post_ms,
                dp_ms=dp_ms,
                group_ms=align_ms - dp_ms - grouped.conf_ms,
                conf_ms=grouped.conf_ms,
                align_ms=align_ms,
                total_ms=total_ms,
            ),
            num_frames_t=t_len,
            state_len=s_len,
            ts_product=t_len * s_len,
            vocab_size=forward_output.vocab_size,
            dtype=forward_output.dtype,
            device=backend.device_label(),
            frame_stride_ms=self._frame_stride_ms,
        )

    def _empty_profiled(self) -> ProfiledAlignmentOutput:
        return ProfiledAlignmentOutput(
            output=AlignmentOutput(words=[]),
            timings=AlignmentStageTimings(),
            num_frames_t=0,
            state_len=0,
            ts_product=0,
            vocab_size=0,
            dtype="",
            device=self.runtime_backend.device_label(),
            frame_stride_ms=self._frame_stride_ms,
        )
