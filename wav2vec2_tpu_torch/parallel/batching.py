"""Batched alignment engine (counterpart of `wav2vec2_tpu.parallel.batching`).

Utterances are bucketed by (audio length, token length), padded, and each
bucket goes through forward → log-softmax → the K1 Viterbi kernel →
per-frame evidence on the device. Only T-length vectors (path, emission
log-prob, margin, blank prob, entropy) come back to the host; grouping runs
there per utterance.

Not ported yet: `align_stream`, the device mesh, int8 serving and the
flash-attention switch.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..align.grouping import group_into_words
from ..align.grouping.path_to_words import FrameEvidence
from ..align.tokenization import build_token_sequence_case_aware
from ..config import AlignerHyperParams, Wav2Vec2ModelConfig
from ..errors import InvalidInputError
from ..models.ctc_model import frame_lengths, log_softmax_logits, wav2vec2_forward
from ..models.params import cast_compute_weights_bf16, params_to_device
from ..ops import viterbi_cuda
from ..ops.evidence import evidence_batch
from ..pipeline.runtime import _utterance_frame_stats, normalize_audio
from ..types import AlignmentOutput

logger = logging.getLogger(__name__)


def _round_up(x: int, m: int) -> int:
    return max(-(-x // m) * m, m)


def _round_up_pow2(x: int, m: int) -> int:
    """Round x up to m·2^k — a geometric padding grid."""
    n = m
    while n < x:
        n *= 2
    return n


def _pad_len(x: int, m: int, scheme: str) -> int:
    if scheme == "pow2":
        return _round_up_pow2(x, m)
    if scheme == "linear":
        return _round_up(x, m)
    raise ValueError(f"unknown bucket scheme: {scheme!r}")


def _pad_batch_rows(b_target: int, *arrays):
    """Pad the batch dim to b_target by repeating each array's last row
    (duplicate work whose results callers ignore); keeps the batch dim on a
    power-of-two grid."""
    out = []
    for a in arrays:
        pad = b_target - a.shape[0]
        out.append(
            np.concatenate([a, np.repeat(a[-1:], pad, axis=0)], axis=0)
            if pad > 0 else a
        )
    return out


@dataclass
class Bucket:
    """One padded batch of utterance indices sharing (n_pad, s_pad)."""

    indices: list[int]
    n_pad: int
    s_pad: int


def bucket_utterances(
    audio_lens: Sequence[int],
    token_lens: Sequence[int],
    audio_multiple: int = 16000,
    token_multiple: int = 128,
    max_batch: int = 64,
    scheme: str = "pow2",
) -> list[Bucket]:
    """Group utterances into padded (n_pad, s_pad) buckets. Padding is exact
    (masked model + banded DP). scheme="pow2" rounds lengths up on a
    geometric grid (multiple·2^k); "linear" to the next multiple."""
    groups: dict[tuple[int, int], list[int]] = {}
    for i, (n, s) in enumerate(zip(audio_lens, token_lens)):
        key = (_pad_len(n, audio_multiple, scheme),
               _pad_len(s, token_multiple, scheme))
        groups.setdefault(key, []).append(i)
    buckets = []
    for (n_pad, s_pad), idxs in sorted(groups.items()):
        for i in range(0, len(idxs), max_batch):
            buckets.append(Bucket(idxs[i : i + max_batch], n_pad, s_pad))
    return buckets


def _normalize_batch(audio: torch.Tensor, audio_lens: torch.Tensor) -> torch.Tensor:
    """On-device zero-mean/unit-variance per utterance over the valid
    samples, padded region zeroed, f32 two-pass statistics. Accepts int16
    audio (half the host→device bytes of f32)."""
    x = audio.float()
    m = (torch.arange(x.shape[1], device=x.device)[None, :]
         < audio_lens[:, None]).float()
    cnt = torch.clamp(audio_lens.float(), min=1.0)[:, None]
    mean = torch.sum(x * m, dim=1, keepdim=True) / cnt
    centered = (x - mean) * m
    var = torch.sum(centered * centered, dim=1, keepdim=True) / cnt
    std = torch.clamp(torch.sqrt(var), min=1e-7)
    return centered / std


def _as_device(x, dtype, device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device=device, dtype=dtype or x.dtype)


class BatchAligner:
    """High-throughput batch alignment on one torch device.

    `params` is the port's parameter tree (models.params), on any device:
    it is moved to `device` and, at bf16, its compute weights are stored in
    bf16."""

    def __init__(
        self,
        model_cfg: Wav2Vec2ModelConfig,
        params: dict,
        vocab: dict[str, int],
        compute_dtype: str = "bfloat16",
        device: str | torch.device = "cuda",
        hp: AlignerHyperParams | None = None,
        sample_rate_hz: int = 16000,
        normalize_on_device: bool = False,
    ):
        if compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unsupported compute dtype {compute_dtype!r}")
        self.device = torch.device(device)
        self.cfg = model_cfg
        self.compute_dtype = (
            torch.float32 if compute_dtype == "float32" else torch.bfloat16
        )
        params = params_to_device(params, self.device)
        if self.compute_dtype == torch.bfloat16:
            params = cast_compute_weights_bf16(params)
        self.params = params
        self.vocab = vocab
        self.blank_id = model_cfg.pad_token_id
        self.word_sep_id = vocab.get("|", 0)
        self.stride_ms = model_cfg.frame_stride_ms(sample_rate_hz)
        self.hp = hp or AlignerHyperParams()
        self.normalize_on_device = normalize_on_device

    def _tokenize(self, transcript: str):
        return build_token_sequence_case_aware(
            transcript, self.vocab, self.blank_id, self.word_sep_id
        )

    @torch.inference_mode()
    def submit_padded_batch(self, audio, audio_lens, tokens, s_lens,
                            return_log_probs=False):
        """Enqueue one padded batch: audio [B, N_pad] (pre-normalized f32,
        or raw int16/f32 with normalize_on_device), audio_lens [B], tokens
        [B, S_pad], s_lens [B], as numpy arrays or tensors. Returns device
        tensors (paths, t_lens, emit_lp, margin, blank_prob, entropy[,
        log_probs]) without synchronising."""
        dev = self.device
        audio = _as_device(audio, None, dev)
        audio_lens = _as_device(audio_lens, torch.int32, dev)
        tokens = _as_device(tokens, torch.int32, dev).contiguous()
        s_lens = _as_device(s_lens, torch.int32, dev)
        if self.normalize_on_device:
            audio = _normalize_batch(audio, audio_lens)
        logits = wav2vec2_forward(
            self.params, audio, self.cfg, audio_lens=audio_lens,
            compute_dtype=self.compute_dtype,
        )
        log_probs = log_softmax_logits(logits).contiguous()
        t_lens = frame_lengths(self.cfg, audio_lens).to(torch.int32)
        paths = viterbi_cuda.viterbi_batch(log_probs, tokens, t_lens, s_lens)
        out = (paths, t_lens, *evidence_batch(log_probs, tokens, paths, self.blank_id))
        return out + (log_probs,) if return_log_probs else out

    def align_padded_batch(self, audio, audio_lens, tokens, s_lens):
        """Host tuples (paths, t_lens, emit_lp, margin, blank_prob,
        entropy)."""
        out = self.submit_padded_batch(audio, audio_lens, tokens, s_lens)
        return tuple(x.cpu().numpy() for x in out)

    def group_batch(self, seqs, handles) -> list[AlignmentOutput]:
        """Copy one submitted batch's vectors to the host and group the
        first len(seqs) rows (seqs[j] is row j's TokenSequence)."""
        paths, t_lens, emit_lp, margin, blank_prob, entropy = (
            h.cpu().numpy() for h in handles[:6]
        )
        outputs = []
        for j, seq in enumerate(seqs):
            t_i = int(t_lens[j])
            ev = FrameEvidence(
                emit_lp=emit_lp[j, :t_i],
                margin=margin[j, :t_i],
                blank_prob=blank_prob[j, :t_i].astype(np.float64),
                entropy=entropy[j, :t_i],
            )
            words = group_into_words(
                paths[j, :t_i], seq.tokens, seq.chars, seq.normalized_words,
                ev, self.blank_id, self.word_sep_id, self.stride_ms, self.hp,
            )
            stats = _utterance_frame_stats(paths[j, :t_i], seq.tokens, self.blank_id, ev)
            outputs.append(AlignmentOutput(words=words, frame_stats=stats))
        return outputs

    def align_utterances(
        self,
        audios: Sequence[np.ndarray],
        transcripts: Sequence[str],
        audio_multiple: int = 16000,
        token_multiple: int = 128,
        max_batch: int = 64,
        bucket_scheme: str = "pow2",
        pad_batch: bool = True,
    ) -> list[AlignmentOutput]:
        """Full path: normalize, tokenize, bucket, batch-align, group.
        Padding is exact — outputs are identical under any bucketing."""
        seqs = [self._tokenize(t) for t in transcripts]
        lens = [len(a) for a in audios]
        s_lens = [len(s.tokens) for s in seqs]
        outputs: list[AlignmentOutput | None] = [None] * len(audios)

        active, active_lens, active_slens = [], [], []
        for i, (n, seq) in enumerate(zip(lens, seqs)):
            if n == 0 or not transcripts[i].strip() or not seq.normalized_words:
                outputs[i] = AlignmentOutput(words=[])
                continue
            t_i = self.cfg.conv_output_length(n)
            min_frames = -(-len(seq.tokens) // 2)
            if t_i < min_frames:
                raise InvalidInputError(
                    f"utterance {i}: audio too short for transcript: "
                    f"{t_i} frames < {min_frames} required"
                )
            active.append(i)
            active_lens.append(n)
            active_slens.append(len(seq.tokens))

        buckets = bucket_utterances(
            active_lens, active_slens, audio_multiple, token_multiple,
            max_batch, scheme=bucket_scheme,
        )
        for bucket in buckets:
            bucket.indices = [active[j] for j in bucket.indices]

        def submit(bucket: Bucket):
            b = len(bucket.indices)
            dtype = (np.asarray(audios[bucket.indices[0]]).dtype
                     if self.normalize_on_device else np.float32)
            audio = np.zeros((b, bucket.n_pad), dtype)
            tokens = np.zeros((b, bucket.s_pad), np.int32)
            a_l = np.zeros(b, np.int32)
            s_l = np.zeros(b, np.int32)
            for j, i in enumerate(bucket.indices):
                audio[j, : lens[i]] = (
                    audios[i] if self.normalize_on_device
                    else normalize_audio(audios[i])
                )
                tokens[j, : s_lens[i]] = seqs[i].tokens
                a_l[j] = lens[i]
                s_l[j] = s_lens[i]
            if pad_batch:
                audio, a_l, tokens, s_l = _pad_batch_rows(
                    min(max_batch, _round_up_pow2(b, 1)), audio, a_l, tokens, s_l
                )
            return self.submit_padded_batch(audio, a_l, tokens, s_l)

        def drain(bucket: Bucket, handles: tuple):
            grouped = self.group_batch([seqs[i] for i in bucket.indices], handles)
            for i, out in zip(bucket.indices, grouped):
                outputs[i] = out

        # enqueue device work up to `max_in_flight` buckets ahead; group on
        # the host as results drain
        max_in_flight = 4
        in_flight: list[tuple[Bucket, tuple]] = []
        t_start = time.perf_counter()
        for bucket in buckets:
            in_flight.append((bucket, submit(bucket)))
            if len(in_flight) >= max_in_flight:
                drain(*in_flight.pop(0))
        while in_flight:
            drain(*in_flight.pop(0))
        if buckets:
            audio_sec = sum(active_lens) / 16000.0
            elapsed = time.perf_counter() - t_start
            logger.info(
                "aligned %d utterances (%.1f s audio) in %d buckets, %.2f s",
                len(active), audio_sec, len(buckets), elapsed,
            )
        return [o if o is not None else AlignmentOutput(words=[]) for o in outputs]
