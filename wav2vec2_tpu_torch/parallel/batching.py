"""Batched alignment engine (counterpart of `wav2vec2_tpu.parallel.batching`).

Utterances are bucketed by (audio length, token length), padded, and each
bucket goes through forward → log-softmax → the Viterbi kernel (K1 at the
serving shapes; `ops.viterbi_cuda.select_tier` picks the tier) → per-frame
evidence on the device. Only T-length vectors (path, emission log-prob,
margin, blank prob, entropy) come back to the host; grouping runs there per
utterance. On a CUDA device those vectors are copied to pinned host buffers
on a side stream as soon as the batch's evidence is enqueued, so the copy
(and the host grouping that waits only for it) overlaps the next batch's
forward.

`align_stream` is the engine's one batch loop, bounded in memory, over
the same pair (`submit_padded_batch`, then `group_batch` once the batch's
host copies are done); `align_utterances` is that loop collected in input
order. `units="phoneme"` switches tokenization and grouping to the
phoneme-CTC mode.

`use_flash_attention` routes the conformer rel-pos attention through the
fused kernel K5 (`ops.flash_attention`); by default it is on on a CUDA
device, and off under `quantize_int8`, the int8 serving mode
(`models.quantize`), as in the JAX engine.

`mesh` (`parallel.mesh`, SPMD: every rank makes the same calls) shards
each batch's rows over the mesh's 'data' axis: the forward runs on
DTensors, K5 on each rank's (rows, heads) tile, and the Viterbi tier and
the evidence on each rank's rows; the T-length outputs are gathered, so
every rank gets every row, in order.

Normalization: on a CUDA device without a mesh, a batch's rows go to the
card raw, packed back to back in pinned memory and copied without a
stream sync; K7 (`ops.normalize`) normalizes them there with
`pipeline.runtime.normalize_audio`'s f64 statistics and writes the padded
[B, N_pad] audio. On the CPU and under a mesh each row is normalized on the
host by `normalize_audio` into a padded buffer. Either way the statistics
are `normalize_audio`'s.

Spans (`utils.spans`, recorded while a torch profiler runs): each batch
opens `batching.prepare` (the host side of `_submit_entries`: packing or
host normalization, padding, fill rows, with its sample counts),
`batching.enqueue` (all of `submit_padded_batch`; the forward's
`forward.frontend` opens inside it), `batching.copy_wait` (the wait for
its host copies) and `batching.group` (its per-row grouping).
"""

from __future__ import annotations

import logging
import time
from dataclasses import replace
from typing import Sequence

import numpy as np
import torch

from ..align.grouping import group_into_words
from ..align.grouping.path_to_words import FrameEvidence
from ..align.grouping.phoneme import group_into_phonemes
from ..align.tokenization import (
    build_token_sequence_case_aware,
    build_token_sequence_phoneme,
)
from ..config import AlignerHyperParams, Wav2Vec2ModelConfig
from ..errors import InvalidInputError
from ..models.ctc_model import (
    frame_lengths,
    log_softmax_logits,
    wav2vec2_forward,
    with_flash_spmd,
)
from ..models.params import cast_compute_weights_bf16, params_to_device
from ..models.quantize import quantize_encoder_int8
from ..ops import normalize, viterbi_cuda
from ..ops.evidence import evidence_batch
from ..pipeline.runtime import _utterance_frame_stats, normalize_audio
from ..types import AlignmentOutput
from ..utils.device import select_device
from ..utils.spans import span
from .mesh import (
    axis_size,
    batch_local,
    distribute_rows,
    dtensor_no_grad,
    full,
    mesh_device,
    mesh_size,
    place_params,
)

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


def _repeat_last_rows(pad: int, *arrays):
    """Each array (numpy or tensor) with its last row repeated `pad` more
    times."""
    out = []
    for a in arrays:
        if isinstance(a, torch.Tensor):
            out.append(torch.cat([a, a[-1:].expand(pad, *a.shape[1:])]))
        else:
            out.append(np.concatenate([a, np.repeat(a[-1:], pad, axis=0)]))
    return out


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


def _raw_rows_to_card(device: torch.device, mesh) -> bool:
    """Whether `_submit_entries` sends a batch's rows raw to the card for
    K7: on a CUDA device without a mesh."""
    return device.type == "cuda" and mesh is None


def _as_device(x, dtype, device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device=device, dtype=dtype or x.dtype)


class BatchHandles(tuple):
    """What `submit_padded_batch` returns: the device tensors (paths,
    t_lens, emit_lp, margin, blank_prob, entropy[, log_probs]), as a tuple.
    On a CUDA device it also carries `host`, pinned host copies of the first
    six, and `copied`, the event that marks those copies done; elsewhere
    both are None."""

    host: tuple[torch.Tensor, ...] | None = None
    copied: torch.cuda.Event | None = None


def _host_arrays(handles) -> tuple[np.ndarray, ...]:
    """The first six handles as numpy arrays: the pinned host copies once
    their event has completed, or a plain copy of each."""
    with span("batching.copy_wait"):
        if getattr(handles, "copied", None) is not None:
            handles.copied.synchronize()
            return tuple(h.numpy() for h in handles.host)
        return tuple(h.cpu().numpy() for h in handles[:6])


class BatchAligner:
    """High-throughput batch alignment on one torch device.

    `params` is the port's parameter tree (models.params), on any device:
    it is moved to `device` (`cuda` unless the caller asks for the CPU; no
    CUDA device raises), with `quantize_int8` its encoder projections are
    quantized (`models.quantize.quantize_encoder_int8`), and at bf16 its
    compute weights are stored in bf16, in that order.
    `use_flash_attention` sets the config's switch of that name: None
    (auto) turns it on on a CUDA device unless `quantize_int8`; True or
    False overrides a config that arrived with the switch set either
    way.

    `mesh` (a ('data', 'model') `DeviceMesh`, `parallel.mesh.make_mesh`)
    shards each batch's rows over 'data'. Every rank constructs the aligner
    and submits the same batches. The params keep their placement and dtype
    (no bf16 cast): DTensor leaves as the caller placed them
    (`parallel.mesh.shard_params` for tensor parallelism), any other leaf
    replicated; the device is the mesh's.

    Each utterance is normalized with `pipeline.runtime.normalize_audio`'s
    f64 statistics: on the card by K7 (`ops.normalize`) where the device is
    CUDA and there is no mesh, on the host elsewhere."""

    def __init__(
        self,
        model_cfg: Wav2Vec2ModelConfig,
        params: dict,
        vocab: dict[str, int],
        compute_dtype: str = "bfloat16",
        device: str | torch.device = "cuda",
        hp: AlignerHyperParams | None = None,
        sample_rate_hz: int = 16000,
        use_flash_attention: bool | None = None,
        units: str = "word",
        quantize_int8: bool = False,
        mesh=None,
    ):
        if compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unsupported compute dtype {compute_dtype!r}")
        self.device = select_device(device)
        if mesh is not None:
            if mesh.device_type != self.device.type:
                raise ValueError(f"a {mesh.device_type} mesh for device {device!r}")
            self.device = mesh_device(mesh)
        if use_flash_attention is None:
            # auto, as the JAX engine enables it on its accelerator; int8
            # serving keeps the plain attention, there as here
            use_flash_attention = self.device.type == "cuda" and not quantize_int8
        if model_cfg.use_flash_attention != bool(use_flash_attention):
            model_cfg = replace(model_cfg, use_flash_attention=bool(use_flash_attention))
        if use_flash_attention and mesh_size(mesh) > 1:
            # K5 launches per (rows, heads) tile of the mesh
            model_cfg = with_flash_spmd(model_cfg, mesh)
        self.cfg = model_cfg
        self.mesh = mesh
        self.compute_dtype = (
            torch.float32 if compute_dtype == "float32" else torch.bfloat16
        )
        if mesh is None:
            params = params_to_device(params, self.device)
        if quantize_int8:
            # from the weights as given (f32 unless the caller cast them)
            params = quantize_encoder_int8(params)
        if mesh is not None:
            params = place_params(params, mesh)
        elif self.compute_dtype == torch.bfloat16:
            params = cast_compute_weights_bf16(params)
        self.params = params
        self.vocab = vocab
        self.blank_id = model_cfg.pad_token_id
        self.word_sep_id = vocab.get("|", 0)
        self.stride_ms = model_cfg.frame_stride_ms(sample_rate_hz)
        self.hp = hp or AlignerHyperParams()
        self._raw_to_card = _raw_rows_to_card(self.device, mesh)
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        if units not in ("word", "phoneme"):
            raise ValueError(f"units must be 'word' or 'phoneme', got {units!r}")
        self.units = units

    def _tokenize(self, transcript: str):
        if self.units == "phoneme":
            return build_token_sequence_phoneme(
                transcript, self.vocab, self.blank_id, self.word_sep_id
            )
        return build_token_sequence_case_aware(
            transcript, self.vocab, self.blank_id, self.word_sep_id
        )

    def _group(self, path_states, seq, evidence):
        """Grouping dispatch: word mode runs the full grouping orchestrator
        (expansion + selection + calibration); phoneme mode emits raw
        per-state units (align/grouping/phoneme.py)."""
        if self.units == "phoneme":
            return group_into_phonemes(
                path_states, seq, evidence, self.blank_id, self.word_sep_id,
                self.stride_ms,
            )
        return group_into_words(
            path_states, seq.tokens, seq.chars, seq.normalized_words,
            evidence, self.blank_id, self.word_sep_id, self.stride_ms, self.hp,
        )

    @torch.inference_mode()
    def submit_padded_batch(self, audio, audio_lens, tokens, s_lens,
                            return_log_probs=False):
        """Enqueue one padded batch: audio [B, N_pad] f32, each row already
        normalized (`normalize_audio`, or `ops.normalize.normalize_rows` on
        the device), audio_lens [B], tokens [B, S_pad], s_lens [B], as numpy
        arrays or tensors; or audio an
        `ops.normalize.PackedRows` of raw rows (audio_lens its `lens`) with
        tokens and s_lens as pinned host tensors, all copied without a sync
        and normalized and padded on the device by K7. Returns
        `BatchHandles` of device tensors (paths, t_lens, emit_lp, margin,
        blank_prob, entropy[, log_probs]) without synchronising; on a CUDA
        device their host copies are already enqueued. Opens the span
        `batching.enqueue`."""
        with span("batching.enqueue"):
            dev = self.device
            if self.mesh is not None:
                with dtensor_no_grad():
                    return self._submit_sharded(audio, audio_lens, tokens, s_lens,
                                                return_log_probs)
            if isinstance(audio, normalize.PackedRows):
                # pinned host tensors: copies on the compute stream, no sync
                tokens, s_lens = (x.to(dev, non_blocking=True) for x in (tokens, s_lens))
                audio, audio_lens = normalize.upload(audio, dev)
            else:
                audio = _as_device(audio, None, dev)
                audio_lens = _as_device(audio_lens, torch.int32, dev)
                tokens = _as_device(tokens, torch.int32, dev).contiguous()
                s_lens = _as_device(s_lens, torch.int32, dev)
            logits = wav2vec2_forward(
                self.params, audio, self.cfg, audio_lens=audio_lens,
                compute_dtype=self.compute_dtype,
            )
            log_probs = log_softmax_logits(logits).contiguous()
            t_lens = frame_lengths(self.cfg, audio_lens).to(torch.int32)
            paths = viterbi_cuda.viterbi_batch(log_probs, tokens, t_lens, s_lens)
            out = (paths, t_lens, *evidence_batch(log_probs, tokens, paths, self.blank_id))
            handles = BatchHandles(out + (log_probs,) if return_log_probs else out)
            if self._copy_stream is not None:
                handles.host, handles.copied = self._copy_to_host(out)
            return handles

    def _submit_sharded(self, audio, audio_lens, tokens, s_lens, return_log_probs):
        """`submit_padded_batch` under the mesh: the rows, padded to a
        multiple of the 'data' size by repeating the last one (host-staged
        or tensor input alike), go out as DTensors; the forward runs on
        them, the DP and the evidence on each rank's rows; the T-length
        outputs (and the log-probs, if asked) are gathered whole and cut
        back to the rows given."""
        b = audio.shape[0]
        pad = (-b) % axis_size(self.mesh, "data")
        if pad:
            audio, audio_lens, tokens, s_lens = _repeat_last_rows(
                pad, audio, audio_lens, tokens, s_lens)
        dev = self.device
        audio_lens = _as_device(audio_lens, torch.int32, dev)
        audio, lens, tokens, s_lens = distribute_rows(
            self.mesh, _as_device(audio, None, dev), audio_lens,
            _as_device(tokens, torch.int32, dev), _as_device(s_lens, torch.int32, dev))
        logits = wav2vec2_forward(
            self.params, audio, self.cfg, audio_lens=lens, compute_dtype=self.compute_dtype,
        )
        log_probs = log_softmax_logits(logits)
        t_lens = frame_lengths(self.cfg, audio_lens).to(torch.int32)
        blank_id = self.blank_id

        def dp_and_evidence(lp, tok, t_l, s_l):
            lp = lp.contiguous()
            paths = viterbi_cuda.viterbi_batch(lp, tok, t_l, s_l)
            # paths are exact in f32 (S < 2**24): one gather for all five
            return torch.stack([paths.float(), *evidence_batch(lp, tok, paths, blank_id)],
                               dim=1)

        packed = full(batch_local(dp_and_evidence, log_probs, tokens,
                                  *distribute_rows(self.mesh, t_lens), s_lens))[:b]
        out = (packed[:, 0].to(torch.int32), t_lens[:b],
               *(packed[:, i].contiguous() for i in range(1, 5)))
        handles = BatchHandles(out + (full(log_probs)[:b],) if return_log_probs else out)
        if self._copy_stream is not None:
            handles.host, handles.copied = self._copy_to_host(out)
        return handles

    def _copy_to_host(self, tensors):
        """Non-blocking copies of `tensors` into pinned host buffers on the
        side copy stream, after the work enqueued so far on the compute
        stream. Returns (host tensors, event recorded after the copies)."""
        enqueued = torch.cuda.Event()
        enqueued.record(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._copy_stream):
            self._copy_stream.wait_event(enqueued)
            host = []
            for x in tensors:
                x.record_stream(self._copy_stream)  # keep its memory until copied
                buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                host.append(buf.copy_(x, non_blocking=True))
            copied = torch.cuda.Event()
            copied.record(self._copy_stream)
        return tuple(host), copied

    def _submit_entries(self, entries, n_pad, s_pad, max_batch, pad_batch):
        """Pad one bucket's (audio, TokenSequence) entries to [B, n_pad] and
        [B, s_pad] (the batch dim on the pow2 grid ≤ max_batch with
        pad_batch, fill rows repeating the last) and submit it.

        On a CUDA device without a mesh the rows go to the card raw: packed
        back to back in pinned memory (`ops.normalize.pack_rows`), uploaded
        without a sync and normalized and padded there by K7 with
        `normalize_audio`'s f64 statistics. Elsewhere each row is normalized
        on the host by `normalize_audio` into a padded numpy buffer. The
        host part is the span `batching.prepare`, which counts the samples
        of the fill rows and of the whole padded batch, the real samples,
        and those of them normalized by K7."""
        with span("batching.prepare") as prepare:
            b = len(entries)
            rows = max(b, min(max_batch, _round_up_pow2(b, 1))) if pad_batch else b
            tokens = np.zeros((b, s_pad), np.int32)
            a_l = np.zeros(b, np.int32)
            s_l = np.zeros(b, np.int32)
            for j, (a, seq) in enumerate(entries):
                tokens[j, : len(seq.tokens)] = seq.tokens
                a_l[j] = len(a)
                s_l[j] = len(seq.tokens)
            real = int(a_l.sum())
            if self._raw_to_card:
                audio = normalize.pack_rows([a for a, _ in entries], n_pad, rows - b, pin=True)
                a_l = audio.lens
                tokens, s_l = (torch.from_numpy(x).pin_memory()
                               for x in _pad_batch_rows(rows, tokens, s_l))
            else:
                audio = np.zeros((b, n_pad), np.float32)
                for j, (a, _) in enumerate(entries):
                    audio[j, : len(a)] = normalize_audio(a)
                audio, a_l, tokens, s_l = _pad_batch_rows(rows, audio, a_l, tokens, s_l)
            prepare.count(samples_fill=(rows - b) * n_pad, samples_total=rows * n_pad,
                          samples_real=real, samples_card=real if self._raw_to_card else 0)
        return self.submit_padded_batch(audio, a_l, tokens, s_l)

    def align_padded_batch(self, audio, audio_lens, tokens, s_lens):
        """Host tuples (paths, t_lens, emit_lp, margin, blank_prob,
        entropy)."""
        return _host_arrays(self.submit_padded_batch(audio, audio_lens, tokens, s_lens))

    def group_batch(self, seqs, handles) -> list[AlignmentOutput]:
        """Group the first len(seqs) rows of one submitted batch (seqs[j] is
        row j's TokenSequence). With host copies in flight it waits for
        those alone (the span `batching.copy_wait`); otherwise it copies the
        vectors to the host. The rows' grouping is the span `batching.group`."""
        paths, t_lens, emit_lp, margin, blank_prob, entropy = _host_arrays(handles)
        outputs = []
        with span("batching.group"):
            for j, seq in enumerate(seqs):
                t_i = int(t_lens[j])
                ev = FrameEvidence(
                    emit_lp=emit_lp[j, :t_i],
                    margin=margin[j, :t_i],
                    blank_prob=blank_prob[j, :t_i].astype(np.float64),
                    entropy=entropy[j, :t_i],
                )
                words = self._group(paths[j, :t_i], seq, ev)
                stats = _utterance_frame_stats(paths[j, :t_i], seq.tokens, self.blank_id, ev)
                outputs.append(AlignmentOutput(words=words, frame_stats=stats))
        return outputs

    def align_stream(
        self,
        items,
        audio_multiple: int = 16000,
        token_multiple: int = 128,
        max_batch: int = 64,
        max_in_flight: int = 2,
        max_pending: int = 256,
        bucket_scheme: str = "pow2",
        pad_batch: bool = True,
    ):
        """Streaming API: consume an iterable of (audio, transcript) and
        yield (index, AlignmentOutput) with bounded memory — audio is read
        lazily, buckets submit as they fill, and up to `max_in_flight`
        submitted batches run on the device while the host groups the
        oldest one, which waits only for that batch's host copies.

        The JAX package's semantics, kept exactly: results arrive in
        completion order (bucketing reorders by shape), each tagged with its
        input index; degenerate inputs (empty audio or transcript) yield at
        once; an utterance too short for its transcript raises
        InvalidInputError. `max_pending` bounds the utterances waiting in
        partly filled buckets: when it is reached, the fullest pending
        bucket submits early. At the end the pending buckets submit in
        sorted (n_pad, s_pad) order. Exhausted, the generator returns (as
        its `StopIteration.value`) the utterances, samples and batches it
        submitted."""
        pending: dict[tuple[int, int], list[tuple[int, np.ndarray, object]]] = {}
        in_flight: list[tuple[list, tuple]] = []
        utterances = samples = batches = 0

        def submit(entries, key):
            return self._submit_entries(
                [(a, seq) for _, a, seq in entries], *key, max_batch, pad_batch
            )

        def drain(entries, handles):
            grouped = self.group_batch([seq for _, _, seq in entries], handles)
            for (idx, _, _), out in zip(entries, grouped):
                yield idx, out

        def launch(entries, key):
            nonlocal batches
            batches += 1
            in_flight.append((entries, submit(entries, key)))
            if len(in_flight) > max_in_flight:
                yield from drain(*in_flight.pop(0))

        for idx, (audio, transcript) in enumerate(items):
            audio = np.asarray(audio)
            seq = self._tokenize(transcript)
            if len(audio) == 0 or not transcript.strip() or not seq.normalized_words:
                yield idx, AlignmentOutput(words=[])
                continue
            t_i = self.cfg.conv_output_length(len(audio))
            min_frames = -(-len(seq.tokens) // 2)
            if t_i < min_frames:
                raise InvalidInputError(
                    f"utterance {idx}: audio too short for transcript: "
                    f"{t_i} frames < {min_frames} required"
                )
            utterances += 1
            samples += len(audio)
            key = (_pad_len(len(audio), audio_multiple, bucket_scheme),
                   _pad_len(len(seq.tokens), token_multiple, bucket_scheme))
            entries = pending.setdefault(key, [])
            entries.append((idx, audio, seq))
            if len(entries) >= max_batch:
                del pending[key]
                yield from launch(entries, key)
            elif sum(len(v) for v in pending.values()) >= max_pending:
                # bounded wait: flush the fullest partial bucket early
                flush_key = max(pending, key=lambda k: len(pending[k]))
                yield from launch(pending.pop(flush_key), flush_key)

        for key in sorted(pending):
            yield from launch(pending[key], key)
        while in_flight:
            yield from drain(*in_flight.pop(0))
        return utterances, samples, batches

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
        """Full path: normalize, tokenize, bucket, batch-align, group; the
        outputs in input order. It is `align_stream` collected, with every
        utterance pending at once, so each (n_pad, s_pad) bucket forms its
        batches in input order, three of them in flight. Padding is exact —
        outputs are identical under any bucketing. A degenerate input gets
        an empty AlignmentOutput; an utterance too short for its transcript
        raises InvalidInputError when the stream reaches it, after the
        batches before it may have been submitted."""
        outputs = [AlignmentOutput(words=[])] * len(audios)
        t_start = time.perf_counter()
        stream = self.align_stream(
            zip(audios, transcripts), audio_multiple, token_multiple, max_batch,
            max_in_flight=3, max_pending=len(audios) + 1, bucket_scheme=bucket_scheme,
            pad_batch=pad_batch,
        )
        while True:
            try:
                idx, out = next(stream)
            except StopIteration as done:
                utterances, samples, batches = done.value
                break
            outputs[idx] = out
        if batches:
            logger.info(
                "aligned %d utterances (%.1f s audio) in %d buckets, %.2f s",
                utterances, samples / 16000.0, batches, time.perf_counter() - t_start,
            )
        return outputs
