"""Long-form alignment: chunked encoder with overlap-stitched log-probs
(counterpart of `wav2vec2_tpu.align.longform`).

Attention is quadratic in T, so hour-scale audio is encoded in overlapping
frame-aligned chunks (a multiple of the frame stride, 320 samples for
wav2vec2). The chunk batch runs through the forward in sub-batches, the
per-frame log-probs are stitched at the overlaps (each global frame taken
from the chunk where it lies deepest, farthest from a chunk edge), and one
banded Viterbi runs over the stitched [T_total, V] matrix — the DP has no
quadratic term, so only the encoder needs chunking.

On the device the whole log-prob lifecycle stays there: the stitch is one
gather driven by host-computed (chunk, frame) indices (`stitch_indices`),
the DP reads the stitched matrix in place (`ops.viterbi_cuda` picks the tier;
at 10–60 min that is K4), and grouping evidence comes back as four
T-length vectors with the path in one copy.

`mesh` (`parallel.mesh`; every rank makes the same call) shards the chunk
sub-batches over the mesh's 'data' axis, the sequence-parallel dimension
of long-form audio (a sub-batch is padded to a multiple of the 'data' size
with zero rows of length 1). Under a mesh the JAX package's mesh path is
followed: the chunk log-probs are gathered whole, stitched on the host
(`stitch_log_probs`), the DP runs on the device (`select_tier`), and the
evidence is taken on the host (`frame_evidence_from_log_probs`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import AlignerHyperParams, Wav2Vec2ModelConfig
from ..errors import InvalidInputError
from ..models.ctc_model import log_softmax_logits, wav2vec2_forward
from ..models.params import cast_compute_weights_bf16, params_to_device
from ..ops.evidence import fused_path_evidence
from ..ops.viterbi_cuda import viterbi_single
from ..parallel.mesh import (
    axis_size,
    distribute_rows,
    dtensor_no_grad,
    full,
    mesh_device,
    place_params,
)
from ..pipeline.runtime import normalize_audio
from ..types import AlignmentOutput
from .grouping import frame_evidence_from_log_probs, group_into_words
from .tokenization import build_token_sequence_case_aware

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOKEN_MULTIPLE = 128  # S is padded to a multiple of this for the DP


def chunk_spans(
    n_samples: int, chunk_samples: int, overlap_samples: int, stride: int
) -> list[tuple[int, int]]:
    """Frame-aligned (start, end) sample spans with overlap."""
    chunk_samples = (chunk_samples // stride) * stride
    overlap_samples = (overlap_samples // stride) * stride
    if not 0 < overlap_samples < chunk_samples:
        raise ValueError(
            f"need 0 < overlap < chunk after frame alignment, got overlap "
            f"{overlap_samples} and chunk {chunk_samples} samples"
        )
    hop = chunk_samples - overlap_samples
    spans = []
    start = 0
    while True:
        end = min(start + chunk_samples, n_samples)
        spans.append((start, end))
        if end >= n_samples:
            break
        start += hop
    return spans


def stitch_log_probs(
    chunk_log_probs: list[np.ndarray],
    spans: list[tuple[int, int]],
    stride: int,
    total_frames: int,
) -> np.ndarray:
    """Assemble the global [T_total, V] matrix on the host: each global frame
    comes from the chunk whose window-center is closest (deepest context)."""
    v = chunk_log_probs[0].shape[1]
    out = np.zeros((total_frames, v), np.float32)
    best_depth = np.full(total_frames, -1, np.int64)
    for lp, (s0, _) in zip(chunk_log_probs, spans):
        f0 = s0 // stride
        n_f = lp.shape[0]
        count = min(n_f, total_frames - f0)
        if count <= 0:
            continue
        local = np.arange(count)
        depth = np.minimum(local, n_f - 1 - local)
        sel = depth > best_depth[f0 : f0 + count]
        best_depth[f0 : f0 + count][sel] = depth[sel]
        out[f0 : f0 + count][sel] = lp[:count][sel]
    return out


def stitch_indices(
    n_frames: list[int],
    spans: list[tuple[int, int]],
    stride: int,
    total_frames: int,
) -> tuple[np.ndarray, np.ndarray]:
    """(chunk_idx, local_idx) int32 per global frame — the selection
    `stitch_log_probs` applies to values, on indices alone, so the stitch
    runs as one device gather `log_probs[chunk_idx, local_idx, :]`. Raises
    ValueError if a global frame is covered by no chunk (it would otherwise
    gather chunk 0, frame 0)."""
    chunk_idx = np.zeros(total_frames, np.int32)
    local_idx = np.zeros(total_frames, np.int32)
    best_depth = np.full(total_frames, -1, np.int64)
    for ci, (n_f, (s0, _)) in enumerate(zip(n_frames, spans)):
        f0 = s0 // stride
        count = min(n_f, total_frames - f0)
        if count <= 0:
            continue
        local = np.arange(count)
        depth = np.minimum(local, n_f - 1 - local)
        sel = depth > best_depth[f0 : f0 + count]
        best_depth[f0 : f0 + count][sel] = depth[sel]
        chunk_idx[f0 : f0 + count][sel] = ci
        local_idx[f0 : f0 + count][sel] = local[sel].astype(np.int32)
    uncovered = np.flatnonzero(best_depth < 0)
    if uncovered.size:
        raise ValueError(
            f"{uncovered.size} of {total_frames} frames are covered by no chunk "
            f"(first: frame {int(uncovered[0])})"
        )
    return chunk_idx, local_idx


def chunk_log_probs(
    normalized: np.ndarray,
    params: dict,
    model_cfg: Wav2Vec2ModelConfig,
    chunk_samples: int,
    overlap_samples: int,
    compute_dtype: torch.dtype,
    max_chunk_batch: int,
    device: torch.device,
) -> tuple[torch.Tensor, list[tuple[int, int]], list[int]]:
    """Per-chunk log-probs on `device`: [C, T_chunk_pad, V] f32, the chunks'
    sample spans, and each chunk's frame count. The forward runs in padded
    sub-batches of `max_chunk_batch` chunks (activation memory grows with
    B · T_chunk²); `params` are already on `device`."""
    spans = chunk_spans(len(normalized), chunk_samples, overlap_samples,
                        model_cfg.frame_stride_samples())
    n_pad = max(s1 - s0 for s0, s1 in spans)
    batch = np.zeros((len(spans), n_pad), np.float32)
    lens = np.zeros(len(spans), np.int32)
    for i, (s0, s1) in enumerate(spans):
        batch[i, : s1 - s0] = normalized[s0:s1]
        lens[i] = s1 - s0
    blocks = []
    for lo in range(0, len(spans), max_chunk_batch):
        hi = min(lo + max_chunk_batch, len(spans))
        logits = wav2vec2_forward(
            params, torch.from_numpy(batch[lo:hi]).to(device), model_cfg,
            audio_lens=torch.from_numpy(lens[lo:hi]).to(device),
            compute_dtype=compute_dtype,
        )
        blocks.append(log_softmax_logits(logits))
    lps = blocks[0] if len(blocks) == 1 else torch.cat(blocks)
    return lps, spans, [model_cfg.conv_output_length(int(n)) for n in lens]


def stitch_device(
    lps: torch.Tensor,
    spans: list[tuple[int, int]],
    n_frames: list[int],
    stride: int,
    total_frames: int,
) -> torch.Tensor:
    """The stitch as one gather on the device: [C, T_chunk_pad, V] →
    [T_total, V], equal to `stitch_log_probs` on the same chunks."""
    c_idx, l_idx = stitch_indices(n_frames, spans, stride, total_frames)
    dev = lps.device
    return lps[torch.from_numpy(c_idx).to(dev).long(),
               torch.from_numpy(l_idx).to(dev).long()]


def longform_log_probs(
    normalized: np.ndarray,
    params: dict,
    model_cfg: Wav2Vec2ModelConfig,
    chunk_samples: int,
    overlap_samples: int,
    compute_dtype: torch.dtype,
    max_chunk_batch: int,
    device: torch.device,
) -> torch.Tensor:
    """Stitched [T_total, V] f32 log-probs on `device`: one forward when the
    audio fits one chunk, else chunk → forward → device stitch."""
    n = len(normalized)
    if n <= chunk_samples:
        logits = wav2vec2_forward(params, torch.from_numpy(normalized)[None].to(device),
                                  model_cfg, compute_dtype=compute_dtype)
        return log_softmax_logits(logits)[0]
    lps, spans, n_frames = chunk_log_probs(
        normalized, params, model_cfg, chunk_samples, overlap_samples,
        compute_dtype, max_chunk_batch, device,
    )
    return stitch_device(lps, spans, n_frames, model_cfg.frame_stride_samples(),
                         model_cfg.conv_output_length(n))


def sharded_chunk_log_probs(
    normalized: np.ndarray,
    params: dict,
    model_cfg: Wav2Vec2ModelConfig,
    chunk_samples: int,
    overlap_samples: int,
    compute_dtype: torch.dtype,
    max_chunk_batch: int,
    mesh,
) -> tuple[list[tuple[int, int]], list[np.ndarray]]:
    """The chunks' sample spans, and each chunk's [T_i, V] f32 log-probs on
    the host: the chunk sub-batches sharded over `mesh`'s 'data' axis (pad
    rows are zeros of length 1), their log-probs gathered whole. Audio no
    longer than a chunk is one chunk."""
    if len(normalized) <= chunk_samples:
        spans = [(0, len(normalized))]
    else:
        spans = chunk_spans(len(normalized), chunk_samples, overlap_samples,
                            model_cfg.frame_stride_samples())
    n_pad = max(s1 - s0 for s0, s1 in spans)
    data = axis_size(mesh, "data")
    out = []
    for lo in range(0, len(spans), max_chunk_batch):
        rows = spans[lo:lo + max_chunk_batch]
        b = -(-len(rows) // data) * data
        batch = np.zeros((b, n_pad), np.float32)
        lens = np.ones(b, np.int32)
        for i, (s0, s1) in enumerate(rows):
            batch[i, : s1 - s0] = normalized[s0:s1]
            lens[i] = s1 - s0
        audio, audio_lens = distribute_rows(mesh, batch, lens)
        logits = wav2vec2_forward(params, audio, model_cfg, audio_lens=audio_lens,
                                  compute_dtype=compute_dtype)
        lps = full(log_softmax_logits(logits)).cpu().numpy()
        out += [lps[i, : model_cfg.conv_output_length(int(lens[i]))]
                for i in range(len(rows))]
    return spans, out


def device_params(params: dict, compute_dtype: str, device: torch.device) -> dict:
    """The parameter tree on `device`, compute weights in bf16 at bf16."""
    params = params_to_device(params, device)
    return cast_compute_weights_bf16(params) if compute_dtype == "bfloat16" else params


@torch.inference_mode()
def align_longform(
    audio: np.ndarray,
    transcript: str,
    params: dict,
    model_cfg: Wav2Vec2ModelConfig,
    vocab: dict[str, int],
    chunk_sec: float = 30.0,
    overlap_sec: float = 5.0,
    sample_rate: int = 16000,
    compute_dtype: str = "float32",
    hp: AlignerHyperParams | None = None,
    max_chunk_batch: int = 32,
    device: str | torch.device = "cuda",
    mesh=None,
) -> AlignmentOutput:
    """Align arbitrarily long audio against its transcript. `params` is the
    port's parameter tree (models.params) on any device; under `mesh` its
    DTensor leaves keep their placement and any other leaf is replicated,
    on the mesh's device."""
    if compute_dtype not in _DTYPES:
        raise ValueError(f"unsupported compute dtype {compute_dtype!r}")
    hp = hp or AlignerHyperParams()
    blank_id = model_cfg.pad_token_id
    word_sep_id = vocab.get("|", 0)
    stride_ms = model_cfg.frame_stride_ms(sample_rate)

    # tokenize first: empty or unalignable inputs must not pay for the
    # encoder (the runtime's empty-input and min-frames contracts)
    seq = build_token_sequence_case_aware(transcript, vocab, blank_id, word_sep_id)
    if len(audio) == 0 or not seq.normalized_words:
        return AlignmentOutput(words=[])
    min_frames = -(-len(seq.tokens) // 2)
    if model_cfg.conv_output_length(len(audio)) < min_frames:
        raise InvalidInputError(
            f"audio too short for transcript: "
            f"{model_cfg.conv_output_length(len(audio))} frames < "
            f"{min_frames} required"
        )

    if mesh is not None:
        with dtensor_no_grad():
            path, evidence = _sharded_path_evidence(
                normalize_audio(audio), seq, params, model_cfg, int(chunk_sec * sample_rate),
                int(overlap_sec * sample_rate), _DTYPES[compute_dtype], max_chunk_batch,
                mesh)
        return AlignmentOutput(words=group_into_words(
            path, seq.tokens, seq.chars, seq.normalized_words, evidence,
            blank_id, word_sep_id, stride_ms, hp,
        ))
    device = torch.device(device)
    log_probs = longform_log_probs(
        normalize_audio(audio), device_params(params, compute_dtype, device),
        model_cfg, int(chunk_sec * sample_rate), int(overlap_sec * sample_rate),
        _DTYPES[compute_dtype], max_chunk_batch, device,
    )
    t_len, s_len = log_probs.shape[0], len(seq.tokens)
    tokens = np.zeros(-(-s_len // TOKEN_MULTIPLE) * TOKEN_MULTIPLE, np.int32)
    tokens[:s_len] = seq.tokens
    path, evidence = fused_path_evidence(
        log_probs, torch.from_numpy(tokens).to(device), t_len, s_len, blank_id
    )
    words = group_into_words(
        path, seq.tokens, seq.chars, seq.normalized_words, evidence,
        blank_id, word_sep_id, stride_ms, hp,
    )
    return AlignmentOutput(words=words)


def _sharded_path_evidence(normalized, seq, params, model_cfg, chunk_samples,
                           overlap_samples, compute_dtype, max_chunk_batch, mesh):
    """`align_longform`'s path and evidence under a mesh: sharded chunk
    forwards, the host stitch, the DP on this rank's device, the evidence
    on the host."""
    spans, chunk_lps = sharded_chunk_log_probs(
        normalized, place_params(params, mesh), model_cfg, chunk_samples, overlap_samples,
        compute_dtype, max_chunk_batch, mesh,
    )
    log_probs = stitch_log_probs(chunk_lps, spans, model_cfg.frame_stride_samples(),
                                 model_cfg.conv_output_length(len(normalized)))
    t_len, s_len = log_probs.shape[0], len(seq.tokens)
    device = mesh_device(mesh)
    tokens = np.zeros(-(-s_len // TOKEN_MULTIPLE) * TOKEN_MULTIPLE, np.int32)
    tokens[:s_len] = seq.tokens
    path = viterbi_single(torch.from_numpy(log_probs).to(device),
                          torch.from_numpy(tokens).to(device), t_len, s_len)
    path = path.cpu().numpy()[:t_len]
    return path, frame_evidence_from_log_probs(log_probs, seq.tokens, path,
                                               model_cfg.pad_token_id)
