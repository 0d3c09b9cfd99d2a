"""On-device per-frame evidence extraction.

PyTorch counterpart of `wav2vec2_tpu.ops.evidence` and of `_evidence_batch`
in `wav2vec2_tpu.parallel.batching`. The reductions that grouping needs are
computed next to the log-softmax on the device, so what crosses to the host
is a few T-length vectors instead of [T, V]:

    emit_lp[t]    = log_probs[t, tokens[path[t]]]
    margin[t]     = top1 - top2 of log_probs[t, :]  (0 if not finite)
    blank_prob[t] = exp(log_probs[t, blank_id])     (f32 exp)
    entropy[t]    = -sum_v p log p                  (nats)

Plain PyTorch: XLA computed these without Pallas.
"""

from __future__ import annotations

import numpy as np
import torch

from ..align.grouping.path_to_words import FrameEvidence
from . import viterbi_cuda


def evidence_batch(
    log_probs: torch.Tensor, tokens: torch.Tensor, paths: torch.Tensor,
    blank_id: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """[B, T, V], [B, S], [B, T] → (emit_lp, margin, blank_prob, entropy),
    each [B, T] f32."""
    path_tokens = torch.gather(tokens.long(), 1, paths.long())
    emit_lp = torch.gather(log_probs, 2, path_tokens[..., None])[..., 0]
    top2 = torch.topk(log_probs, 2, dim=-1).values
    margin = torch.where(
        torch.isfinite(top2).all(dim=-1), top2[..., 0] - top2[..., 1],
        torch.zeros((), dtype=log_probs.dtype, device=log_probs.device),
    )
    blank_prob = torch.exp(log_probs[..., blank_id])
    entropy = -torch.sum(torch.exp(log_probs) * log_probs, dim=-1)
    return emit_lp, margin, blank_prob, entropy


def evidence_single(
    log_probs: torch.Tensor, tokens: torch.Tensor, path: torch.Tensor,
    blank_id: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """[T, V], [S], [T] → four [T] vectors (the JAX `_evidence_kernel`)."""
    out = evidence_batch(log_probs[None], tokens[None], path[None], blank_id)
    return tuple(x[0] for x in out)


def _to_host(path: torch.Tensor, ev: tuple, t_len: int):
    """One device→host copy of path + the four evidence vectors."""
    packed = torch.stack([path.float(), *ev])[:, :t_len].cpu().numpy()
    return packed[0].astype(np.int32), FrameEvidence(
        emit_lp=packed[1], margin=packed[2],
        blank_prob=packed[3].astype(np.float64), entropy=packed[4],
    )


def fused_path_evidence(
    log_probs: torch.Tensor, tokens: torch.Tensor, t_len: int, s_len: int,
    blank_id: int,
) -> tuple[np.ndarray, FrameEvidence]:
    """Single-utterance latency path: the K1 kernel and the evidence
    reductions are enqueued back to back, and path and evidence come back
    with ONE device→host copy (paths are exact in f32: S < 2**24)."""
    path = viterbi_cuda.viterbi_single(log_probs, tokens, t_len, s_len)
    return _to_host(path, evidence_single(log_probs, tokens, path, blank_id), t_len)


def compute_frame_evidence_device(
    log_probs: torch.Tensor, tokens: torch.Tensor, path: torch.Tensor,
    blank_id: int, t_len: int,
) -> FrameEvidence:
    """Evidence for a given path [T_pad] on the device, one copy back."""
    return _to_host(path, evidence_single(log_probs, tokens, path, blank_id), t_len)[1]
