"""Banded CTC Viterbi forced alignment — reference implementations.

- `viterbi_numpy`: the scalar host oracle, carried over from
  `wav2vec2_tpu.ops.viterbi_ref` cell for cell. The single-utterance path
  runs it below `kernel_dp_threshold`, and the tests hold every other
  version bit-identical to it.
- `viterbi_batch`: the plain PyTorch version of the device DP — a Python
  loop over frames with tensor ops over [B, S_pad], the semantics of the
  JAX `viterbi_single`/`viterbi_batch` (`lax.scan` over time). The K1 CUDA
  kernel (ops/viterbi_cuda.py) is compared against it on the card, and its
  wrapper (`viterbi_batch`, and `viterbi_single` for one utterance) runs it
  for CPU tensors.

DP semantics (bit-for-bit in every version):

- init: prev[0] = lp[0][tok[0]]; prev[1] = lp[0][tok[1]] if S > 1; all
  else -inf.
- band: at frame t only states in [curr_start, curr_end] are computed,
  curr_start = max(0, max(S-2, 0) - 2*(T-1-t)), curr_end = min(2t+1, S-1).
- transitions: stay, s-1, and s-2 (only where tokens[s] != tokens[s-2]);
  strict `>` so ties prefer stay > s-1 > s-2; one f32 add best + emit.
- frames >= t_len are frozen (they hold the final state in the path).
- final state: s = S-1 unless S >= 2 and prev[S-2] > prev[S-1] strictly.
- backtrace over 1-byte backpointers.
"""

from __future__ import annotations

import numpy as np
import torch

NEG_INF = float("-inf")


def viterbi_numpy(log_probs: np.ndarray, tokens: np.ndarray) -> list[tuple[int, int]]:
    """Scalar oracle. log_probs: [T, V] float32, tokens: [S] int.

    Returns the path as a list of (state, frame) pairs of length T
    (empty if T == 0 or S == 0)."""
    t_len = int(log_probs.shape[0]) if log_probs.ndim else 0
    s_len = int(len(tokens))
    if t_len == 0 or s_len == 0:
        return []

    lp = np.asarray(log_probs, dtype=np.float32)
    tok = [int(t) for t in tokens]

    prev = np.full(s_len, NEG_INF, dtype=np.float32)
    curr = np.full(s_len, NEG_INF, dtype=np.float32)
    bp = np.zeros((t_len, s_len), dtype=np.uint8)

    prev[0] = lp[0, tok[0]]
    if s_len > 1:
        prev[1] = lp[0, tok[1]]

    prev_start, prev_end = 0, (1 if s_len > 1 else 0)
    final_floor_state = max(s_len - 2, 0)

    for t in range(1, t_len):
        remaining = t_len - 1 - t
        curr_start = max(final_floor_state - 2 * remaining, 0)
        curr_end = min(2 * t + 1, s_len - 1)
        for s in range(curr_start, curr_end + 1):
            emit = lp[t, tok[s]]
            best = np.float32(NEG_INF)
            step = 0
            if prev_start <= s <= prev_end and prev[s] > best:
                best, step = prev[s], 0
            if s >= 1 and prev_start <= s - 1 <= prev_end and prev[s - 1] > best:
                best, step = prev[s - 1], 1
            if (
                s >= 2
                and tok[s] != tok[s - 2]
                and prev_start <= s - 2 <= prev_end
                and prev[s - 2] > best
            ):
                best, step = prev[s - 2], 2
            curr[s] = best + emit
            bp[t, s] = step
        prev, curr = curr, prev
        prev_start, prev_end = curr_start, curr_end

    s = s_len - 1
    if s_len >= 2 and prev[s_len - 2] > prev[s_len - 1]:
        s = s_len - 2

    path = [(s, t_len - 1)]
    for t in range(t_len - 1, 0, -1):
        step = int(bp[t, s])
        if step == 1:
            s -= 1
        elif step == 2:
            s -= 2
        path.append((s, t - 1))
    path.reverse()
    return path


def _shift_down(rows: torch.Tensor, k: int) -> torch.Tensor:
    """rows[:, s] -> rows[:, s-k], with -inf entering at the bottom."""
    out = torch.full_like(rows, NEG_INF)
    out[:, k:] = rows[:, :-k]
    return out


def viterbi_batch(
    log_probs: torch.Tensor,
    tokens: torch.Tensor,
    t_lens: torch.Tensor,
    s_lens: torch.Tensor,
) -> torch.Tensor:
    """Plain PyTorch banded Viterbi over a padded batch.

    log_probs [B, T_pad, V] f32; tokens [B, S_pad] int (any values past
    s_len that index V); t_lens, s_lens [B] int. Returns paths [B, T_pad]
    int32; frames >= t_len hold the final state."""
    b, t_pad, _ = log_probs.shape
    s_pad = tokens.shape[1]
    dev = log_probs.device
    lp = log_probs.float()
    tok = tokens.long()
    t_lens = t_lens.long().to(dev)
    s_lens = s_lens.long().to(dev)
    s_idx = torch.arange(s_pad, device=dev)[None, :]
    neg = torch.tensor(NEG_INF, device=dev)

    # emissions E[b, t, s] = lp[b, t, tokens[b, s]]
    emit = torch.gather(lp, 2, tok[:, None, :].expand(b, t_pad, s_pad))
    prev = torch.where(s_idx == 0, emit[:, 0], neg)
    prev = torch.where((s_idx == 1) & (s_lens[:, None] > 1), emit[:, 0], prev)

    final_floor = torch.clamp(s_lens - 2, min=0)[:, None]
    last_state = (s_lens - 1)[:, None]
    tok_neq2 = tok != torch.roll(tok, 2, dims=1)
    bp = torch.zeros((b, t_pad, s_pad), dtype=torch.uint8, device=dev)

    for t in range(1, t_pad):
        remaining = (t_lens - 1 - t)[:, None]
        curr_start = torch.clamp(final_floor - 2 * remaining, min=0)
        curr_end = torch.clamp(last_state, max=2 * t + 1)
        cand1 = _shift_down(prev, 1)
        cand2 = torch.where(tok_neq2, _shift_down(prev, 2), neg)
        best = prev
        step = torch.zeros((b, s_pad), dtype=torch.uint8, device=dev)
        m1 = cand1 > best
        best = torch.where(m1, cand1, best)
        step = torch.where(m1, 1, step).to(torch.uint8)
        m2 = cand2 > best
        best = torch.where(m2, cand2, best)
        step = torch.where(m2, 2, step).to(torch.uint8)

        in_band = (s_idx >= curr_start) & (s_idx <= curr_end)
        active = (t < t_lens)[:, None]
        curr = torch.where(in_band, best + emit[:, t], neg)
        bp[:, t] = torch.where(in_band & active, step, 0).to(torch.uint8)
        prev = torch.where(active, curr, prev)

    idx_last = torch.clamp(s_lens - 1, min=0)
    idx_prev = torch.clamp(s_lens - 2, min=0)
    rows = torch.arange(b, device=dev)
    take_prev = (s_lens >= 2) & (prev[rows, idx_prev] > prev[rows, idx_last])
    s = torch.where(take_prev, idx_prev, idx_last)

    paths = torch.empty((b, t_pad), dtype=torch.int32, device=dev)
    for t in range(t_pad - 1, -1, -1):
        paths[:, t] = s.to(torch.int32)
        if t >= 1:
            s = s - bp[rows, t, s].long()
    return paths
