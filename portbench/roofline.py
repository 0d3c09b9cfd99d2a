"""Peaks of one H100, and the operations and bytes of the work the
benchmark times: the Viterbi DP's bound, K5's bound and the forward's
FLOPs, each counted from what the inputs need (real lengths, not padding).

Peaks: NVIDIA's H100 SXM data sheet, dense, at the 700 W power limit.
The DP bound is a copy of the smoke test's `dp_bound`: bytes read and
written once over 3.35 TB/s, against 4 f32 operations a band cell over
67 TFLOP/s. That peak counts a fused multiply-add as two operations; a
max-plus cell has no FMA, so a DP kernel's share of this bound cannot
pass about half even at the card's full issue rate.
"""

from __future__ import annotations

import numpy as np

from .reference import models

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
PEAK_BF16_OPS_PER_S = 989e12
DP_OPS_PER_CELL = 4  # two compare-selects, the skip-rule test, one add


def peak_ops(dtype: str) -> float:
    return PEAK_BF16_OPS_PER_S if dtype == "bfloat16" else PEAK_F32_OPS_PER_S


def band_cells(t_lens, s_lens) -> int:
    """DP cells these rows need: the init row plus, for every frame
    1 <= t < t_len, the states of the band."""
    cells = 0
    for t_len, s_len in zip(np.asarray(t_lens, np.int64), np.asarray(s_lens, np.int64)):
        t = np.arange(1, int(t_len), dtype=np.int64)
        start = np.maximum(max(s_len - 2, 0) - 2 * (t_len - 1 - t), 0)
        end = np.minimum(2 * t + 1, s_len - 1)
        cells += int(np.maximum(end - start + 1, 0).sum()) + min(int(s_len), 2)
    return cells


def dp_bound_s(tier: str, v: int, t_lens, s_lens) -> float:
    """Least seconds of the DP over rows of real lengths `t_lens` frames and
    `s_lens` states: the larger of the bytes they need (each row's inputs
    read once: T × V log-probs for K1/K4, T × S gathered emissions for
    K2/K3, the tokens, two lengths; the path written once) over the
    bandwidth, and their band cells' operations over the f32 peak. Rows
    that only fill a batch to its size, and frames and states past a row's
    own, are padding and not counted."""
    t = np.asarray(t_lens, np.float64)
    s = np.asarray(s_lens, np.float64)
    src = t * (s if tier in ("k2", "k3") else v)
    nbytes = 4 * float((src + s + 2 + t).sum())
    ops = DP_OPS_PER_CELL * band_cells(t_lens, s_lens)
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_OPS_PER_S)


def flash_bound_s(t_lens, nh: int, hd: int, elem_bytes: int, peak: float,
                  rel: bool = True) -> float:
    """Least seconds of one K5 launch over rows of real lengths `t_lens`:
    per (row, head) q·kᵀ and P·V over the row's own keys, 4·T²·hd, and with
    `rel` the position term, 6·T²·hd, against q, k, v (and q_pos) read and
    the output written once, each T × hd, the 2·T − 1 rows of the position
    table of the longest row per head, and the f32 key mask."""
    t = np.asarray(t_lens, np.float64)
    ops = (6 if rel else 4) * float((t * t).sum()) * hd * nh
    per_row = (5 if rel else 4) * float(t.sum()) * nh * hd * elem_bytes
    table = nh * (2 * float(t.max()) - 1) * hd * elem_bytes if rel else 0.0
    nbytes = per_row + table + 4 * float(t.sum())
    return max(nbytes / PEAK_BYTES_PER_S, ops / peak)


def conv_frames(n_samples: int, cfg: dict) -> list[int]:
    """Output frames of each conv of the feature extractor."""
    out = []
    for k, s in zip(cfg["conv_kernel"], cfg["conv_stride"]):
        n_samples = (n_samples - k) // s + 1
        out.append(max(n_samples, 0))
    return out


def forward_flops(cfg: dict, n_samples: int) -> float:
    """FLOPs of one utterance's forward at its real length (an FMA is two):
    the convs, the feature projection, the encoder (counted by the module
    of its `model_type`, `reference/models/`) and the CTC head. Norms,
    activations and softmax are left out."""
    frames = conv_frames(n_samples, cfg)
    t = frames[-1]
    flops = 0.0
    in_c = 1
    for out_c, k, f in zip(cfg["conv_dim"], cfg["conv_kernel"], frames):
        flops += 2.0 * f * out_c * in_c * k
        in_c = out_c
    h = cfg["hidden_size"]
    flops += 2.0 * t * in_c * h
    flops += models.load(cfg["model_type"]).encoder_flops(cfg, t)
    flops += 2.0 * t * h * cfg["vocab_size"]
    return flops
