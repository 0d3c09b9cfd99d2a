"""What the per-layer metrics share: which kernels are which tier, and the
work and bounds of the real rows a traced window drove. Each metric's own file
under `metrics/` combines these; a reader returns None where its run has
nothing to read (no such kernel ran, no such call was made).
"""

from __future__ import annotations

from . import roofline
from .reference.forward import frames

KERNELS = {
    "k1": lambda name: "viterbi_k1_" in name,
    "k2": lambda name: "viterbi_blocked_kernel<true, false" in name,
    "k3": lambda name: "viterbi_blocked_kernel<false, false" in name,
    "k4": lambda name: "viterbi_blocked_kernel<false, true" in name,
    "k5": lambda name: "flash_attention_" in name,
}


def share(part: float, whole: float):
    return None if whole <= 0 or part <= 0 else 100.0 * part / whole


def idle_share(run):
    t = run.trace
    return None if t is None or t.window_s <= 0 else 100.0 * (1.0 - t.busy_s / t.window_s)


def mfu(run, flops: float):
    peak = roofline.peak_ops(run.ctx.dtype)
    return share(flops, run.trace.window_s * peak)


def batch_flops(run) -> float:
    """Forward FLOPs of the real rows of every batch the window submitted."""
    cfg = run.ctx.cfg
    return sum(roofline.forward_flops(cfg, n) for b in run.recorder.batches
               for n in b["audio_lens"])


def dp_bound_batches(run, tier: str) -> float:
    """Summed DP bounds of the real rows of the window's batches whose shape
    selects `tier` (the rows that fill a batch to its pow2 size repeat the
    last one: padding, not counted)."""
    from wav2vec2_tpu_torch.ops.viterbi_cuda import select_tier

    cfg, v = run.ctx.cfg, run.ctx.cfg["vocab_size"]
    total = 0.0
    for b in run.recorder.batches:
        if select_tier(frames(b["n_pad"], cfg), b["s_pad"], v) != tier:
            continue
        total += roofline.dp_bound_s(tier, v, [frames(n, cfg) for n in b["audio_lens"]],
                                     b["s_lens"])
    return total
