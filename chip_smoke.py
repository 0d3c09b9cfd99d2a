"""Smoke test of the PyTorch/CUDA port (`wav2vec2_tpu_torch`) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds the CUDA kernels from `wav2vec2_tpu_torch/csrc/` with one
`nvcc` call (the Viterbi kernel K1 in its two modes, its blocked tiers K2,
K3, K4, and the fused rel-pos attention kernel K5), holds each against its
plain PyTorch version (the Viterbi kernels also against the numpy oracle,
K4 against K1 at hour scale), and drives the port's paths through the entry points a
user calls, with random weights from a numpy seed:

- wav2vec2-base at full width: `BatchAligner.submit_padded_batch` on
  32 × 10 s with the gates of `bench.py` (K1), and on a long bucket that
  selects K2; `ForcedAlignerBuilder` on 3 requests (K1); `align_longform`
  on 10 min of audio with a 1 200-word transcript (K4), with gates
  (a)–(d), and on 3 min with a phoneme-size vocabulary and a short
  transcript (K3);
- wav2vec2-conformer-rel-pos-large at full width and depth:
  `BatchAligner.submit_padded_batch` on 32 × 10 s with the gates of
  `bench.py` (K5 once per layer and forward, K1), the f32 forward through
  K5 against the f32 factorized forward, and `ForcedAlignerBuilder` on a
  4-block model directory (no K5, as in the JAX package);
- the `alignment_report` CLI in process at the full width and depth of
  wav2vec2-base, on a LibriSpeech-layout dataset of 64 FLAC utterances
  written by the port's encoder (2–32 s, so every bucket of its 1 s pow2
  grid up to 32 s fills): textgrid at bf16 and f32 (`align_stream`: K1 at
  the short buckets, K2 and K4 at the long ones), `--no-batch`, json,
  perf, srt, and `--units phoneme` with a 392-wide head (K1 resident),
  with gates on the stream's order and words, native vs Python grouping
  on every drained batch, batch vs single, the perf run's device memory,
  and each tier it launched against its plain version.

The host grouping runs the native engine throughout
(`WAV2VEC2_NATIVE_GROUPING=require`): a silent fall-back to Python fails.

K1 runs in its resident mode at the serving shape (checked on the batch
entry through its per-mode launch counts) and in its device mode on the
shapes whose backpointers do not fit; the smoke times both modes on the
same inputs, and the resident mode's strip widths.

Each path runs with the kernels' launch counts set to 0 just before it and
read just after. It times the kernels on the device alone (`kernel_ms`:
launches queued behind a spin kernel, so the wrappers' host cost is out)
beside their plain versions, their bounds and, for K5, one PyTorch call
computing the same function; the forwards, the long-form path and the
batch paths with their drain on CUDA events around whole calls. Every failure raises and the exit code is non-zero; without a CUDA
device it exits non-zero before running anything. The line before the
last is the `kernels` JSON object; the last line of standard output is one
JSON object naming the device.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

BASE_CONFIG = dict(
    model_type="wav2vec2",
    hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
    intermediate_size=3072, conv_dim=[512] * 7,
    conv_kernel=[10, 3, 3, 3, 3, 2, 2], conv_stride=[5, 2, 2, 2, 2, 2, 2],
    num_conv_pos_embeddings=128, num_conv_pos_embedding_groups=16,
    pad_token_id=0, vocab_size=32, do_stable_layer_norm=False,
    feat_extract_norm="group", conv_bias=False,
)
# wav2vec2-conformer-rel-pos-large-960h (wav2vec2_tpu/models/presets.py:234-247)
CONFORMER_CONFIG = dict(
    model_type="wav2vec2-conformer",
    hidden_size=1024, num_hidden_layers=24, num_attention_heads=16,
    intermediate_size=4096, conv_dim=[512] * 7,
    conv_kernel=[10, 3, 3, 3, 3, 2, 2], conv_stride=[5, 2, 2, 2, 2, 2, 2],
    num_conv_pos_embeddings=128, num_conv_pos_embedding_groups=16,
    pad_token_id=0, vocab_size=32, feat_extract_norm="layer", conv_bias=True,
    position_embeddings_type="relative", hidden_act="swish",
    conv_depthwise_kernel_size=31, max_source_positions=5000,
)
WORDS = ["THE", "QUICK", "BROWN", "FOX", "JUMPS", "OVER", "LAZY", "DOG",
         "WHILE", "SINGING", "ANCIENT", "MELODIES", "UNDER", "BRIGHT",
         "WINTER", "STARS", "NEAR", "FROZEN", "RIVERS", "TONIGHT"]
# the transcript of the JAX package's long-form example
# (examples/longform_alignment.py): these 8 words, 15 times a minute
LONGFORM_WORDS = WORDS[:8]
SAMPLE_RATE = 16000
S_PAD = 256
PHONEME_VOCAB = 392  # phoneme-CTC vocabulary size of the hour-scale phoneme shape
HOUR_FRAMES = 180_000
# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
PEAK_BF16_OPS_PER_S = 989e12  # dense tensor-core rate
DP_OPS_PER_CELL = 4  # two compare-selects, the skip-rule test, one add
# K5 against its plain version, relative to the largest output: the JAX
# package's own kernel bounds (tests/test_flash_attention.py)
FLASH_REL_BOUND = {"float32": 2e-5, "bfloat16": 3e-2}


def make_vocab() -> dict[str, int]:
    vocab = {"<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3, "|": 4}
    for i, c in enumerate("ETAONIHSRDLUMWCFGYPBVKXJQZ"):
        vocab[c] = 5 + i
    return vocab


def random_log_probs(rng, b, t, v):
    """Random log-softmaxed f32 log-probs [B, T, V]."""
    x = rng.normal(size=(b, t, v)).astype(np.float32) * np.float32(3.0)
    x = x - x.max(axis=-1, keepdims=True)
    return (x - np.log(np.exp(x).sum(axis=-1, keepdims=True))).astype(np.float32)


def kernel_cases(rng):
    """(name, log_probs, tokens, t_lens, s_lens) at the main path's shapes
    and at the edge cases of the band and the skip rule."""
    cases = []
    b, t, v = 128, 499, 32
    s_lens = rng.integers(1, S_PAD + 1, size=b).astype(np.int32)
    s_lens[:4] = [S_PAD, 1, 2, 200]
    cases.append(("serving B=128 T=499 S_pad=256",
                  random_log_probs(rng, b, t, v),
                  rng.integers(0, v, size=(b, S_PAD)).astype(np.int32),
                  np.full(b, t, np.int32), s_lens))
    b = 16
    t_lens = rng.integers(100, t + 1, size=b).astype(np.int32)
    s_lens = np.minimum(rng.integers(1, S_PAD + 1, size=b), 2 * t_lens).astype(np.int32)
    cases.append(("ragged t_len B=16 T_pad=499", random_log_probs(rng, b, t, v),
                  rng.integers(0, v, size=(b, S_PAD)).astype(np.int32), t_lens, s_lens))
    cases.append(edge_case(rng))
    # K1's resident ring of 4 slots refilled through the 4-byte copies
    # (V = 29: V * 4 not a multiple of 16) and through the bulk copies with
    # phoneme-size rows
    cases.append(("4-byte ring copies B=3 T_pad=601 S_pad=61 V=29",
                  random_log_probs(rng, 3, 601, 29),
                  rng.integers(0, 29, size=(3, 61)).astype(np.int32),
                  np.array([601, 555, 37], np.int32), np.array([61, 44, 9], np.int32)))
    cases.append(("ring refills B=4 T=499 S_pad=256 V=392",
                  random_log_probs(rng, 4, t, PHONEME_VOCAB),
                  rng.integers(0, PHONEME_VOCAB, size=(4, S_PAD)).astype(np.int32),
                  np.array([499, 499, 300, 17], np.int32),
                  np.array([256, 131, 250, 30], np.int32)))
    b, t, s_pad = 4, 1499, 768
    cases.append(("large B=4 T=1499 S_pad=768", random_log_probs(rng, b, t, v),
                  rng.integers(0, v, size=(b, s_pad)).astype(np.int32),
                  np.array([1499, 1499, 1200, 900], np.int32),
                  np.array([768, 700, 500, 300], np.int32)))
    return cases


def edge_case(rng):
    """s_len=1; s_len=2*t_len (tightest band); repeated tokens [0,1,0,1,0]
    (skip rule); t_len < T_pad; -inf emissions."""
    t_pad, s_pad = 64, 128
    lp = random_log_probs(rng, 5, t_pad, 8)
    lp[4, :, 3] = -np.inf
    tokens = rng.integers(0, 8, size=(5, s_pad)).astype(np.int32)
    tokens[2, :5] = [0, 1, 0, 1, 0]
    tokens[4, :40:2] = 3
    return ("edge cases T_pad=64 S_pad=128", lp, tokens,
            np.array([64, 20, 12, 64, 40], np.int32),
            np.array([1, 40, 5, 128, 40], np.int32))


def blocked_cases(rng):
    """{tier: cases} for K2, K3, K4 forced by `tier=`: a ragged batch per
    tier at the widths each serves, the edge cases, and odd widths (T_pad
    not a multiple of 8, S_pad and V not multiples of 4: the kernels' 4-byte
    copy path)."""
    def case(name, b, t, v, s_pad, t_lens, s_lens):
        return (name, random_log_probs(rng, b, t, v),
                rng.integers(0, v, size=(b, s_pad)).astype(np.int32),
                np.asarray(t_lens, np.int32), np.asarray(s_lens, np.int32))

    edge = edge_case(rng)
    odd = case("odd widths T_pad=37 S_pad=61 V=397", 3, 37, 397, 61,
               [37, 30, 5], [61, 44, 9])
    # K3/K4 hold R-state strips in registers: R = 4 at S_pad = 2 048, R = 16
    # at 4 100 (W not a multiple of R: the last strip runs past W) and at
    # 8 192 with s_len = 2·t_len (the tightest band: most strips idle)
    return {
        "k2": [case("ragged B=8 T_pad=2400 S_pad=128 V=32", 8, 2400, 32, 128,
                    [2400, 2399, 2001, 1500, 999, 320, 17, 8],
                    [128, 127, 100, 128, 64, 128, 20, 16]), edge, odd],
        "k3": [case("ragged B=4 T_pad=2400 S_pad=128 V=392", 4, 2400, PHONEME_VOCAB, 128,
                    [2400, 1777, 300, 64], [128, 90, 128, 40]), edge, odd,
               case("4-state strips B=2 T_pad=1200 S_pad=2048 V=392", 2, 1200, PHONEME_VOCAB,
                    2048, [1200, 400], [2048, 600])],
        "k4": [case("ragged B=4 T_pad=2400 S_pad=1024 V=32", 4, 2400, 32, 1024,
                    [2400, 2000, 600, 100], [1024, 1000, 700, 150]),
               case("ragged B=4 T_pad=2400 S_pad=1024 V=392", 4, 2400, PHONEME_VOCAB, 1024,
                    [2400, 2000, 600, 100], [1024, 1000, 700, 150]), edge, odd,
               case("partial last strip B=3 T_pad=2400 S_pad=4100 V=32", 3, 2400, 32, 4100,
                    [2400, 2200, 90], [4100, 3000, 150]),
               case("idle strips B=2 T_pad=600 S_pad=8192 V=392", 2, 600, PHONEME_VOCAB, 8192,
                    [600, 300], [1200, 600])],
    }


def plain_version(tier, log_probs, tokens, t_lens, s_lens):
    """The plain PyTorch version of `tier` on the same inputs."""
    from wav2vec2_tpu_torch.ops import viterbi_ref

    if tier in ("k2", "k3"):
        emit = viterbi_ref.gather_emissions(log_probs, tokens)
        return viterbi_ref.viterbi_emissions_batch(emit, tokens, t_lens, s_lens)
    return viterbi_ref.viterbi_batch(log_probs, tokens, t_lens, s_lens)


def oracle_rows(t_lens, s_lens, max_cells=300_000, max_rows=3):
    """Rows cheap enough for the scalar numpy oracle: the smallest T·S
    first, at least one."""
    order = np.argsort(t_lens.astype(np.int64) * s_lens, kind="stable")
    rows = [int(j) for j in order[:max_rows] if int(t_lens[j]) * int(s_lens[j]) <= max_cells]
    return rows or [int(order[0])]


def check_kernel(device, cases, tier="k1", modes=None):
    """Kernel `tier` (forced) vs its plain PyTorch version (all rows, all
    frames) and vs the numpy oracle (a few rows), bit-identical. For K1,
    the mode each case ran in (from `k1_launches`) goes into `modes`
    (case name -> mode) where given. Returns the max abs path difference
    (0)."""
    import torch

    from wav2vec2_tpu_torch.ops import viterbi_cuda, viterbi_ref

    worst = 0
    for name, lp, tok, t_lens, s_lens in cases:
        args = [torch.from_numpy(a).to(device) for a in (lp, tok, t_lens, s_lens)]
        before = dict(viterbi_cuda.k1_launches)
        got = viterbi_cuda.viterbi_batch(*args, tier=tier).cpu().numpy()
        ran = [m for m, n in viterbi_cuda.k1_launches.items() if n != before[m]]
        mode = f" in the {ran[0]} mode" if ran else ""
        if modes is not None and ran:
            modes[name] = ran[0]
        plain = plain_version(tier, *args).cpu().numpy()
        diff = int(np.abs(got.astype(np.int64) - plain).max())
        worst = max(worst, diff)
        if diff:
            bad = np.argwhere(got != plain)[0]
            raise AssertionError(f"{tier} {name}: kernel path differs from the plain "
                                 f"version at (row, frame) {tuple(bad)}")
        rows = oracle_rows(t_lens, s_lens)
        for j in rows:
            t_i, s_i = int(t_lens[j]), int(s_lens[j])
            ref = np.asarray([s for s, _ in viterbi_ref.viterbi_numpy(
                lp[j, :t_i], tok[j, :s_i])], np.int32)
            if not (got[j, :t_i] == ref).all() or not (got[j, t_i:] == ref[-1]).all():
                raise AssertionError(f"{tier} {name}: row {j} differs from viterbi_numpy")
        print(f"kernel check {tier}{mode} [{name}]: paths bit-identical to the plain "
              f"version ({got.shape[0]} rows) and to viterbi_numpy (rows {rows})")
    return worst


def band_cells(t_lens, s_lens, t_pad):
    """DP cells these inputs need: the init row plus, for every frame
    1 <= t < t_len, the states of the band."""
    cells = 0
    for t_len, s_len in zip(np.asarray(t_lens, np.int64), np.asarray(s_lens, np.int64)):
        t = np.arange(1, min(int(t_len), t_pad), dtype=np.int64)
        start = np.maximum(max(s_len - 2, 0) - 2 * (t_len - 1 - t), 0)
        end = np.minimum(2 * t + 1, s_len - 1)
        cells += int(np.maximum(end - start + 1, 0).sum()) + min(int(s_len), 2)
    return cells


def dp_bound(tier, b, t_pad, v, s_pad, t_lens, s_lens):
    """(bound_ms, bound_by): the larger of the bytes the function must move
    (each input read once — log-probs for K1/K4, gathered emissions for
    K2/K3 — tokens, lengths, and the path written once) over 3.35 TB/s, and
    its band cells' operations over 67 TFLOP/s f32."""
    src = t_pad * (s_pad if tier in ("k2", "k3") else v)
    nbytes = 4 * (b * src + b * s_pad + 2 * b + b * t_pad)
    ops = DP_OPS_PER_CELL * band_cells(t_lens, s_lens, t_pad)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def cuda_time_ms(fn, repeats):
    """Median over `repeats` of one call timed with CUDA events."""
    import torch

    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_ms(fn, launches, repeats=3):
    """Device time of one call of `fn` without the host's cost of enqueuing
    it: `launches` calls are queued behind a spin kernel that outlasts
    their enqueue, so they run back to back between two CUDA events; the
    median over `repeats` of the elapsed time over `launches`. (A call timed
    alone between two events measures the wrapper's Python and launch cost
    wherever that exceeds the kernel's.)"""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(2e9 * (2 * launches * host_s + 1e-3)))  # ~2 GHz clock
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def turns_ms(fns, launches):
    """{name: ms} for the kernel calls of `fns`, each by `kernel_ms`, timed
    in turns, in order and then reversed; the median of each one's two."""
    times = {name: [] for name in fns}
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            times[name].append(kernel_ms(fns[name], launches))
    return {name: statistics.median(t) for name, t in times.items()}


def interleaved_ms(kernel, plain, kernel_launches, plain_repeats):
    """Kernel (`kernel_ms`) and plain version (`cuda_time_ms`) timed in
    turns (plain, kernel, kernel, plain); the median of each pair."""
    import torch

    kernel(), plain()
    torch.cuda.synchronize()
    p1, k1 = cuda_time_ms(plain, plain_repeats), kernel_ms(kernel, kernel_launches)
    k2, p2 = kernel_ms(kernel, kernel_launches), cuda_time_ms(plain, plain_repeats)
    return statistics.median([k1, k2]), statistics.median([p1, p2])


def reset_launches():
    from wav2vec2_tpu_torch.ops import flash_attention, viterbi_cuda

    for counts in (viterbi_cuda.launches, viterbi_cuda.k1_launches, flash_attention.launches):
        for name in counts:
            counts[name] = 0


def read_launches():
    """Launches per kernel since `reset_launches`, and K1's per mode
    ("k1_resident", "k1_device")."""
    import torch

    from wav2vec2_tpu_torch.ops import flash_attention, viterbi_cuda

    torch.cuda.synchronize()
    return {**viterbi_cuda.launches, **flash_attention.launches,
            **{f"k1_{mode}": n for mode, n in viterbi_cuda.k1_launches.items()}}


def batch_inputs(rng, vocab, batch, seconds, n_words=None, s_pad=S_PAD):
    from wav2vec2_tpu_torch.align.tokenization import build_token_sequence_case_aware

    n = int(seconds * SAMPLE_RATE)
    transcripts = [" ".join(rng.permutation(WORDS)[:n_words]) for _ in range(batch)]
    seqs = [build_token_sequence_case_aware(t, vocab, 0, 4) for t in transcripts]
    audio = (rng.normal(size=(batch, n)) * 4000).clip(-32768, 32767).astype(np.int16)
    tokens = np.zeros((batch, s_pad), np.int32)
    for j, s in enumerate(seqs):
        tokens[j, : len(s.tokens)] = s.tokens
    a_l = np.full(batch, n, np.int32)
    s_l = np.array([len(s.tokens) for s in seqs], np.int32)
    return seqs, audio, a_l, tokens, s_l


def run_batch_entry(device, cfg, params, vocab, batch, seconds, n_check,
                    label="wav2vec2-base"):
    """The padded-batch entry at bf16 with the three gates of bench.py:
    (a) kernel paths == viterbi_numpy on the same log-probs; (b) grouping
    from device evidence vs the host oracle grouping: all words within one
    frame, >= 99% exact; (c) bf16 vs f32 (TF32 off) log-probs: mean |Δ| <=
    0.05, p99 <= 0.3, same word sequences."""
    import torch

    from wav2vec2_tpu_torch.align.grouping import (
        frame_evidence_from_log_probs,
        group_into_words,
    )
    from wav2vec2_tpu_torch.ops.viterbi_ref import viterbi_numpy
    from wav2vec2_tpu_torch.parallel.batching import BatchAligner

    rng = np.random.default_rng(0)
    seqs, audio, a_l, tokens, s_l = batch_inputs(rng, vocab, batch, seconds)
    inputs = [torch.from_numpy(a).to(device) for a in (audio, a_l, tokens, s_l)]
    stride_ms = cfg.frame_stride_ms(SAMPLE_RATE)

    aligner = BatchAligner(cfg, params, vocab, compute_dtype="bfloat16",
                           device=device, normalize_on_device=True)
    handles = aligner.submit_padded_batch(*inputs, return_log_probs=True)
    outs = [o.words for o in aligner.group_batch(seqs, handles)]
    paths = handles[0].cpu().numpy()
    t_lens = handles[1].cpu().numpy()
    lp = handles[-1].cpu().numpy()
    if not np.isfinite(lp).all() or lp.shape != (batch, cfg.conv_output_length(audio.shape[1]), cfg.vocab_size):
        raise AssertionError(f"log-probs not finite or of shape {lp.shape}")

    total = exact = within_one = 0
    for j in range(n_check):
        seq = seqs[j]
        t_i = int(t_lens[j])
        oracle = np.asarray([s for s, _ in viterbi_numpy(lp[j, :t_i], np.asarray(seq.tokens))],
                            np.int32)
        if not (paths[j, :t_i] == oracle).all():
            raise AssertionError(f"gate (a): kernel path differs from viterbi_numpy at utterance {j}")
        ev = frame_evidence_from_log_probs(lp[j, :t_i], seq.tokens, oracle, 0)
        host_words = group_into_words(oracle, seq.tokens, seq.chars,
                                      seq.normalized_words, ev, 0, 4, stride_ms)
        if [w.word for w in outs[j]] != [w.word for w in host_words]:
            raise AssertionError(f"gate (b): word sequences differ at utterance {j}")
        for wd, wh in zip(outs[j], host_words):
            d = max(abs(wd.start_ms - wh.start_ms), abs(wd.end_ms - wh.end_ms))
            total += 1
            exact += d == 0
            within_one += d <= stride_ms
    if not (within_one == total and exact >= 0.99 * total):
        raise AssertionError(f"gate (b): {exact}/{total} exact, {within_one}/{total} within one frame")

    aligner_f32 = BatchAligner(cfg, params, vocab, compute_dtype="float32",
                               device=device, normalize_on_device=True)
    f32_handles = aligner_f32.submit_padded_batch(*inputs, return_log_probs=True)
    outs_f32 = [o.words for o in aligner_f32.group_batch(seqs, f32_handles)]
    lp_f32 = f32_handles[-1].cpu().numpy()
    diffs = []
    for j in range(batch):
        if [w.word for w in outs[j]] != [w.word for w in outs_f32[j]]:
            raise AssertionError(f"gate (c): bf16 vs f32 word sequences differ at utterance {j}")
        t_i = int(t_lens[j])
        diffs.append(np.abs(lp[j, :t_i].astype(np.float64) - lp_f32[j, :t_i]).ravel())
    diffs = np.concatenate(diffs)
    mean_d, p99_d = float(diffs.mean()), float(np.percentile(diffs, 99))
    if not (mean_d <= 0.05 and p99_d <= 0.3):
        raise AssertionError(f"gate (c): bf16 vs f32 log-probs mean|Δ|={mean_d} (cap 0.05), "
                             f"p99|Δ|={p99_d} (cap 0.3)")
    if not all(len(w) > 0 for w in outs):
        raise AssertionError("an utterance aligned to no words")
    print(f"batch entry, {label}: {batch} x {seconds:g} s bf16, gates passed: (a) paths == "
          f"viterbi_numpy "
          f"({n_check} utts); (b) grouping {exact}/{total} exact, {within_one}/{total} within "
          f"one frame; (c) bf16 vs f32 log-probs mean|Δ|={mean_d} p99|Δ|={p99_d}, words equal")
    return aligner, inputs


def check_words(words, want, what):
    """All `want` words, in order, with monotone boundaries."""
    if [w.word for w in words] != list(want):
        raise AssertionError(f"{what}: {len(words)} words, not the {len(want)} of the "
                             "transcript in order")
    for a, b in zip(words, words[1:]):
        if not (a.start_ms <= a.end_ms <= b.start_ms <= b.end_ms):
            raise AssertionError(f"{what}: words not monotone: {a} then {b}")


def run_long_bucket(aligner, cfg, vocab):
    """The padded-batch entry on a bucket longer than K1_MAX_FRAMES with
    short transcripts (S_pad=128): the tier rule selects K2. Checks paths
    against viterbi_numpy on two utterances and the words. Returns the
    kernel inputs (log-probs, tokens, t_lens, s_lens) on the device."""
    import torch

    from wav2vec2_tpu_torch.ops import viterbi_cuda
    from wav2vec2_tpu_torch.ops.viterbi_ref import viterbi_numpy

    seconds = viterbi_cuda.K1_MAX_FRAMES / 50 + 20
    seqs, *arrays = batch_inputs(np.random.default_rng(3), vocab, 4, seconds,
                                 n_words=8, s_pad=128)
    t_pad = cfg.conv_output_length(arrays[0].shape[1])
    tier = viterbi_cuda.select_tier(t_pad, 128, cfg.vocab_size)
    if tier != "k2":
        raise AssertionError(f"a {seconds:g} s bucket at S_pad=128 selects {tier}, not k2")
    inputs = [torch.from_numpy(a).to(aligner.device) for a in arrays]
    handles = aligner.submit_padded_batch(*inputs, return_log_probs=True)
    outs = aligner.group_batch(seqs, handles)
    paths, t_lens = handles[0].cpu().numpy(), handles[1].cpu().numpy()
    lp = handles[-1].cpu().numpy()
    for j in range(2):
        t_i = int(t_lens[j])
        oracle = [s for s, _ in viterbi_numpy(lp[j, :t_i], np.asarray(seqs[j].tokens))]
        if list(paths[j, :t_i]) != oracle:
            raise AssertionError(f"long bucket: K2 path differs from viterbi_numpy at {j}")
    for j, (seq, out) in enumerate(zip(seqs, outs)):
        check_words(out.words, seq.normalized_words, f"long bucket utterance {j}")
    print(f"batch entry, long bucket: 4 x {seconds:g} s (T={t_pad}, S_pad=128) bf16 -> tier "
          f"{tier}; paths == viterbi_numpy (2 utts), all words in order and monotone")
    return handles[-1], inputs[2], handles[1], inputs[3]


def write_model_dir(path: Path, cfg_dict, params_np, cfg, vocab):
    from wav2vec2_tpu_torch.models.params import params_to_hf_flat_dict
    from wav2vec2_tpu_torch.utils.checkpoint import save_safetensors

    (path / "config.json").write_text(json.dumps(cfg_dict))
    (path / "vocab.json").write_text(json.dumps(vocab))
    save_safetensors(path / "model.safetensors", params_to_hf_flat_dict(params_np, cfg))


def run_single_entry(device, model_dir: Path, durations, n_words):
    """ForcedAlignerBuilder → TorchRuntimeBackend → ViterbiSequenceAligner →
    DefaultWordGrouper, each request above kernel_dp_threshold. Returns the
    profiled outputs."""
    from wav2vec2_tpu_torch import AlignmentInput, ForcedAlignerBuilder, Wav2Vec2Config

    aligner = ForcedAlignerBuilder(Wav2Vec2Config(
        model_path=str(model_dir / "model.safetensors"),
        config_path=str(model_dir / "config.json"),
        vocab_path=str(model_dir / "vocab.json"),
        device=str(device),
    )).build()
    rng = np.random.default_rng(1)
    results = []
    for i, sec in enumerate(durations):
        transcript = " ".join(rng.choice(WORDS, size=n_words))
        samples = (rng.normal(size=int(sec * SAMPLE_RATE)) * 0.1).astype(np.float32)
        t_len = aligner.runtime_backend.model_cfg.conv_output_length(len(samples))
        s_len = len(aligner.tokenizer.tokenize(transcript, aligner.vocab, 0, 4).tokens)
        if t_len * s_len < aligner.hp.kernel_dp_threshold:
            raise AssertionError(f"request {i}: T*S={t_len * s_len} is below the "
                                 "device-dispatch threshold")
        res = aligner.align_profiled(AlignmentInput(SAMPLE_RATE, samples, transcript))
        check_words(res.output.words, transcript.split(), f"request {i}")
        results.append(res)
        print(f"single entry: request {i} ({sec:g} s, T={t_len}, S={s_len}): "
              f"{n_words} words, monotone; forward {res.timings.forward_ms:.3f} ms, "
              f"dp+evidence {res.timings.dp_ms:.3f} ms, total {res.timings.total_ms:.3f} ms")
    return results


def longform_pieces(audio, params_dev, cfg, device, compute_dtype, vocab, transcript):
    """What `align_longform` computes, piece by piece (not counted as a
    path run): chunk log-probs, the device stitch, the tokens. Returns
    (chunk lps, spans, n_frames, stitched device lps, padded tokens on the
    device, TokenSequence, s_len, forward ms)."""
    import torch

    from wav2vec2_tpu_torch.align import longform
    from wav2vec2_tpu_torch.align.tokenization import build_token_sequence_case_aware
    from wav2vec2_tpu_torch.pipeline.runtime import normalize_audio

    normalized = normalize_audio(audio)
    chunk, overlap = 30 * SAMPLE_RATE, 5 * SAMPLE_RATE
    with torch.inference_mode():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        lps, spans, n_frames = longform.chunk_log_probs(
            normalized, params_dev, cfg, chunk, overlap, compute_dtype, 32, device)
        end.record()
        end.synchronize()
        total = cfg.conv_output_length(len(audio))
        stitched = longform.stitch_device(lps, spans, n_frames, cfg.frame_stride_samples(),
                                          total)
    seq = build_token_sequence_case_aware(transcript, vocab, 0, 4)
    s_len = len(seq.tokens)
    tokens = np.zeros(-(-s_len // 128) * 128, np.int32)
    tokens[:s_len] = seq.tokens
    return (lps, spans, n_frames, stitched, torch.from_numpy(tokens).to(device), seq, s_len,
            start.elapsed_time(end))


def run_longform(device, cfg, params, vocab, minutes, card):
    """`align_longform` at full width, bf16, 30 s chunks with 5 s overlap, on
    white noise with the JAX example's transcript, counted as a path run.
    Then gates: (a) its tier's path equals the plain version's path on the
    same stitched log-probs, on the card; (b) the device-gather stitch
    equals `stitch_log_probs` bit for bit; (c) grouping from device evidence
    vs host grouping from host evidence: all words within one frame, >= 99%
    exact; (d) every word in order, boundaries monotone."""
    import torch

    from wav2vec2_tpu_torch import align_longform
    from wav2vec2_tpu_torch.align import longform
    from wav2vec2_tpu_torch.align.grouping import (
        frame_evidence_from_log_probs,
        group_into_words,
    )
    from wav2vec2_tpu_torch.ops import viterbi_cuda, viterbi_ref

    rng = np.random.default_rng(4)
    n = int(minutes * 60 * SAMPLE_RATE)
    audio = rng.normal(size=n).astype(np.float32)
    words = LONGFORM_WORDS * int(minutes * 15)
    transcript = " ".join(words)
    stride_ms = cfg.frame_stride_ms(SAMPLE_RATE)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    out = align_longform(audio, transcript, params, cfg, vocab, chunk_sec=30.0,
                         overlap_sec=5.0, compute_dtype="bfloat16", device=device)
    wall = time.perf_counter() - t0
    counts = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check_words(out.words, words, "gate (d)")

    params_dev = longform.device_params(params, "bfloat16", device)
    lps, spans, n_frames, stitched, tokens, seq, s_len, fwd_ms = longform_pieces(
        audio, params_dev, cfg, device, torch.bfloat16, vocab, transcript)
    t_len, v = stitched.shape
    tier = viterbi_cuda.select_tier(t_len, tokens.shape[0], v)
    if tier != "k4":
        raise AssertionError(f"the {minutes:g} min long-form DP selects {tier}, not k4")
    host_chunks = [lps[i, :n_f].cpu().numpy() for i, n_f in enumerate(n_frames)]
    host = longform.stitch_log_probs(host_chunks, spans, cfg.frame_stride_samples(), t_len)
    lp_host = stitched.cpu().numpy()
    if not np.array_equal(lp_host, host):
        raise AssertionError("gate (b): the device-gather stitch differs from stitch_log_probs")

    args = (stitched[None].contiguous(), tokens[None],
            torch.tensor([t_len], dtype=torch.int32, device=device),
            torch.tensor([s_len], dtype=torch.int32, device=device))
    kernel = lambda: viterbi_cuda.viterbi_batch(*args)  # noqa: E731
    path = kernel()[0].cpu().numpy()
    k_ms = kernel_ms(kernel, 5)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    plain = viterbi_ref.viterbi_batch(*args)[0]
    end.record()
    end.synchronize()
    p_ms = start.elapsed_time(end)
    err = int(np.abs(path.astype(np.int64) - plain.cpu().numpy()).max())
    if err:
        raise AssertionError(f"gate (a): the {tier} path differs from the plain version's")

    ev = frame_evidence_from_log_probs(lp_host, seq.tokens, path, 0)
    host_words = group_into_words(path, seq.tokens, seq.chars, seq.normalized_words,
                                  ev, 0, 4, stride_ms)
    if [w.word for w in host_words] != [w.word for w in out.words]:
        raise AssertionError("gate (c): word sequences differ")
    deltas = np.array([max(abs(a.start_ms - b.start_ms), abs(a.end_ms - b.end_ms))
                       for a, b in zip(out.words, host_words)])
    exact, within = int((deltas == 0).sum()), int((deltas <= stride_ms).sum())
    if not (within == len(deltas) and exact >= 0.99 * len(deltas)):
        raise AssertionError(f"gate (c): {exact}/{len(deltas)} exact, {within} within one frame")
    print(f"long-form: {minutes:g} min bf16 (T={t_len}, S={s_len}, S_pad={tokens.shape[0]}, "
          f"V={v}, {len(spans)} chunks) -> tier {tier}, launches {counts}; gates passed: "
          f"(a) {tier} path == plain path on the card; (b) device stitch == stitch_log_probs "
          f"bit for bit; (c) grouping {exact}/{len(deltas)} exact, {within}/{len(deltas)} "
          f"within one frame; (d) {len(out.words)} words in order, monotone")
    bp_bytes = int(np.prod(viterbi_cuda.bp_scratch_shape(tier, 1, t_len, tokens.shape[0], v)))
    r, threads = viterbi_cuda.library_strip(tokens.shape[0])
    print(f"{tier} at the {minutes:g} min shape: {r}-state strips on {threads} threads; "
          f"backpointer scratch {bp_bytes} B per launch (2 bits a cell, [1, {t_len}, "
          f"{bp_bytes // t_len}] uint8)")
    print(f"time: long-form {minutes:g} min {minutes * 60 / wall:.1f}x realtime "
          f"({wall:.3f} s wall, first call), forward {fwd_ms:.3f} ms, DP ({tier}) "
          f"{k_ms:.3f} ms (device time, median of 5), plain DP {p_ms:.1f} ms, peak device "
          f"memory {peak_gb:.2f} GB {card}")
    return counts, dict(tier=tier, ms=k_ms, plain_ms=p_ms, err=err,
                        shape=(1, t_len, v, tokens.shape[0], [t_len], [s_len]))


def run_longform_phoneme(device, cfg_ph, params_ph, vocab, minutes, card):
    """`align_longform` at full width with a phoneme-size vocabulary and a
    short transcript (one sentence in a long recording): S_pad=128 with
    V=392 at T beyond K2's on-chip bp, so the tier rule selects K3. Counted
    as a path run; checks every word in order and monotone, and times K3
    against its plain version on the same stitched log-probs."""
    import torch

    from wav2vec2_tpu_torch import align_longform
    from wav2vec2_tpu_torch.align import longform
    from wav2vec2_tpu_torch.ops import viterbi_cuda, viterbi_ref

    rng = np.random.default_rng(5)
    audio = rng.normal(size=int(minutes * 60 * SAMPLE_RATE)).astype(np.float32)
    transcript = " ".join(LONGFORM_WORDS)
    reset_launches()
    out = align_longform(audio, transcript, params_ph, cfg_ph, vocab, chunk_sec=30.0,
                         overlap_sec=5.0, compute_dtype="bfloat16", device=device)
    counts = read_launches()
    check_words(out.words, LONGFORM_WORDS, "phoneme-vocab long-form")

    params_dev = longform.device_params(params_ph, "bfloat16", device)
    _, _, _, stitched, tokens, _, s_len, _ = longform_pieces(
        audio, params_dev, cfg_ph, device, torch.bfloat16, vocab, transcript)
    t_len, v = stitched.shape
    tier = viterbi_cuda.select_tier(t_len, tokens.shape[0], v)
    if tier != "k3":
        raise AssertionError(f"the phoneme-vocab long-form DP selects {tier}, not k3")
    lens = [torch.tensor([x], dtype=torch.int32, device=device) for x in (t_len, s_len)]
    emit = viterbi_ref.gather_emissions(stitched[None], tokens[None])
    kernel = lambda: viterbi_cuda.viterbi_emissions_batch(emit, tokens[None], *lens, tier=tier)  # noqa: E731
    plain = lambda: viterbi_ref.viterbi_emissions_batch(emit, tokens[None], *lens)  # noqa: E731
    err = int((kernel().long() - plain().long()).abs().max())
    if err:
        raise AssertionError(f"phoneme long-form: {tier} path differs from the plain version")
    k_ms, p_ms = interleaved_ms(kernel, plain, 5, 1)
    bp_bytes = int(np.prod(viterbi_cuda.bp_scratch_shape(tier, 1, t_len, tokens.shape[0], v)))
    print(f"{tier} at the phoneme shape: {viterbi_cuda.library_strip(tokens.shape[0])[0]}-state "
          f"strips; backpointer scratch {bp_bytes} B per launch (2 bits a cell)")
    print(f"long-form, phoneme vocab: {minutes:g} min bf16 (T={t_len}, S={s_len}, "
          f"S_pad={tokens.shape[0]}, V={v}) -> tier {tier}, launches {counts}; "
          f"{len(out.words)} words in order, monotone; {tier} path == plain path")
    print(f"time: {tier} {k_ms:.4f} ms vs plain PyTorch {p_ms:.1f} ms at T={t_len} "
          f"S_pad={tokens.shape[0]} V={v} (device time, medians; plain, kernel, kernel, "
          f"plain) {card}")
    return counts, dict(tier=tier, ms=k_ms, plain_ms=p_ms, err=err,
                        shape=(1, t_len, v, tokens.shape[0], [t_len], [s_len]))


# --- the alignment_report CLI (its own phase) -------------------------------

CLI_CASES = 64
CLI_BUCKETS_S = (2, 4, 8, 16, 32)  # the CLI's pow2 grid of 1 s buckets
CLI_WORDS_PER_S = 2.5
CLI_PHONEME_CASES = 8


def phoneme_vocab() -> dict[str, int]:
    """A 392-entry phoneme-CTC vocab: the special tokens, "|", and IPA-style
    symbols, most of them several code points ("tʃ", "ɛ̃", "aː", "kʰ")."""
    vocab = {"<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3, "|": 4}
    bases = [*"abdefhijklmnopqrstuvwxzæçðŋøœɐɑɒɔəɛɜɡɣɪɲɹʁʃʊʌʒθ", "tʃ", "dʒ", "ts"]
    for mark in ("", "ː", "̃", "ʰ", "ʲ", "ʷ", "ˤ", "̥", "̪"):
        for base in bases:
            if len(vocab) == PHONEME_VOCAB:
                return vocab
            vocab[base + mark] = len(vocab)
    raise AssertionError("phoneme vocab too small")


def write_librispeech(root: Path, cases, rng) -> Path:
    """`cases` [(seconds, transcript)] as white-noise FLAC files (the port's
    encoder) under LibriSpeech/test-clean/<speaker>/<chapter>/ with one
    <speaker>-<chapter>.trans.txt per chapter, 16 utterances a speaker."""
    from wav2vec2_tpu_torch.data.flac_encoder import write_flac

    chapters: dict[Path, list[str]] = {}
    for i, (sec, text) in enumerate(cases):
        spk, chapter = 1000 + i // 16, 10 + i % 2
        base = root / "LibriSpeech" / "test-clean" / str(spk) / str(chapter)
        base.mkdir(parents=True, exist_ok=True)
        uid = f"{spk}-{chapter}-{i:04d}"
        x = (rng.normal(size=int(sec * SAMPLE_RATE)) * 4000).clip(-32768, 32767)
        write_flac(base / f"{uid}.flac", x.astype(np.int64), SAMPLE_RATE)
        chapters.setdefault(base, []).append(f"{uid} {text}")
    for base, lines in chapters.items():
        spk, chapter = base.parent.name, base.name
        (base / f"{spk}-{chapter}.trans.txt").write_text("\n".join(lines) + "\n",
                                                         encoding="utf-8")
    return root


def stream_order(keys, max_batch, max_in_flight, max_pending):
    """The order in which the JAX package's `align_stream` yields its inputs,
    from their bucket keys alone (None for a degenerate input): full buckets
    submit, the fullest flushes at `max_pending`, the rest submit in sorted
    key order, and a batch drains once more than `max_in_flight` wait."""
    order, pending, in_flight = [], {}, []

    def launch(entries):
        in_flight.append(entries)
        if len(in_flight) > max_in_flight:
            order.extend(in_flight.pop(0))

    for idx, key in enumerate(keys):
        if key is None:
            order.append(idx)
            continue
        entries = pending.setdefault(key, [])
        entries.append(idx)
        if len(entries) >= max_batch:
            del pending[key]
            launch(entries)
        elif sum(len(v) for v in pending.values()) >= max_pending:
            launch(pending.pop(max(pending, key=lambda k: len(pending[k]))))
    for key in sorted(pending):
        launch(pending[key])
    while in_flight:
        order.extend(in_flight.pop(0))
    return order


class CliProbe:
    """Records what the CLI's batch engine did, without changing it: per
    submitted batch its shape, the Viterbi launches it made (by tier and K1
    mode) and its device tensors (log-probs, tokens, lengths, paths); per
    drained batch of word units, the host grouping by the native engine and
    again by the Python path on the same evidence (their words must be
    bit-identical, or the run fails), with both times; per `align_stream`
    call its inputs and yields."""

    def __init__(self):
        self.run = None
        self.batches: list[dict] = []
        self.groups: list[dict] = []
        self.streams: list[dict] = []

    def __enter__(self):
        from wav2vec2_tpu_torch.parallel.batching import BatchAligner

        self._orig = {n: getattr(BatchAligner, n)
                      for n in ("submit_padded_batch", "group_batch", "align_stream")}
        for name, wrapper in (("submit_padded_batch", self._submit),
                              ("group_batch", self._group), ("align_stream", self._stream)):
            # a plain function, so that the aligner binds as its first argument
            setattr(BatchAligner, name,
                    lambda aligner, *a, _w=wrapper, **k: _w(aligner, *a, **k))
        return self

    def __exit__(self, *exc):
        from wav2vec2_tpu_torch.parallel.batching import BatchAligner

        for name, fn in self._orig.items():
            setattr(BatchAligner, name, fn)

    def _submit(self, aligner, audio, audio_lens, tokens, s_lens, return_log_probs=False):
        from wav2vec2_tpu_torch.ops import viterbi_cuda

        def counts():
            return {**viterbi_cuda.launches,
                    **{f"k1_{m}": n for m, n in viterbi_cuda.k1_launches.items()}}

        before = counts()
        handles = self._orig["submit_padded_batch"](aligner, audio, audio_lens, tokens,
                                                    s_lens, return_log_probs=True)
        after = counts()
        self.batches.append(dict(
            run=self.run, n_pad=int(audio.shape[1]), b=int(audio.shape[0]),
            launched={k: after[k] - before[k] for k in after if after[k] != before[k]},
            log_probs=handles[-1], tokens=np.asarray(tokens), s_lens=np.asarray(s_lens),
            paths=handles[0], t_lens=handles[1]))
        return handles

    def _group(self, aligner, seqs, handles):
        import dataclasses

        from wav2vec2_tpu_torch.align import grouping
        from wav2vec2_tpu_torch.parallel.batching import _host_arrays

        group = self._orig["group_batch"]
        _host_arrays(handles)  # wait for the host copies outside the timed calls
        if aligner.units != "word":
            return group(aligner, seqs, handles)
        calls = dict(grouping.engine_calls)
        # the grouping calls alone, inside group_batch (an instance
        # attribute shadows the method for these two calls)
        inner, spent = aligner._group, []

        def timed(*args):
            t = time.perf_counter()
            res = inner(*args)
            spent.append(time.perf_counter() - t)
            return res

        aligner._group = timed
        try:
            t0 = time.perf_counter()
            out = group(aligner, seqs, handles)
            t1 = time.perf_counter()
            native_inner = sum(spent)
            engines = {k: grouping.engine_calls[k] - calls[k] for k in calls}
            grouping.NATIVE_GROUPING = "off"
            try:
                ref = group(aligner, seqs, handles)
            finally:
                grouping.NATIVE_GROUPING = "require"
            t2 = time.perf_counter()
        finally:
            del aligner._group
        if [dataclasses.asdict(o) for o in out] != [dataclasses.asdict(o) for o in ref]:
            raise AssertionError(f"gate (b), {self.run}: the native engine's words differ "
                                 "from the Python path's on the same evidence")
        self.groups.append(dict(run=self.run, n=len(seqs), engines=engines,
                                native_ms=(t1 - t0) * 1e3, python_ms=(t2 - t1) * 1e3,
                                native_calls_ms=native_inner * 1e3,
                                python_calls_ms=(sum(spent) - native_inner) * 1e3))
        return out

    def _stream(self, aligner, items, **kw):
        rec = dict(run=self.run, aligner=aligner, items=[], yields=[], kw=kw)
        self.streams.append(rec)

        def tee():
            for item in items:
                rec["items"].append(item)
                yield item

        for idx, out in self._orig["align_stream"](aligner, tee(), **kw):
            rec["yields"].append((idx, out))
            yield idx, out


def cli_run(probe, label, argv):
    """One in-process `alignment_report.run`; returns its wall seconds."""
    from wav2vec2_tpu_torch.cli.alignment_report import run

    probe.run = label
    t0 = time.perf_counter()
    rc = run(argv)
    if rc != 0:
        raise AssertionError(f"alignment_report ({label}) exited {rc}")
    return time.perf_counter() - t0


def textgrid_words(path):
    from wav2vec2_tpu_torch.data.textgrid import parse_textgrid_file

    tier = parse_textgrid_file(path).tier("words")
    return [(iv.text, round(iv.xmin * 1000), round(iv.xmax * 1000))
            for iv in tier.intervals if iv.text.strip()]


def check_stream_gate(probe, stride_ms):
    """Gate (a): run 2's `align_stream` words equal `align_utterances` on the
    same inputs at f32, and its yields come in the JAX rules' order."""
    from wav2vec2_tpu_torch.parallel.batching import _pad_len

    rec = next(s for s in probe.streams if s["run"] == "run 2")
    aligner, kw = rec["aligner"], rec["kw"]
    audios = [np.asarray(a) for a, _ in rec["items"]]
    texts = [t for _, t in rec["items"]]
    keys = []
    for a, t in zip(audios, texts):
        seq = aligner._tokenize(t)
        degenerate = len(a) == 0 or not t.strip() or not seq.normalized_words
        keys.append(None if degenerate else (_pad_len(len(a), kw["audio_multiple"], "pow2"),
                                             _pad_len(len(seq.tokens), 128, "pow2")))
    want_order = stream_order(keys, kw["max_batch"], kw.get("max_in_flight", 2),
                              kw["max_pending"])
    got_order = [i for i, _ in rec["yields"]]
    if got_order != want_order:
        raise AssertionError(f"gate (a): align_stream yielded {got_order}, the JAX rules "
                             f"give {want_order}")
    full = aligner.align_utterances(audios, texts, audio_multiple=kw["audio_multiple"],
                                    max_batch=kw["max_batch"])
    streamed = dict(rec["yields"])
    for i, out in enumerate(full):
        got = [(w.word, w.start_ms, w.end_ms) for w in streamed[i].words]
        if got != [(w.word, w.start_ms, w.end_ms) for w in out.words] or not got:
            raise AssertionError(f"gate (a): utterance {i}: align_stream words differ from "
                                 "align_utterances")
    return len(full), len(set(keys))


def check_tiers_gate(probe, runs, device):
    """Gate (e): per tier that a run launched, the first batch that ran it:
    the drained paths equal the plain version's on that batch's log-probs
    (all rows, all frames)."""
    import torch

    from wav2vec2_tpu_torch.ops import viterbi_cuda

    checked = {}
    for batch in probe.batches:
        if batch["run"] not in runs:
            continue
        for tier in viterbi_cuda.TIERS:
            if batch["launched"].get(tier) and tier not in checked:
                tok = torch.from_numpy(batch["tokens"]).to(device)
                s_lens = torch.from_numpy(batch["s_lens"]).to(device)
                plain = plain_version(tier, batch["log_probs"], tok, batch["t_lens"], s_lens)
                err = int((batch["paths"].long() - plain.long()).abs().max())
                if err:
                    raise AssertionError(f"gate (e): {tier} paths differ from the plain "
                                         f"version on the {batch['n_pad'] / SAMPLE_RATE:g} s "
                                         "bucket")
                checked[tier] = (batch["n_pad"] // SAMPLE_RATE, batch["b"],
                                 tuple(batch["log_probs"].shape[1:]), tok.shape[1])
    return checked


def check_phoneme_gate(probe, vocab):
    """Gate (f): run 7's K1 launches all resident, and every row's drained
    path equals `viterbi_numpy` on its log-probs."""
    from wav2vec2_tpu_torch.ops.viterbi_ref import viterbi_numpy

    batches = [b for b in probe.batches if b["run"] == "run 7"]
    launched = {}
    rows = 0
    for batch in batches:
        for k, n in batch["launched"].items():
            launched[k] = launched.get(k, 0) + n
        lp = batch["log_probs"].float().cpu().numpy()
        paths, t_lens = batch["paths"].cpu().numpy(), batch["t_lens"].cpu().numpy()
        if lp.shape[2] != len(vocab):
            raise AssertionError(f"gate (f): log-probs of width {lp.shape[2]}")
        for j in range(batch["b"]):
            t_i, s_i = int(t_lens[j]), int(batch["s_lens"][j])
            ref = [s for s, _ in viterbi_numpy(lp[j, :t_i], batch["tokens"][j, :s_i])]
            if list(paths[j, :t_i]) != ref:
                raise AssertionError(f"gate (f): phoneme row {j} differs from viterbi_numpy")
            rows += 1
    if not launched.get("k1") or launched.get("k1_resident") != launched["k1"]:
        raise AssertionError(f"gate (f): the phoneme run's K1 launches were not all "
                             f"resident: {launched}")
    return launched, rows


def run_cli(device, card, params_np, cfg, vocab, phoneme_head):
    """The `alignment_report` CLI, in process, at the full width and depth
    of wav2vec2-base with random weights, on a LibriSpeech-layout dataset
    of 64 white-noise FLAC utterances that fill its 2, 4, 8, 16 and 32 s
    buckets (about 2.5 words a second), with the native grouping engine
    set to "require". Runs: (1) textgrid, batch, bf16; (2) textgrid,
    batch, f32; (3) textgrid, --no-batch, f32; (4) json over run 1's
    TextGrids; (5) perf on 4 cases; (6) srt; (7) --units phoneme on 8 cases
    with a 392-wide head and a phoneme vocab.json. Gates (a)–(f) raise;
    (g), compare_textgrids between runs 1 and 2, is printed. Returns the
    Viterbi launches of the runs (counted from 0 before each run)."""
    import contextlib
    import io

    import torch

    from wav2vec2_tpu_torch.cli import compare_textgrids
    from wav2vec2_tpu_torch.config import Wav2Vec2ModelConfig
    from wav2vec2_tpu_torch.data.audio import read_audio_mono

    rng = np.random.default_rng(11)
    cases = []
    for i in range(CLI_CASES):
        hi = CLI_BUCKETS_S[i % len(CLI_BUCKETS_S)]
        sec = float(hi * rng.uniform(0.55, 0.98))
        words = rng.choice(WORDS, size=max(1, round(CLI_WORDS_PER_S * sec)))
        cases.append((sec, " ".join(words)))
    ph_vocab = phoneme_vocab()
    symbols = [s for s in ph_vocab if ph_vocab[s] > 4]
    ph_cases = []
    for i in range(CLI_PHONEME_CASES):
        sec = float(rng.uniform(2.0, 7.5))
        n_words = max(1, round(CLI_WORDS_PER_S * sec))
        ph_cases.append((sec, " | ".join(" ".join(rng.choice(symbols, size=int(rng.integers(2, 6))))
                                         for _ in range(n_words))))
    stride_ms = cfg.frame_stride_ms(SAMPLE_RATE)
    totals = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        (tmp / "model").mkdir()
        (tmp / "model_ph").mkdir()
        write_model_dir(tmp / "model", BASE_CONFIG, params_np, cfg, vocab)
        ph_dict = {**BASE_CONFIG, "vocab_size": PHONEME_VOCAB}
        write_model_dir(tmp / "model_ph", ph_dict, {**params_np, "lm_head": phoneme_head},
                        Wav2Vec2ModelConfig.from_dict(ph_dict), ph_vocab)
        data = write_librispeech(tmp / "data", cases, rng)
        ph_data = write_librispeech(tmp / "data_ph", ph_cases, rng)
        flacs = sorted(data.rglob("*.flac"))
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        audio_s = sum(len(read_audio_mono(p)[0]) for p in flacs) / SAMPLE_RATE
        decode_ms = (time.perf_counter() - t0) * 1e3
        print(f"cli: dataset {len(flacs)} FLAC files, {audio_s:.1f} s of audio "
              f"({', '.join(f'{sum(1 for s, _ in cases if s <= b and s > b / 2)} in the {b} s bucket' for b in CLI_BUCKETS_S)}), "
              f"and two model directories written in {write_s:.1f} s")

        common = ["--model-dir", str(tmp / "model"), "--dataset-root", str(data),
                  "--device", str(device)]
        walls = {}
        probe = CliProbe()
        runs = (
            ("run 1", ["--output-format", "textgrid", "--compute-dtype", "bfloat16"]),
            ("run 2", ["--output-format", "textgrid", "--compute-dtype", "float32",
                       "--textgrid-suffix", "_f32"]),
            ("run 3", ["--output-format", "textgrid", "--compute-dtype", "float32",
                       "--textgrid-suffix", "_single", "--no-batch"]),
            ("run 4", ["--output-format", "json", "--compute-dtype", "bfloat16",
                       "--out", str(tmp / "report.json")]),
            ("run 5", ["--output-format", "perf", "--compute-dtype", "bfloat16",
                       "--limit", "4", "--perf-warmup", "2", "--perf-repeats", "5",
                       "--perf-out", str(tmp / "perf.json")]),
            ("run 6", ["--output-format", "srt", "--compute-dtype", "bfloat16"]),
            ("run 7", ["--model-dir", str(tmp / "model_ph"), "--dataset-root",
                       str(ph_data), "--units", "phoneme", "--output-format",
                       "textgrid", "--compute-dtype", "bfloat16"]))
        with probe:
            for label, extra in runs:
                reset_launches()
                walls[label] = cli_run(probe, label, common + extra)
                counts = read_launches()
                totals[label] = counts
                print(f"cli {label}: {' '.join(extra[:2] + extra[-2:])}: wall "
                      f"{walls[label]:.3f} s; launches "
                      f"{ {k: n for k, n in counts.items() if n} } {card}")

        # gate (a): align_stream == align_utterances, in the JAX order
        n_stream, n_keys = check_stream_gate(probe, stride_ms)
        # gate (b) ran inside every drain; summarise it
        groups = [g for g in probe.groups if g["run"] in ("run 1", "run 2")]
        if not groups or any(g["engines"] != {"native": g["n"], "python": 0} for g in groups):
            raise AssertionError(f"gate (b): a batch was not grouped by the native engine: "
                                 f"{[g['engines'] for g in groups]}")
        # gate (c): batch vs single at f32
        total = exact = within = 0
        for tg in sorted(data.rglob("*_f32.TextGrid")):
            a = textgrid_words(tg)
            b = textgrid_words(tg.with_name(tg.name.replace("_f32", "_single")))
            if [w for w, *_ in a] != [w for w, *_ in b] or not a:
                raise AssertionError(f"gate (c): {tg.name}: batch and single words differ")
            for (_, s1, e1), (_, s2, e2) in zip(a, b):
                d = max(abs(s1 - s2), abs(e1 - e2))
                total += 1
                exact += d == 0
                within += d <= stride_ms
        n_tg = len(list(data.rglob("*_single.TextGrid")))
        if n_tg != CLI_CASES or within != total or exact < 0.99 * total:
            raise AssertionError(f"gate (c): {n_tg} single TextGrids; {exact}/{total} exact, "
                                 f"{within}/{total} within one frame")
        # run 4's report scored against run 1's TextGrids
        report = json.loads((tmp / "report.json").read_text())
        if (report["meta"]["case_count"] != CLI_CASES
                or report["meta"]["device"] != torch.device(device).type):
            raise AssertionError(f"json report: {report['meta']}")
        abs_err = report["aggregates"]["global"]["abs_err_ms_p90"]
        # gate (d): device memory readings of the perf run
        perf = json.loads((tmp / "perf.json").read_text())
        mem = [stage for r in perf["records"] for stage in r["memory"].values()]
        if len(perf["records"]) != 4 or not mem or any(
                s.get("gpu_used") is None or s.get("gpu_total") is None for s in mem):
            raise AssertionError(f"gate (d): perf memory readings {mem}")
        if len(list(data.rglob("*.srt"))) != CLI_CASES:
            raise AssertionError("run 6 wrote fewer SRT files than cases")
        # gate (e): each tier of runs 1-2 against its plain version
        checked = check_tiers_gate(probe, ("run 1", "run 2"), device)
        if not (totals["run 1"]["k1"] + totals["run 2"]["k1"]
                and totals["run 1"]["k2"] + totals["run 2"]["k2"]):
            raise AssertionError(f"gate (e): the batch runs launched "
                                 f"{totals['run 1']} and {totals['run 2']}")
        # gate (f): phoneme units, K1 resident, paths == viterbi_numpy
        ph_launched, ph_rows = check_phoneme_gate(probe, ph_vocab)
        ph_units = sum(len(textgrid_words(p)) for p in ph_data.rglob("*.TextGrid"))
        # (g): compare_textgrids, run 1 (bf16) against run 2 (f32), reported
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = compare_textgrids.run([str(data), "--suffix", "_f32", "--extended"])
        medians = json.loads(out.getvalue())

    by_bucket = {}
    for b in probe.batches:
        if b["run"] in ("run 1", "run 2"):
            key = f"{b['n_pad'] // SAMPLE_RATE} s/S_pad {b['tokens'].shape[1]}"
            for tier, n in b["launched"].items():
                by_bucket.setdefault(key, {}).setdefault(tier, 0)
                by_bucket[key][tier] += n
    nat = [g["native_ms"] for g in groups]
    py = [g["python_ms"] for g in groups]
    n_utts = sum(g["n"] for g in groups)
    print(f"cli gates passed: (a) run 2's align_stream == align_utterances ({n_stream} "
          f"utterances, {n_keys} buckets) and yields in the JAX rules' order; (b) native == "
          f"Python grouping on all {len(groups)} batches of runs 1-2 ({n_utts} utterances); "
          f"(c) batch vs --no-batch at f32: {exact}/{total} exact, {within}/{total} within "
          f"one frame, same words; (d) perf memory readings non-null ({len(mem)} stages); "
          f"(e) tiers vs plain version on one bucket each: {checked}; (f) phoneme run: "
          f"{ph_rows} rows == viterbi_numpy, launches {ph_launched}, {ph_units} units; "
          f"json report abs_err_ms_p90 {abs_err} vs run 1")
    print(f"cli (g) compare_textgrids run 1 (bf16) vs run 2 (f32), exit {rc}: {medians}")
    print(f"time: cli run 1 (textgrid, batch, bf16) wall {walls['run 1']:.3f} s for "
          f"{audio_s:.1f} s of audio = {audio_s / walls['run 1']:.1f}x realtime (model load, "
          f"decode, align, write); run 2 (f32) {walls['run 2']:.3f} s = "
          f"{audio_s / walls['run 2']:.1f}x; run 3 (--no-batch, f32) {walls['run 3']:.3f} s "
          f"{card}")
    print(f"time: FLAC decode {decode_ms:.1f} ms for {len(flacs)} files, {audio_s:.1f} s of "
          f"audio, one thread ({decode_ms / audio_s:.3f} ms per audio second) {card}")
    nat_calls = sum(g["native_calls_ms"] for g in groups)
    py_calls = sum(g["python_calls_ms"] for g in groups)
    print(f"time: host grouping per batch of runs 1-2 ({len(groups)} batches, "
          f"{n_utts / len(groups):.1f} utterances a batch): group_batch with the native engine "
          f"{statistics.mean(nat):.2f} ms (median {statistics.median(nat):.2f}), with the Python "
          f"path {statistics.mean(py):.2f} ms (median {statistics.median(py):.2f}) on the same "
          f"batches, {sum(py) / sum(nat):.1f}x; the grouping calls alone "
          f"{nat_calls / n_utts:.3f} vs {py_calls / n_utts:.3f} ms an utterance, "
          f"{py_calls / nat_calls:.1f}x {card}")
    print(f"cli launches by bucket (runs 1-2): {by_bucket}")
    out = {}
    for counts in totals.values():
        for k, n in counts.items():
            out[k] = out.get(k, 0) + n
    return out


def hour_scale(device, card):
    """K4 vs K1 at T=180 000 on random log-probs (V=32, S=11 127 and V=392,
    S=12 599): bit-identical paths (K1 is held to the plain version above;
    the plain version at this T would take minutes), and both timed."""
    import torch

    from wav2vec2_tpu_torch.ops import viterbi_cuda

    rng = np.random.default_rng(6)
    rows = []
    for v, s_len in ((32, 11_127), (PHONEME_VOCAB, 12_599)):
        gen = torch.Generator(device=device).manual_seed(v)
        lp = torch.log_softmax(
            torch.randn((1, HOUR_FRAMES, v), generator=gen, device=device) * 3.0, dim=-1)
        s_pad = -(-s_len // 128) * 128
        tok = torch.from_numpy(rng.integers(0, v, size=(1, s_pad)).astype(np.int32)).to(device)
        lens = [torch.tensor([x], dtype=torch.int32, device=device) for x in (HOUR_FRAMES, s_len)]
        k4 = viterbi_cuda.viterbi_batch(lp, tok, *lens, tier="k4")
        k1 = viterbi_cuda.viterbi_batch(lp, tok, *lens, tier="k1")
        err = int((k4.long() - k1.long()).abs().max())
        if err:
            raise AssertionError(f"hour scale V={v}: K4 path differs from K1's")
        ms = turns_ms({tier: (lambda tier=tier: viterbi_cuda.viterbi_batch(lp, tok, *lens,
                                                                          tier=tier))
                       for tier in ("k1", "k4")}, 2)
        k4_ms, k1_ms = ms["k4"], ms["k1"]
        bp_bytes = int(np.prod(viterbi_cuda.bp_scratch_shape("k4", 1, HOUR_FRAMES, s_pad, v)))
        print(f"hour scale: T={HOUR_FRAMES} V={v} S={s_len} S_pad={s_pad}: K4 path == K1 path; "
              f"K4 {k4_ms:.3f} ms ({viterbi_cuda.library_strip(s_pad)[0]}-state strips, "
              f"backpointer scratch {bp_bytes} B), K1 ({viterbi_cuda.k1_mode(HOUR_FRAMES, s_pad, v)}"
              f" mode) {k1_ms:.3f} ms (device time; K1, K4, K4, K1) {card}")
        rows.append((HOUR_FRAMES, s_pad, v, k1_ms, k4_ms, None,
                     viterbi_cuda.k1_mode(HOUR_FRAMES, s_pad, v)))
        del lp
    return rows


def tier_crossover(device, card, hour_rows):
    """K1 against gather + K2 and K4 on one utterance at V=32: the grid T in
    {599, 1 024, 1 499, 2 400} x S_pad in {128, 256}, where K1 runs
    resident (the rows for a routing rule past K1_MAX_FRAMES), then the rows
    behind K1_MAX_FRAMES, S growing with T as transcripts do (T in
    {1 024, 1 499, 6 000, 30 000, 20 000}; 180 000 from `hour_scale`).
    T = 20 000 at S_pad = 16 384 runs K4's widest strips (512 threads of 32
    states). Every kernel's path equals K1's."""
    import torch

    from wav2vec2_tpu_torch.ops import viterbi_cuda

    rng = np.random.default_rng(7)
    rows = []
    grid = [(t, s_pad) for t in (599, 1_024, 1_499, 2_400) for s_pad in (128, 256)]
    for t, s_pad in grid + [(1_024, 512), (1_499, 768), (6_000, 2_432), (30_000, 12_032),
                            (20_000, 16_384)]:
        lp = torch.from_numpy(random_log_probs(rng, 1, t, 32)).to(device)
        tok = torch.from_numpy(rng.integers(0, 32, size=(1, s_pad)).astype(np.int32)).to(device)
        lens = [torch.tensor([x], dtype=torch.int32, device=device) for x in (t, s_pad - 5)]
        fns = {tier: (lambda tier=tier: viterbi_cuda.viterbi_batch(lp, tok, *lens, tier=tier))
               for tier in ("k1", "k2", "k4")}
        try:
            viterbi_cuda.check_fits("k2", t, s_pad, 32)
        except ValueError:
            del fns["k2"]
        want = fns["k1"]()
        for tier, fn in fns.items():
            if not torch.equal(fn(), want):
                raise AssertionError(f"crossover T={t} S_pad={s_pad}: {tier} path differs "
                                     "from K1's")
        ms = turns_ms(fns, 5)
        rows.append((t, s_pad, 32, ms["k1"], ms["k4"], ms.get("k2"),
                     viterbi_cuda.k1_mode(t, s_pad, 32)))
    for t, s_pad, v, k1_ms, k4_ms, k2_ms, mode in rows + hour_rows:
        k2 = f"gather + K2 {k2_ms:.3f} ms, " if k2_ms is not None else "K2 does not fit, "
        print(f"tier crossover: T={t} S_pad={s_pad} V={v}: K1 ({mode} mode) {k1_ms:.3f} ms, "
              f"{k2}K4 {k4_ms:.3f} ms, K4/K1 {k4_ms / k1_ms:.3f} {card}")


def time_k1(device, card, cases, k_ms, p_ms):
    """K1 beside the earlier design and its bound: at the serving shape
    (cases[0], B=128, T=499, S_pad=256) the resident mode against the
    device mode (the kernel's first design, which the shape took before the
    resident mode existed) on the same inputs, and the same at B=32 and B=1
    (the first rows); the strip widths R of K1_STRIPS in the resident mode;
    and the device mode at the large case (cases[-1]). `k_ms`, `p_ms`: the serving shape's kernel and plain
    times. Every path is held to the plain version's."""
    import torch

    from wav2vec2_tpu_torch.ops import viterbi_cuda, viterbi_ref

    _, lp, tok, t_lens, s_lens = cases[0]
    b, t, v = lp.shape
    s_pad = tok.shape[1]
    r, threads = viterbi_cuda.library_strip(s_pad, "k1")
    smem = viterbi_cuda.library_smem_bytes("k1", t, s_pad, v)
    args = [torch.from_numpy(a).to(device) for a in (lp, tok, t_lens, s_lens)]
    want = viterbi_ref.viterbi_batch(*args)
    bound_ms, bound_by = dp_bound("k1", b, t, v, s_pad, t_lens, s_lens)
    print(f"time: K1 resident ({r}-state strips on {threads} threads, {smem} B of shared "
          f"memory a block) {k_ms:.4f} ms vs plain PyTorch {p_ms:.4f} ms at B={b} T={t} "
          f"S_pad={s_pad}; bound {bound_ms:.5f} ms by {bound_by}, {bound_ms / k_ms:.2%} of it "
          f"(device time, medians; plain, kernel, kernel, plain) {card}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        viterbi_cuda.viterbi_batch(*args)
    host_us = (time.perf_counter() - t0) / 20 * 1e6
    torch.cuda.synchronize()
    print(f"time: K1's wrapper (viterbi_batch) costs the host {host_us:.1f} us a call to "
          f"enqueue (host clock over 20 calls); one call timed alone between two events "
          f"measures the larger of that and the kernel {card}")
    for rows in (b, 32, 1):
        sub = [a[:rows] for a in args]
        fns = {mode: (lambda mode=mode: viterbi_cuda.k1_batch(*sub, mode=mode))
               for mode in viterbi_cuda.K1_MODES}
        for mode, fn in fns.items():
            if not torch.equal(fn(), want[:rows]):
                raise AssertionError(f"K1 {mode} mode at B={rows}: path differs from the plain "
                                     "version's")
        ms = turns_ms(fns, 50)
        bound_ms, _ = dp_bound("k1", rows, t, v, s_pad, t_lens[:rows], s_lens[:rows])
        print(f"time: K1 at B={rows} T={t} S_pad={s_pad}: resident mode {ms['resident']:.4f} ms, "
              f"device mode (the first design) {ms['device']:.4f} ms, "
              f"{ms['device'] / ms['resident']:.2f}x; bound {bound_ms:.5f} ms (device time, "
              f"medians; resident, device, device, resident) {card}")
    fns = {}
    for strip in viterbi_cuda.K1_STRIPS:
        fns[strip] = lambda strip=strip: viterbi_cuda.k1_batch(*args, mode="resident",
                                                                 strip=strip)
        if not torch.equal(fns[strip](), want):
            raise AssertionError(f"K1 resident with {strip}-state strips: path differs from "
                                 "the plain version's")
    ms = turns_ms(fns, 50)
    print(f"time: K1 resident strip sweep at B={b} T={t} S_pad={s_pad}: "
          + ", ".join(f"R={strip} ({-(-s_pad // strip // 32)} warps) {t_ms:.4f} ms"
                      for strip, t_ms in ms.items())
          + f"; the launcher takes R={r} (device time, medians; R up, then down) {card}")
    name, lp, tok, t_lens, s_lens = cases[-1]
    b, t, v = lp.shape
    s_pad = tok.shape[1]
    mode = viterbi_cuda.k1_mode(t, s_pad, v)
    args = [torch.from_numpy(a).to(device) for a in (lp, tok, t_lens, s_lens)]
    large_ms = kernel_ms(lambda: viterbi_cuda.viterbi_batch(*args, tier="k1"), 10)
    bound_ms, bound_by = dp_bound("k1", b, t, v, s_pad, t_lens, s_lens)
    print(f"time: K1 ({mode} mode) {large_ms:.4f} ms at the {name} case; bound "
          f"{bound_ms:.5f} ms by {bound_by} (device time, median of 10) {card}")


def time_batch_path(aligner, vocab, batch, repeats):
    """Steady-state throughput of the batch entry, as bench.py measures
    it: input staged on the device once, then `repeats` batches
    double-buffered (the next batch is enqueued before this one's results
    are drained and grouped on the host). Returns (realtime factor, wall
    seconds, peak device memory in GB, ms per batch spent waiting for the
    host copies, ms per batch grouping)."""
    import torch

    seqs, *arrays = batch_inputs(np.random.default_rng(2), vocab, batch, 10.0)
    inputs = [torch.from_numpy(a).to(aligner.device) for a in arrays]
    for _ in range(2):  # warm-up, two batches in flight as below
        aligner.group_batch(seqs, aligner.submit_padded_batch(*inputs))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wait_s = group_s = 0.0

    def drain(handles):
        nonlocal wait_s, group_s
        t0 = time.perf_counter()
        handles.copied.synchronize()
        t1 = time.perf_counter()
        outs = aligner.group_batch(seqs, handles)
        wait_s += t1 - t0
        group_s += time.perf_counter() - t1
        return outs

    t0 = time.perf_counter()
    inflight = aligner.submit_padded_batch(*inputs)
    for _ in range(repeats - 1):
        nxt = aligner.submit_padded_batch(*inputs)
        drain(inflight)
        inflight = nxt
    outs = [o.words for o in drain(inflight)]
    total_s = time.perf_counter() - t0
    if not all(len(w) > 0 for w in outs):
        raise AssertionError(f"B={batch}: an utterance aligned to no words in the timed loop")
    return (repeats * batch * 10.0 / total_s, total_s,
            torch.cuda.max_memory_allocated() / 1e9,
            wait_s / repeats * 1e3, group_s / repeats * 1e3)


def flash_cases():
    """(name, B, NH, T, hd, dtype, rel, masked) for K5 against its plain
    version: both dtypes (bf16 through the tensor-core kernel, f32 through
    the FMA kernel), rel on and off, masked and unmasked, at odd T (37 and
    255 pad to 256, 257 and 499 to 512, 1 499 — the 30 s chunk — to 1 536)
    and head dims 16, 32, 64, 128 and 80 (zero-filled to the 128-wide
    template); bf16 at T = 1 499 with hd 64 and 128; then the slice's shape
    with B cut to 4 (bf16) and 2 (f32)."""
    cases = []
    for t, hd in ((37, 32), (255, 64), (257, 128), (499, 64), (1499, 32), (100, 80),
                  (300, 16)):
        for dtype in ("float32", "bfloat16"):
            for rel, masked in ((True, True), (True, False), (False, True), (False, False)):
                cases.append((f"T={t} hd={hd} {dtype} rel={int(rel)} mask={int(masked)}",
                              2, 2, t, hd, dtype, rel, masked))
    for hd in (64, 128):
        cases.append((f"T=1499 hd={hd} bfloat16 rel=1 mask=1", 2, 2, 1499, hd, "bfloat16",
                      True, True))
    cases.append(("slice B=4 NH=16 T=499 hd=64 bfloat16 rel mask",
                  4, 16, 499, 64, "bfloat16", True, True))
    cases.append(("slice B=2 NH=16 T=499 hd=64 float32 rel mask",
                  2, 16, 499, 64, "float32", True, True))
    return cases


def flash_inputs(rng, b, nh, t, hd, dtype, rel, masked, device):
    """q, k, v, mask, q_pos, rel_r for one K5 case, from a numpy generator:
    normal q, k, v (and q_pos), key masks of random valid lengths (row 0
    unmasked), rel_r from a random linear_pos kernel by `rel_table_rev`."""
    import torch

    from wav2vec2_tpu_torch.ops import flash_attention as fa

    dt = getattr(torch, dtype)

    def normal(shape, scale=1.0):
        x = rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)
        return torch.from_numpy(x).to(device=device, dtype=dt)

    q, k, v = (normal((b, nh, t, hd)) for _ in range(3))
    mask = None
    if masked:
        lens = rng.integers(t // 2, t + 1, size=b)
        lens[0] = t
        mask = torch.from_numpy(np.where(np.arange(t)[None] < lens[:, None], 0.0, -np.inf)
                                .astype(np.float32)).to(device)
    q_pos = rel_r = None
    if rel:
        w_pos = normal((nh * hd, nh * hd), 0.1).float()
        rel_r = fa.rel_table_rev(w_pos, nh, fa.pad_len(t), dt)
        q_pos = normal((b, nh, t, hd))
    return q, k, v, mask, q_pos, rel_r


def flash_plain(q, k, v, mask, q_pos, rel_r, scale):
    """K5's plain version on the inputs the wrapper gives the kernel."""
    from wav2vec2_tpu_torch.models.layers import full_f32_precision
    from wav2vec2_tpu_torch.ops import flash_attention as fa
    from wav2vec2_tpu_torch.ops import flash_attention_ref

    t = q.shape[2]
    pq, pk, pv, pmask, pq_pos = fa.pad_inputs(q, k, v, mask, q_pos, rel_r)
    with full_f32_precision():
        out = flash_attention_ref.attention(pq, pk, pv, pmask, q_pos=pq_pos, rel_r=rel_r,
                                            scale=scale)
    return out[:, :, :t]


def check_flash(device, cases):
    """K5 vs its plain version on every case, within FLASH_REL_BOUND
    relative to the largest output; one launch per case. Returns the
    largest absolute difference."""
    import torch

    from wav2vec2_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(12)
    worst, lines = 0.0, []
    for name, b, nh, t, hd, dtype, rel, masked in cases:
        q, k, v, mask, q_pos, rel_r = flash_inputs(rng, b, nh, t, hd, dtype, rel, masked,
                                                   device)
        got = fa.flash_attention(q, k, v, mask, q_pos=q_pos, rel_r=rel_r, scale=hd ** -0.5)
        plain = flash_plain(q, k, v, mask, q_pos, rel_r, hd ** -0.5).float()
        err = float((got.float() - plain).abs().max())
        rel_err = err / float(plain.abs().max())
        if not (torch.isfinite(got).all() and rel_err <= FLASH_REL_BOUND[dtype]):
            raise AssertionError(f"K5 [{name}]: relative error {rel_err} against the plain "
                                 f"version (bound {FLASH_REL_BOUND[dtype]})")
        worst = max(worst, err)
        lines.append(f"{name}: {rel_err:.2e}")
    print(f"kernel check k5: {len(cases)} cases within {FLASH_REL_BOUND} of the plain version "
          f"(relative max error): " + "; ".join(lines))
    return worst


def flash_bound(b, nh, t_pad, hd, elem_bytes, peak_ops):
    """(bound_ms, bound_by) of one K5 launch: bytes moved once (q, q_pos,
    k, v read, out written, the 2·T_pad − 1 table rows read, the f32 mask)
    over 3.35 TB/s, against 6·T_pad²·hd operations per (batch, head) —
    q·kᵀ, the position term, P·V — over `peak_ops`."""
    n = b * nh * t_pad * hd
    nbytes = elem_bytes * (5 * n + nh * (2 * t_pad - 1) * hd) + 4 * b * t_pad
    ops = 6 * t_pad * t_pad * hd * b * nh
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_flash(device, card, self_attn, b, nh, t, hd):
    """K5 at the slice's shape (for the conformer large at 32 × 10 s: B=32,
    NH=16, T=499 → T_pad=512, hd=64; bf16, rel, masked): the kernel alone
    on padded inputs, its plain
    version, one library call (scaled_dot_product_attention with the
    position term and mask as a precomputed bf16 bias), and the port's
    factorized attention core at the same shape (layer 0's biases and
    linear_pos), and the f32 FMA kernel at the same shape (the conformer's
    f32 forward launches it). Checks both kernels against the plain
    version there too."""
    import torch
    import torch.nn.functional as F

    from wav2vec2_tpu_torch.models.encoder import _attention_core
    from wav2vec2_tpu_torch.ops import flash_attention as fa
    from wav2vec2_tpu_torch.ops import flash_attention_ref

    scale = hd ** -0.5
    rng = np.random.default_rng(13)
    q, k, v, mask, q_pos, rel_r = flash_inputs(rng, b, nh, t, hd, "bfloat16", True, True,
                                               device)
    pq, pk, pv, pmask, pq_pos = fa.pad_inputs(q, k, v, mask, q_pos, rel_r)
    t_pad = pq.shape[2]
    kernel = lambda: fa.flash_attention(pq, pk, pv, pmask, q_pos=pq_pos, rel_r=rel_r,  # noqa: E731
                                        scale=scale)
    plain = lambda: flash_attention_ref.attention(pq, pk, pv, pmask, q_pos=pq_pos,  # noqa: E731
                                                  rel_r=rel_r, scale=scale)
    got, want = kernel().float(), plain().float()
    err = float((got - want).abs().max())
    rel_err = err / float(want.abs().max())
    if rel_err > FLASH_REL_BOUND["bfloat16"]:
        raise AssertionError(f"K5 at the slice's shape: relative error {rel_err}")
    k_ms, p_ms = interleaved_ms(kernel, plain, 20, 3)

    with torch.inference_mode():
        bias = (flash_attention_ref.rel_scores(pq_pos, rel_r) * scale
                + pmask[:, None, None, :]).to(torch.bfloat16)
        library = lambda: F.scaled_dot_product_attention(pq, pk, pv, attn_mask=bias,  # noqa: E731
                                                         scale=scale)
        lib_err = float((library().float() - want).abs().max()) / float(want.abs().max())
        library()
        lib_ms = kernel_ms(library, 20)
        del bias
        mask_bias = mask[:, None, None, :]
        core = lambda: _attention_core(self_attn, q, k, v, mask_bias, "relative",  # noqa: E731
                                       nh * hd)
        core()
        core_ms = kernel_ms(core, 10)
    # the f32 launches of the conformer's parity forward: the FMA kernel
    q32, k32, v32, mask32, q_pos32, rel_r32 = flash_inputs(rng, b, nh, t, hd, "float32", True,
                                                           True, device)
    got32 = fa.flash_attention(q32, k32, v32, mask32, q_pos=q_pos32, rel_r=rel_r32, scale=scale)
    want32 = flash_plain(q32, k32, v32, mask32, q_pos32, rel_r32, scale)
    f32_rel = float((got32 - want32).abs().max()) / float(want32.abs().max())
    if f32_rel > FLASH_REL_BOUND["float32"]:
        raise AssertionError(f"K5 f32 at the slice's shape: relative error {f32_rel}")
    del got32, want32
    p32 = fa.pad_inputs(q32, k32, v32, mask32, q_pos32, rel_r32)
    f32_ms = kernel_ms(lambda: fa.flash_attention(*p32[:4], q_pos=p32[4], rel_r=rel_r32,
                                                  scale=scale), 10)
    f32_bound, f32_by = flash_bound(b, nh, t_pad, hd, 4, PEAK_F32_OPS_PER_S)
    del q32, k32, v32, p32
    bound_ms, bound_by = flash_bound(b, nh, t_pad, hd, 2, PEAK_BF16_OPS_PER_S)
    work = 6 * t_pad * t_pad * hd * b * nh
    print(f"time: K5 bf16 (tensor cores) {work / (k_ms * 1e-3) / 1e12:.1f} TFLOP/s of the "
          f"6·T_pad²·hd work, {bound_ms / k_ms:.1%} of its bound ({bound_ms:.4f} ms by "
          f"{bound_by}); SDPA {lib_ms:.4f} ms, K5/SDPA {k_ms / lib_ms:.2f} {card}")
    print(f"time: K5 kernel {k_ms:.4f} ms vs plain PyTorch {p_ms:.3f} ms at B={b} NH={nh} "
          f"T={t} (T_pad={t_pad}) hd={hd} bf16 rel mask (device time, medians; plain, kernel, "
          f"kernel, plain); bound {bound_ms:.4f} ms by {bound_by}; relative error "
          f"{rel_err:.2e} {card}")
    print(f"time: K5 f32 (FMA kernel, the parity forward's launches) {f32_ms:.4f} ms vs bf16 "
          f"{k_ms:.4f} ms at B={b} NH={nh} T={t} (T_pad={t_pad}) hd={hd} rel mask; f32 bound "
          f"{f32_bound:.4f} ms by {f32_by} (67 TFLOP/s f32); relative error {f32_rel:.2e}"
          f" (device time, median of 10) {card}")
    print(f"time: library call scaled_dot_product_attention(q, k, v, attn_mask=bd*scale + "
          f"mask, scale) {lib_ms:.4f} ms at the same shape (bd precomputed, its construction "
          f"excluded; relative difference to the plain version {lib_err:.2e}); the port's "
          f"factorized attention core {core_ms:.4f} ms (device time, medians) {card}")
    return dict(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, bound_ms=bound_ms,
                bound_by=bound_by, err=err, f32_ms=f32_ms)


def kernel_time_split(fwd):
    """Device time of one call of `fwd` by kernel, from torch.profiler:
    {group: ms} over K5, GEMMs, convolutions and the rest, the total, and
    the five longest kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fwd()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fwd()
        torch.cuda.synchronize()
    kernels = [(e.key, e.device_time_total / 1e3) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    groups = {"K5": 0.0, "GEMM": 0.0, "convolution": 0.0, "other": 0.0}
    for name, ms in kernels:
        low = name.lower()
        group = ("K5" if "flash_attention" in low
                 else "GEMM" if any(w in low for w in ("gemm", "nvjet", "xmma", "cutlass"))
                 else "convolution" if "conv" in low or "cudnn" in low
                 else "other")
        groups[group] += ms
    top = sorted(kernels, key=lambda kv: -kv[1])[:5]
    return groups, sum(groups.values()), top


def conformer_params(cfg, seed):
    """Numpy random-init conformer tree with non-zero pos_bias_u/v and a
    non-identity BatchNorm affine (both zero or identity in init_params,
    where a wrong bias or BatchNorm path would pass unseen)."""
    from wav2vec2_tpu_torch.models.params import init_params

    tree = init_params(cfg, seed=seed)
    rng = np.random.default_rng(seed + 1)
    layers = tree["encoder"]["layers"]
    for name in ("pos_bias_u", "pos_bias_v"):
        shape = layers["self_attn"][name].shape
        layers["self_attn"][name] = rng.standard_normal(shape, dtype=np.float32)
    bn = layers["conv_module"]["batch_norm"]
    bn["scale"] = 1.0 + np.float32(0.3) * rng.standard_normal(bn["scale"].shape,
                                                               dtype=np.float32)
    bn["shift"] = np.float32(0.3) * rng.standard_normal(bn["shift"].shape, dtype=np.float32)
    return tree


def first_layers(tree, n):
    """The tree with its stacked encoder layers cut to the first `n`."""
    def cut(node):
        return {k: cut(v) for k, v in node.items()} if isinstance(node, dict) else node[:n]

    return {**tree, "encoder": {**tree["encoder"], "layers": cut(tree["encoder"]["layers"])}}


def run_conformer(device, vocab, card):
    """wav2vec2-conformer-rel-pos-large at full width and depth through
    the batch entry (bf16, gates of bench.py; counted: K5 once per layer in
    each of the bf16 and f32 forwards, K1), then the f32 forward through K5
    against the f32 factorized forward (<= 1e-3 relative on the logits),
    the forward with and without K5, the frontend alone, the forward's
    device time by kernel group, the batch path's realtime factor and
    peak memory, and K5 at the slice's shape. Returns (path counts, K5
    times, the bf16 device params)."""
    import dataclasses

    import torch

    from wav2vec2_tpu_torch.config import Wav2Vec2ModelConfig
    from wav2vec2_tpu_torch.models.ctc_model import wav2vec2_forward
    from wav2vec2_tpu_torch.models.feature_extractor import (
        feature_extractor_forward,
        feature_projection_forward,
    )
    from wav2vec2_tpu_torch.models.params import params_from_jax
    from wav2vec2_tpu_torch.parallel.batching import _normalize_batch

    cfg = Wav2Vec2ModelConfig.from_dict(CONFORMER_CONFIG)
    params_np = conformer_params(cfg, seed=10)
    params = params_from_jax(params_np, device=device)
    reset_launches()
    aligner, inputs = run_batch_entry(device, cfg, params, vocab, batch=32, seconds=10.0,
                                      n_check=16, label="conformer rel-pos large")
    counts = read_launches()
    if counts["k5"] != 2 * cfg.num_hidden_layers or counts["k1"] < 1:
        raise AssertionError(f"the conformer batch entry launched {counts}: want K5 "
                             f"{cfg.num_hidden_layers} per forward in 2 forwards, K1 >= 1")

    with torch.inference_mode():
        audio = _normalize_batch(inputs[0], inputs[1])

        def forward(p, flash, dtype):
            c = dataclasses.replace(cfg, use_flash_attention=flash)
            return wav2vec2_forward(p, audio, c, audio_lens=inputs[1], compute_dtype=dtype)

        on, off = forward(params, True, torch.float32), forward(params, False, torch.float32)
        flag_err = float((on - off).abs().max()) / float(off.abs().max())
        if not (torch.isfinite(on).all() and flag_err <= 1e-3):
            raise AssertionError(f"conformer f32 forward through K5 vs factorized: relative "
                                 f"error {flag_err} (bound 1e-3)")
        del on, off, params
        print(f"conformer f32 forward through K5 vs the factorized forward: relative max "
              f"error {flag_err:.2e} on the logits (bound 1e-3), 32 x 10 s")
        fwd = {}
        for flash in (False, True, True, False):
            forward(aligner.params, flash, torch.bfloat16)
            fwd.setdefault(flash, []).append(
                cuda_time_ms(lambda: forward(aligner.params, flash, torch.bfloat16), 3))
        p, lens = aligner.params, inputs[1]
        frontend = lambda: feature_projection_forward(  # noqa: E731
            p["feature_projection"], feature_extractor_forward(
                p["feature_extractor"], audio.to(torch.bfloat16), cfg,
                audio_lens=lens).transpose(1, 2), cfg)
        frontend()
        front_ms = cuda_time_ms(frontend, 3)
        groups, busy_ms, top = kernel_time_split(lambda: forward(p, True, torch.bfloat16))
    fwd_ms = statistics.median(fwd[True])
    print(f"time: conformer rel-pos large forward {fwd_ms:.3f} ms through K5, "
          f"{statistics.median(fwd[False]):.3f} ms factorized, 32 x 10 s bf16 (CUDA events, "
          f"medians; factorized, K5, K5, factorized); of it the frontend (7 convs with "
          f"LayerNorm and GELU, projection) {front_ms:.3f} ms {card}")
    split = ("not measured (torch.profiler saw no CUDA kernel)" if not busy_ms else
             f"device busy {busy_ms:.3f} ms; "
             + ", ".join(f"{g} {ms:.3f} ms" for g, ms in groups.items())
             + "; longest: " + "; ".join(f"{name[:60]} {ms:.3f} ms" for name, ms in top))
    print(f"time: conformer forward through K5 by kernel (torch.profiler, one forward): "
          f"{split} {card}")
    rtf, total_s, peak_gb, wait_ms, group_ms = time_batch_path(aligner, vocab, 32, repeats=3)
    print(f"time: conformer batch path {rtf:.1f}x realtime (3 batches of 32 x 10 s, bf16, K5, "
          f"submit/drain double-buffered, {total_s / 3 * 1e3:.1f} ms per batch; host waited "
          f"{wait_ms:.1f} ms, grouped {group_ms:.1f} ms; peak device memory {peak_gb:.2f} GB) "
          f"{card}")
    self_attn = {k: (v[0] if isinstance(v, torch.Tensor) else {n: w[0] for n, w in v.items()})
                 for k, v in aligner.params["encoder"]["layers"]["self_attn"].items()}
    nh = cfg.num_attention_heads
    k5 = time_flash(device, card, self_attn, 32, nh, cfg.conv_output_length(inputs[0].shape[1]),
                    cfg.hidden_size // nh)
    return counts, k5, params_np


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs only on a GPU",
              file=sys.stderr)
        return 2
    # every host grouping of the smoke runs the native engine, or fails
    os.environ["WAV2VEC2_NATIVE_GROUPING"] = "require"
    from wav2vec2_tpu_torch.align import grouping
    from wav2vec2_tpu_torch.config import Wav2Vec2ModelConfig
    from wav2vec2_tpu_torch.models.params import init_params, params_from_jax
    from wav2vec2_tpu_torch.ops import cuda_build, viterbi_cuda, viterbi_ref
    from wav2vec2_tpu_torch.ops import flash_attention as fa
    from wav2vec2_tpu_torch.utils import native_build

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    card = f"[{smi}]"
    print(smi)
    print(f"device: {name}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")

    info = cuda_build.build(force=True)
    ptxas = " | ".join(l.strip() for l in info["compiler_output"].splitlines()
                       if "registers" in l or "smem" in l or "spill" in l)
    print(f"build: {', '.join(s.name for s in cuda_build.SOURCES)} -> {info['library']} in "
          f"{info['seconds']:.3f} s (nvcc {' '.join(cuda_build.NVCC_FLAGS)}); ptxas: {ptxas}")
    for lib in native_build.SOURCES:
        t0 = time.perf_counter()
        path = native_build.build(lib, force=True)
        print(f"build: {native_build.SOURCES[lib].name} -> {path} in "
              f"{time.perf_counter() - t0:.3f} s (g++ {' '.join(native_build.CXX_FLAGS)})")

    for shape in ((499, 256, 32), (3047, 128, 32), (37, 61, 397), (HOUR_FRAMES, 12_672, 392),
                  (2400, 4100, 32), (512, 4096, 32), (1000, 16_388, 32), (5000, 3700, 8000),
                  (1499, 768, 32), (601, 61, 29), (499, 256, 392), (2400, 256, 32), (64, 128, 8)):
        for tier in viterbi_cuda.TIERS:
            if viterbi_cuda.library_smem_bytes(tier, *shape) != viterbi_cuda.smem_bytes(tier, *shape):
                raise AssertionError(f"{tier} at {shape}: the wrapper's shared-memory size "
                                     "differs from the kernel's")
        if viterbi_cuda.library_k1_mode(*shape) != viterbi_cuda.k1_mode(*shape):
            raise AssertionError(f"k1 at {shape}: the wrapper's mode differs from the kernel's")
    for hd in (16, 32, 64, 80, 128):
        for dtype in (torch.float32, torch.bfloat16):
            for rel in (False, True):
                if fa.library_smem_bytes(hd, dtype, rel) != fa.smem_bytes(hd, dtype, rel):
                    raise AssertionError(f"k5 at hd={hd} {dtype} rel={rel}: the wrapper's "
                                         "shared-memory size differs from the kernel's")

    # --- every kernel against its plain version ---------------------------
    rng = np.random.default_rng(0)
    cases = kernel_cases(rng)
    k1_modes = {}
    max_err = {"k1": check_kernel(device, cases, "k1", k1_modes)}
    if k1_modes[cases[0][0]] != "resident" or k1_modes[cases[-1][0]] != "device":
        raise AssertionError(f"K1 ran the serving case and the large case in {k1_modes}")
    for tier, tier_cases in blocked_cases(np.random.default_rng(8)).items():
        max_err[tier] = check_kernel(device, tier_cases, tier)
    max_err["k5"] = check_flash(device, flash_cases())
    hour_rows = hour_scale(device, card)
    tier_crossover(device, card, hour_rows)

    cfg = Wav2Vec2ModelConfig.from_dict(BASE_CONFIG)
    vocab = make_vocab()
    params_np = init_params(cfg, seed=0)
    params = params_from_jax(params_np, device=device)

    # --- the paths, each counted from 0 -----------------------------------
    launches = {name: 0 for name in (*viterbi_cuda.TIERS, "k5", "k1_resident", "k1_device")}

    def add(counts, phase, want):
        for tier, n in counts.items():
            launches[tier] += n
        if counts[want] < 1:
            raise AssertionError(f"{phase} never launched {want}: {counts}")

    reset_launches()
    aligner, inputs = run_batch_entry(device, cfg, params, vocab,
                                      batch=32, seconds=10.0, n_check=16)
    counts = read_launches()
    add(counts, "the batch entry", "k1_resident")
    if counts["k1_device"]:
        raise AssertionError(f"the serving batch ran K1 in its device mode: {counts}")

    reset_launches()
    k2_inputs = run_long_bucket(aligner, cfg, vocab)
    add(read_launches(), "the batch entry's long bucket", "k2")

    with tempfile.TemporaryDirectory() as tmp:
        write_model_dir(Path(tmp), BASE_CONFIG, params_np, cfg, vocab)
        reset_launches()
        single = run_single_entry(device, Path(tmp), durations=(4.0, 8.0, 12.0), n_words=14)
        counts = read_launches()
    add(counts, "the single-utterance entry", "k1")
    if sum(counts[name] for name in (*viterbi_cuda.TIERS, "k5")) != len(single):
        raise AssertionError(f"the single-utterance entry launched {counts} for "
                             f"{len(single)} requests")

    counts, k4_run = run_longform(device, cfg, params, vocab, minutes=10.0, card=card)
    add(counts, "the long-form entry", "k4")
    max_err["k4"] = max(max_err["k4"], k4_run["err"])

    cfg_ph = Wav2Vec2ModelConfig.from_dict({**BASE_CONFIG, "vocab_size": PHONEME_VOCAB})
    head = np.random.default_rng(9).standard_normal((768, PHONEME_VOCAB), dtype=np.float32)
    phoneme_head = {"kernel": head * np.float32((2.0 / (768 + PHONEME_VOCAB)) ** 0.5),
                    "bias": np.zeros(PHONEME_VOCAB, np.float32)}
    params_ph = params_from_jax({**params_np, "lm_head": phoneme_head}, device=device)
    counts, k3_run = run_longform_phoneme(device, cfg_ph, params_ph, vocab, minutes=3.0,
                                          card=card)
    add(counts, "the phoneme-vocab long-form entry", "k3")
    max_err["k3"] = max(max_err["k3"], k3_run["err"])
    del params_ph

    if grouping.NATIVE_GROUPING != "require" or not grouping.engine_calls["native"] \
            or grouping.engine_calls["python"]:
        raise AssertionError(f"host grouping so far: {grouping.engine_calls}, "
                             f"NATIVE_GROUPING={grouping.NATIVE_GROUPING}")
    counts = run_cli(device, card, params_np, cfg, vocab, phoneme_head)
    add(counts, "the CLI", "k1")
    if counts["k2"] < 1:
        raise AssertionError(f"the CLI never launched k2: {counts}")

    # --- times, each beside the card's name and power limit --------------
    kernels = {}
    _, lp, tok, t_lens, s_lens = cases[0]
    args = [torch.from_numpy(a).to(device) for a in (lp, tok, t_lens, s_lens)]
    k_ms, p_ms = interleaved_ms(lambda: viterbi_cuda.viterbi_batch(*args, tier="k1"),
                                lambda: viterbi_ref.viterbi_batch(*args), 50, 5)
    time_k1(device, card, cases, k_ms, p_ms)
    kernels["k1"] = dict(ms=k_ms, plain_ms=p_ms,
                         shape=(128, 499, 32, S_PAD, t_lens, s_lens))

    lp2, tok2, tl2, sl2 = k2_inputs
    emit2 = viterbi_ref.gather_emissions(lp2, tok2)
    k_ms, p_ms = interleaved_ms(
        lambda: viterbi_cuda.viterbi_emissions_batch(emit2, tok2, tl2, sl2, tier="k2"),
        lambda: viterbi_ref.viterbi_emissions_batch(emit2, tok2, tl2, sl2), 10, 1)
    b2, t2, s2 = emit2.shape
    print(f"time: K2 kernel {k_ms:.4f} ms vs plain PyTorch {p_ms:.1f} ms at the long bucket "
          f"B={b2} T={t2} S_pad={s2} (device time, medians; plain, kernel, kernel, plain) {card}")
    ms = turns_ms({tier: (lambda tier=tier: viterbi_cuda.viterbi_batch(lp2, tok2, tl2, sl2,
                                                                      tier=tier))
                   for tier in ("k2", "k4")}, 10)
    with_gather, k4_ms = ms["k2"], ms["k4"]
    print(f"time: at the same bucket, gather + K2 {with_gather:.4f} ms vs K4 {k4_ms:.4f} ms "
          f"(device time, medians) {card}")
    kernels["k2"] = dict(ms=k_ms, plain_ms=p_ms, shape=(b2, t2, lp2.shape[2], s2,
                                                        tl2.cpu().numpy(), sl2.cpu().numpy()))
    kernels["k3"], kernels["k4"] = k3_run, k4_run

    from wav2vec2_tpu_torch.models.ctc_model import wav2vec2_forward
    from wav2vec2_tpu_torch.parallel.batching import _normalize_batch

    with torch.inference_mode():
        audio = _normalize_batch(inputs[0], inputs[1])
        fwd = lambda: wav2vec2_forward(aligner.params, audio, cfg,  # noqa: E731
                                       audio_lens=inputs[1], compute_dtype=torch.bfloat16)
        fwd()
        fwd_ms = cuda_time_ms(fwd, 5)
    print(f"time: wav2vec2-base forward {fwd_ms:.3f} ms for 32 x 10 s at bf16 "
          f"(CUDA events, median of 5) {card}")

    for batch in (32, 128):
        rtf, total_s, peak_gb, wait_ms, group_ms = time_batch_path(aligner, vocab, batch,
                                                                   repeats=5)
        print(f"time: batch path {rtf:.1f}x realtime (5 batches of {batch} x 10 s, bf16, "
              f"submit/drain double-buffered, {total_s:.3f} s wall = {total_s / 5 * 1e3:.1f} ms "
              f"per batch; per batch the host waited {wait_ms:.1f} ms for the copies and "
              f"grouped for {group_ms:.1f} ms; peak device memory {peak_gb:.2f} GB) {card}")
    # --- the conformer rel-pos family: K5 on its path --------------------
    del aligner, params, inputs
    counts, k5_run, conformer_np = run_conformer(device, vocab, card)
    add(counts, "the conformer batch entry", "k5")
    max_err["k5"] = max(max_err["k5"], k5_run["err"])
    # the single-utterance entry builds its forward with the kernel switch
    # off (factorized attention), as in the JAX package; 4 blocks at full
    # width keep the model directory small
    cfg4_dict = {**CONFORMER_CONFIG, "num_hidden_layers": 4}
    cfg4 = Wav2Vec2ModelConfig.from_dict(cfg4_dict)
    with tempfile.TemporaryDirectory() as tmp:
        write_model_dir(Path(tmp), cfg4_dict, first_layers(conformer_np, 4), cfg4, vocab)
        del conformer_np
        reset_launches()
        run_single_entry(device, Path(tmp), durations=(8.0,), n_words=14)
        counts = read_launches()
    if counts["k5"]:
        raise AssertionError(f"the conformer single-utterance entry launched K5: {counts}")
    add(counts, "the conformer single-utterance entry", "k1")
    print(f"conformer single entry: a 4-block model directory written through "
          f"params_to_hf_flat_dict (BatchNorm folded back by the loader) aligned every word; "
          f"launches {counts}")
    print(f"launch counts on the paths: {launches}")
    print(f"total smoke time {time.perf_counter() - t_start:.1f} s {card}")

    replaces = {"k1": 59, "k2": 366, "k3": 367, "k4": 368}
    sources = {"k1": "viterbi.cu", "k2": "viterbi_blocked.cu", "k3": "viterbi_blocked.cu",
               "k4": "viterbi_blocked.cu"}
    line = []
    for tier in viterbi_cuda.TIERS:
        k = kernels[tier]
        bound_ms, bound_by = dp_bound(tier, *k["shape"][:4], *k["shape"][4:])
        line.append({
            "name": f"viterbi_{tier}",
            "route": "cuda",
            "source": f"wav2vec2_tpu_torch/csrc/{sources[tier]}",
            "replaces": f"wav2vec2_tpu/ops/viterbi_pallas.py:{replaces[tier]}",
            "launches": launches[tier],
            "max_abs_err": max_err[tier],
            "ms": k["ms"],
            "plain_ms": k["plain_ms"],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,  # no single PyTorch call computes a banded Viterbi path
        })
    line.append({
        "name": "flash_attention_k5",
        "route": "cuda",
        "source": "wav2vec2_tpu_torch/csrc/flash_attention.cu",
        "replaces": "wav2vec2_tpu/ops/flash_attention.py:124",
        "launches": launches["k5"],
        "max_abs_err": max_err["k5"],
        "ms": k5_run["ms"],
        "plain_ms": k5_run["plain_ms"],
        "bound_ms": k5_run["bound_ms"],
        "bound_by": k5_run["bound_by"],
        "library_ms": k5_run["library_ms"],
    })
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
