"""Smoke test of the PyTorch/CUDA port (`wav2vec2_tpu_torch`) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds the CUDA kernels from `wav2vec2_tpu_torch/csrc/` with one
`nvcc` call (the Viterbi kernel K1 in its two modes, its blocked tiers K2,
K3, K4, and the fused rel-pos attention kernel K5 in its two kernels),
reads K5's SASS (`cuobjdump -sass`: each instantiation of the bf16 kernel
must hold wgmma (HGMMA) and TMA loads (UTMALDG) and none mma.sync (HMMA);
each of the f32 kernel TMA loads and FFMA, and no tensor-core (HGMMA,
HMMA) or TF32 instruction), holds each kernel against its plain PyTorch
version (the Viterbi kernels also against the numpy oracle, K4 against K1
at hour scale; the f32 K5 also at head dims off its widths; K4 past 16 384
states on a thread-block cluster: (w1) against its plain version at S_pad
20 480 and 40 064 (clusters of 2 and 3, ties, an all -inf row, tokens
repeating across the slice boundaries) and forced onto clusters of 2-8
blocks on the blocked cases, (w2) at hour scale and the rate of real
speech (S 99 000 at V = 32, 86 400 at V = 392) the least cluster against
one block more and 8, the paths valid), times K5 at
the shapes the main paths give it (bf16 at the (m2) mesh's local tiles;
f32 at the conformer's, the forced plain forwards' at head dims 64 and
80, the online window, long-form's 30 s chunk and the mesh tiles, each
beside its plain version, SDPA on the same f32 inputs and its bound), and
drives the port's paths through the entry points a user calls, with
random weights from a numpy seed:

- wav2vec2-base at full width: `BatchAligner.submit_padded_batch` on
  32 × 10 s with the gates of `bench.py` (K1), and on a long bucket that
  selects K2; `ForcedAlignerBuilder` on 3 requests (K1); `align_longform`
  on 10 min of audio with a 1 200-word transcript (K4 on one block), with
  gates (a)–(d), (w3) on 20 min with 2 400 words (23 999 states: K4 on a
  cluster of 2, also timed on 3 and 8), with the same gates, and on 3 min
  with a phoneme-size vocabulary and a short transcript (K3);
- wav2vec2-conformer-rel-pos-large at full width and depth:
  `BatchAligner.submit_padded_batch` on 32 × 10 s with the gates of
  `bench.py` (K5 once per layer and forward, K1), the f32 forward through
  K5 against the f32 factorized forward, timed with K5's share of it,
  and `ForcedAlignerBuilder` on a 4-block model directory (no K5, as in
  the JAX package);
- the `alignment_report` CLI in process at the full width and depth of
  wav2vec2-base, on a LibriSpeech-layout dataset of 64 FLAC utterances
  written by the port's encoder (2–32 s, so every bucket of its 1 s pow2
  grid up to 32 s fills): textgrid at bf16 and f32 (`align_stream`: K1 at
  the short buckets, K2 and K4 at the long ones), `--no-batch`, json,
  perf, srt, and `--units phoneme` with a 392-wide head (K1 resident),
  with gates on the stream's order and words, native vs Python grouping
  on every drained batch, batch vs single, the perf run's device memory,
  and each tier it launched against its plain version;
- the families: 12 wav2vec2-encoder presets (pre-norm lv60 and XLS-R-53,
  MMS-1b with attention adapters, HuBERT base and large, data2vec-audio,
  WavLM base-plus and large, mHuBERT-147, the conv adapter's 160 ms
  frames, UniSpeech-SAT, UniSpeech with phoneme units), SEW and SEW-D
  (squeezed encoder, DeBERTa attention), the rotary conformer and w2v-BERT
  2.0 (log-mel frontend, relative_key conformer, BERT adapter, 40 ms
  frames), each at full width and depth through the batch entry at bf16
  and f32 with gates (a) K1 == viterbi_numpy, (b) padded == unpadded f32
  within 1e-4, (c) bf16 vs f32; lv60, w2v-BERT and mms-1b timed at 32 ×
  10 s; K5 forced (`WAV2VEC2_FLASH_FORCE=1`) on plain attention at head
  dims 64 and 80 (SEW's at its pooled length, w2v-BERT's adapter) and on
  rotary attention, timed against SDPA; one 2-layer HF-format directory
  per family (its own weight prefix) through `ForcedAlignerBuilder`, and
  the CLI on the hubert-large directory;
- the serving slice, at the full width and depth of wav2vec2-base with
  random weights: the daemon (`serve.build_service_from_model_dir` on a
  model directory written by the port's writer, bf16, `warmup_aligner` at
  4 and 8 s, an `AlignHTTPServer` on 127.0.0.1:0): 16 client threads send
  96 /align requests (2-12 s, 2 words a second, pcm16 and float lists,
  some as srt/vtt) while 4 /stream sessions push 60 s each in 0.32 s
  pieces, with gates (s1) all 200 with their words in order, monotone and
  inside the audio, (s2) /stats counts 96 aligned with batches larger than
  1, (s3) 16 requests sent together to an f32 service within one frame of
  the same utterance aligned alone and >= 99% exact, (s4) in a burst only the request whose
  transcript cannot fit gets 400, (s5) K1 launched resident, and each
  stream's flush equal to the same stream run alone (words, boundaries
  within one frame); then `--quantize-int8` on 8 requests; `OnlineAligner`
  on 60 s with 120 words at bf16 and f32 with gates (o1) the emitted words
  a prefix of the flush, (o2) 0.1 s and 1.7 s pieces give the same flush,
  (o3) f32 with normalize="none" gives `align_longform`'s words, (o4) each
  window's f32 log-probs within 1e-4 of the batch forward; int8 serving
  (`BatchAligner(quantize_int8=True)`) against bf16 on 32 x 10 s with
  gates (i1) `linear_int8` at [B·T, 768] x [768, 3072] and back: int32
  accumulators equal to an f64 product, the output bit-equal to the CPU's,
  (i2) the JAX package's bound on the log-probs and equal words, (i3) no
  K5; `python -m wav2vec2_tpu_torch.doctor` on the daemon's directory
  (exit 0, the card named, the kernel library ok); and the conformer
  rel-pos large online (30 s bf16, (o1), K5 24 times a window at B=1,
  T_pad 256), with K5 timed at that shape (the `kernels` line's
  `flash_attention_k5_online` row).

- the ONNX runtime, wav2vec2-base at full width and depth, f32:
  the port's exporter (twice, the same bytes), `OnnxRuntimeBackend(device=
  "cuda")` (the embedded session: the graph as torch operations on the
  card) through `ForcedAlignerBuilder` on 8 requests of 4-12 s beside the
  torch backend on the same directory, with gates (x1) session logits
  within 1e-4 of the port's f32 forward, (x2) equal words and ms, (x3) K1
  up to 512 frames and K2 on the 12 s request, no K5, (x4) the provider
  names CUDA, (x5) the CLI with `--runtime onnx` on 3 FLAC files;
- CTC training: (t1) wav2vec2-base, 32 x 10 s, bf16 compute over
  f32 weights, AdamW, 10 steps on one batch (step, forward and backward
  times, training audio-seconds per second, peak memory; the losses finite
  and falling); (t2) the JAX package's tone task
  (`tests/test_train_align_e2e.py`), 120 f32 steps, then `BatchAligner`
  recovers every word (its T_pad of 1 199 frames takes K2: K1 stops at
  512); (t3) one f32 step of a 2-layer base on the card against the host
  CPU, gradients within 1e-4, no K5 even forced; (t4) `save_params` /
  `restore_params` bit-exact, the restored tree aligning the same words.

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
last is the `kernels` JSON object (K5's bf16 and f32 kernels in rows of
their own, with their launches on the paths; K4 on a cluster in a row of
its own at (w3)'s shape, and K4's row lists every cluster size it ran
with); the last line of standard output is one JSON object naming the
device.
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


def check_kernel(device, cases, tier="k1", modes=None, cluster=0, oracle=True):
    """Kernel `tier` (forced; K4 on `cluster` blocks, 0: its rule) vs its
    plain PyTorch version (all rows, all frames) and, with `oracle`, vs the
    numpy oracle (a few rows), bit-identical. For K1, the mode each case
    ran in (from `k1_launches`) goes into `modes` (case name -> mode) where
    given. Returns the max abs path difference (0)."""
    import torch

    from wav2vec2_tpu_torch.ops import viterbi_cuda, viterbi_ref

    worst = 0
    for name, lp, tok, t_lens, s_lens in cases:
        args = [torch.from_numpy(a).to(device) for a in (lp, tok, t_lens, s_lens)]
        before = dict(viterbi_cuda.k1_launches)
        got = viterbi_cuda.viterbi_batch(*args, tier=tier, cluster=cluster).cpu().numpy()
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
        if not oracle:
            continue
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


K4_CLUSTERS_RUN: set[int] = set()  # every cluster size K4 launched with in this process


def reset_launches():
    from wav2vec2_tpu_torch.ops import flash_attention, viterbi_cuda

    K4_CLUSTERS_RUN.update(n for n, c in viterbi_cuda.k4_clusters.items() if c)
    for counts in (viterbi_cuda.launches, viterbi_cuda.k1_launches, flash_attention.launches,
                   flash_attention.kernel_launches, viterbi_cuda.k4_clusters):
        for name in counts:
            counts[name] = 0


def read_launches():
    """Launches per kernel since `reset_launches`, K1's per mode
    ("k1_resident", "k1_device"), K4's per cluster size ("k4_cluster_n")
    and K5's per kernel ("k5_wgmma": bf16, "k5_fma": f32)."""
    import torch

    from wav2vec2_tpu_torch.ops import flash_attention, viterbi_cuda

    torch.cuda.synchronize()
    K4_CLUSTERS_RUN.update(n for n, c in viterbi_cuda.k4_clusters.items() if c)
    return {**viterbi_cuda.launches, **flash_attention.launches,
            **{f"k1_{mode}": n for mode, n in viterbi_cuda.k1_launches.items()},
            **{f"k4_cluster_{n}": c for n, c in viterbi_cuda.k4_clusters.items()},
            **{f"k5_{kernel}": n for kernel, n in flash_attention.kernel_launches.items()}}


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
    exact; (d) every word in order, boundaries monotone. Past 16 384
    states (20 min: (w3)) K4 runs on a cluster, and the DP is also timed
    on one block more and on 8 blocks (`cluster=`), each path equal."""
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
    n, r, threads, slices = viterbi_cuda.library_cluster(tokens.shape[0])
    print(f"{tier} at the {minutes:g} min shape: a cluster of {n} ({r}-state strips on "
          f"{threads} threads a block, slices {slices}); backpointer scratch {bp_bytes} B per "
          f"launch (2 bits a cell, [1, {t_len}, {bp_bytes // t_len}] uint8)")
    cluster_ms = {}
    if n > 1:
        fns = {c: (lambda c=c: viterbi_cuda.viterbi_batch(*args, cluster=c))
               for c in sorted({n, n + 1, viterbi_cuda.MAX_CLUSTER})}
        for c, fn in fns.items():
            if not torch.equal(fn()[0].cpu(), torch.from_numpy(path)):
                raise AssertionError(f"the {minutes:g} min DP on a cluster of {c} differs "
                                     f"from the path on {n}")
        cluster_ms = turns_ms(fns, 3)
        print(f"time: the {minutes:g} min DP on clusters of "
              + ", ".join(f"{c} blocks {t_ms:.3f} ms" for c, t_ms in cluster_ms.items())
              + f", each path == the path on {n} (device time, medians; in turns) {card}")
    print(f"time: long-form {minutes:g} min {minutes * 60 / wall:.1f}x realtime "
          f"({wall:.3f} s wall, first call), forward {fwd_ms:.3f} ms, DP ({tier}, a cluster "
          f"of {n}) {k_ms:.3f} ms (device time, median of 5), plain DP {p_ms:.1f} ms, peak "
          f"device memory {peak_gb:.2f} GB, launches k4 {counts['k4']} {card}")
    return counts, dict(tier=tier, ms=k_ms, plain_ms=p_ms, err=err, cluster=n,
                        cluster_ms=cluster_ms, wall_s=wall, fwd_ms=fwd_ms, peak_gb=peak_gb,
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


def cli_cases(rng):
    """The CLI phase's utterances, [(seconds, transcript)]: 64 word cases
    that fill the 2, 4, 8, 16 and 32 s buckets at about 2.5 words a second,
    and 8 phoneme cases of 2-7.5 s."""
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
    return cases, ph_cases


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
    cases, ph_cases = cli_cases(rng)
    ph_vocab = phoneme_vocab()
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


def repeat_across_slices(tok, s_pad):
    """Make the tokens repeat across each slice boundary a of K4's cluster
    at `s_pad` (tok[a] == tok[a-2], tok[a+1] == tok[a-1]): the s-2 step is
    forbidden on both sides of every handoff."""
    from wav2vec2_tpu_torch.ops import viterbi_cuda

    for a, _ in viterbi_cuda.cluster_slices(s_pad)[1:]:
        tok[..., a] = tok[..., a - 2]
        tok[..., a + 1] = tok[..., a - 1]
    return tok


def cluster_cases(rng):
    """(w1)'s cases past one block's 16 384 states, tokens repeating across
    every slice boundary: a ragged batch of 3 at T_pad 12 000, S_pad 20 480
    (a cluster of 2: a row of ties, log-probs rounded to 0.5; an all -inf
    row; a row whose s_len stops past the boundary) and one row at T_pad
    20 000, S_pad 40 064 (a cluster of 3)."""
    b, t, s_pad = 3, 12_000, 20_480
    lp = random_log_probs(rng, b, t, 32)
    lp[0] = np.round(lp[0] * 2) / 2
    lp[1] = -np.inf
    tok = repeat_across_slices(rng.integers(0, 32, size=(b, s_pad)).astype(np.int32), s_pad)
    ragged = ("ragged B=3 T_pad=12000 S_pad=20480 V=32 (ties, all -inf, s_len 16 500)", lp, tok,
              np.array([12_000, 11_000, 10_500], np.int32),
              np.array([20_480, 19_000, 16_500], np.int32))
    t, s_pad = 20_000, 40_064
    one = ("one row T_pad=20000 S_pad=40064 V=32", random_log_probs(rng, 1, t, 32),
           repeat_across_slices(rng.integers(0, 32, size=(1, s_pad)).astype(np.int32), s_pad),
           np.array([t], np.int32), np.array([40_000], np.int32))
    return [ragged, one]


def check_cluster_w1(device, card):
    """(w1) K4 on a cluster against its plain version on the card, bit for
    bit: `cluster_cases` at the rule's cluster, each timed beside its
    bound and the plain version; then every cluster of 2–8 blocks that
    `cluster_shape` admits forced on the blocked K4 cases of
    `blocked_cases` (edge cases, odd widths, partial last strips). Returns
    (max abs path difference, rows for the report)."""
    import torch

    from wav2vec2_tpu_torch.ops import viterbi_cuda, viterbi_ref

    worst, rows = 0, []
    for name, lp, tok, t_lens, s_lens in cluster_cases(np.random.default_rng(16)):
        b, t, v = lp.shape
        s_pad = tok.shape[1]
        args = [torch.from_numpy(a).to(device) for a in (lp, tok, t_lens, s_lens)]
        kernel = lambda: viterbi_cuda.viterbi_batch(*args, tier="k4")  # noqa: E731
        plain = lambda: viterbi_ref.viterbi_batch(*args)  # noqa: E731
        got, want = kernel(), plain()
        err = int((got.long() - want.long()).abs().max())
        worst = max(worst, err)
        if err:
            bad = tuple(int(i) for i in (got != want).nonzero()[0])
            raise AssertionError(f"(w1) {name}: K4's path differs from the plain version "
                                 f"at (row, frame) {bad}")
        k_ms, p_ms = interleaved_ms(kernel, plain, 3, 1)
        bound_ms, bound_by = dp_bound("k4", b, t, v, s_pad, t_lens, s_lens)
        n, r, threads = viterbi_cuda.cluster_shape(s_pad)
        rows.append(dict(name=name, n=n, ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms,
                         bound_by=bound_by, shape=(b, t, v, s_pad, t_lens, s_lens)))
        print(f"(w1) {name}: K4 on a cluster of {n} ({r}-state strips, {threads} threads a "
              f"block, slices {viterbi_cuda.cluster_slices(s_pad)}) == plain version, every "
              f"row and frame; K4 {k_ms:.3f} ms, bound {bound_ms:.4f} ms by {bound_by}, plain "
              f"{p_ms:.1f} ms (device time, medians; plain, kernel, kernel, plain) {card}")
        del args, got, want
    forced = 0
    for case in blocked_cases(np.random.default_rng(8))["k4"]:
        for n in range(2, viterbi_cuda.MAX_CLUSTER + 1):
            if viterbi_cuda.cluster_shape(case[2].shape[1], n)[0]:
                worst = max(worst, check_kernel(device, [case], "k4", cluster=n, oracle=False))
                forced += 1
    print(f"(w1) K4 forced onto clusters of 2-8 blocks: {forced} launches on the blocked K4 "
          f"cases, each path == the plain version's")
    return worst, rows


def path_is_valid(path, tok, t_len, s_len):
    """The path starts in state 0 or 1, ends in s_len-2 or s_len-1, moves by
    0, 1 or 2 a frame, and takes 2 only where tokens[s] != tokens[s-2]."""
    path = path[:t_len].astype(np.int64)
    step = np.diff(path)
    two = path[1:][step == 2]
    return bool(path[0] in (0, 1) and path[-1] in (s_len - 2, s_len - 1)
                and ((step >= 0) & (step <= 2)).all() and (tok[two] != tok[two - 2]).all())


def cluster_hour_w2(device, card):
    """(w2) Hour scale at the rate of real speech, T = 180 000: V = 32 at
    S = 99 000 (150 words a minute, 5.5 tokens a word) and V = 392 at
    S = 86 400 (12 phones a second), random log-probs. The plain version
    would take minutes, so the path of the least cluster (7, 6) is held to
    the paths of one block more and of 8 blocks (`cluster=`), bit for bit,
    and checked valid (`path_is_valid`); the three timed in turns."""
    import torch

    from wav2vec2_tpu_torch.ops import viterbi_cuda

    rng = np.random.default_rng(17)
    rows = []
    for v, s_len in ((32, 99_000), (PHONEME_VOCAB, 86_400)):
        s_pad = -(-s_len // 128) * 128
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device=device).manual_seed(v + 1)
        lp = torch.log_softmax(
            torch.randn((1, HOUR_FRAMES, v), generator=gen, device=device) * 3.0, dim=-1)
        tok_np = rng.integers(0, v, size=(1, s_pad)).astype(np.int32)
        tok = torch.from_numpy(tok_np).to(device)
        lens = [torch.tensor([x], dtype=torch.int32, device=device) for x in (HOUR_FRAMES, s_len)]
        least = viterbi_cuda.cluster_size(s_pad)
        sizes = sorted({least, least + 1, viterbi_cuda.MAX_CLUSTER})
        fns = {n: (lambda n=n: viterbi_cuda.viterbi_batch(lp, tok, *lens, tier="k4", cluster=n))
               for n in sizes}
        want = fns[least]()
        for n in sizes[1:]:
            if not torch.equal(fns[n](), want):
                raise AssertionError(f"(w2) V={v}: the path on a cluster of {n} differs from "
                                     f"the path on {least}")
        path = want[0].cpu().numpy()
        if not path_is_valid(path, tok_np[0], HOUR_FRAMES, s_len):
            raise AssertionError(f"(w2) V={v}: the path is not a valid alignment")
        ms = turns_ms(fns, 1)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        bp_bytes = int(np.prod(viterbi_cuda.bp_scratch_shape("k4", 1, HOUR_FRAMES, s_pad, v)))
        bound_ms, bound_by = dp_bound("k4", 1, HOUR_FRAMES, v, s_pad, [HOUR_FRAMES], [s_len])
        print(f"(w2) hour scale T={HOUR_FRAMES} V={v} S={s_len} S_pad={s_pad}: paths on clusters "
              f"of {sizes} equal bit for bit and valid; K4 "
              + ", ".join(f"{n} blocks {t_ms:.2f} ms" for n, t_ms in ms.items())
              + f"; bound {bound_ms:.3f} ms by {bound_by}; backpointer scratch {bp_bytes} B; "
              f"peak device memory {peak_gb:.2f} GB (device time, medians; in turns) {card}")
        rows.append(dict(v=v, s_pad=s_pad, ms=ms, bound_ms=bound_ms, bp_bytes=bp_bytes))
        del lp, want, fns
    return rows


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
    version: both dtypes (bf16 through the wgmma kernel, f32 through the
    exact FMA kernel fed by TMA), rel on and off, masked and unmasked, at odd T (37 and 255
    pad to 256, 257 and 499 to 512, 1 499 — the 30 s chunk — to 1 536) and
    head dims 16, 32, 64, 128 and 80 (column chunks: 64 + 16 in the wgmma
    kernel, 32 + 32 + 16 in the f32 one); bf16 at T = 1 499 with hd 64 and 128; then the slice's
    shape with B cut to 4 (bf16) and 2 (f32)."""
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
    largest absolute difference by dtype."""
    import torch

    from wav2vec2_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(12)
    worst, lines = {}, []
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
        worst[dtype] = max(worst.get(dtype, 0.0), err)
        lines.append(f"{name}: {rel_err:.2e}")
    print(f"kernel check k5: {len(cases)} cases within {FLASH_REL_BOUND} of the plain version "
          f"(relative max error): " + "; ".join(lines))
    return worst


# f32 head dims off the widths 16, 32, 64, 80, 96, 128 (the next width runs
# them with TMA's zeros past hd) and not multiples of 4 (padded to one by
# the wrapper): every f32 head dim 1..128 stays served
F32_ODD_HEAD_DIMS = (1, 6, 12, 36, 48, 68, 84, 100, 127)


def check_flash_head_dims(device):
    """The f32 kernel at `F32_ODD_HEAD_DIMS`, rel and plain, masked, at T=257
    (T_pad 512), against its plain version within FLASH_REL_BOUND. Returns
    the largest absolute difference."""
    cases = [(f"T=257 hd={hd} float32 rel={int(rel)} mask=1", 2, 2, 257, hd, "float32", rel,
              True) for hd in F32_ODD_HEAD_DIMS for rel in (True, False)]
    return check_flash(device, cases)["float32"]


def flash_bound(b, nh, t_pad, hd, elem_bytes, peak_ops, rel=True):
    """(bound_ms, bound_by) of one K5 launch: bytes moved once (q, k, v
    read, out written, the f32 mask; with `rel` also q_pos and the
    2·T_pad − 1 table rows) over 3.35 TB/s, against the operations per
    (batch, head) — q·kᵀ and P·V, 4·T_pad²·hd, and with `rel` the position
    term, 6·T_pad²·hd — over `peak_ops`."""
    n = b * nh * t_pad * hd
    if rel:
        nbytes = elem_bytes * (5 * n + nh * (2 * t_pad - 1) * hd) + 4 * b * t_pad
    else:
        nbytes = elem_bytes * 4 * n + 4 * b * t_pad
    ops = (6 if rel else 4) * t_pad * t_pad * hd * b * nh
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


K5_SASS_OPS = ("HGMMA", "UTMALDG", "HMMA", "FFMA", "TF32")
# K5's kernels by dtype: their SASS function names and instantiations
K5_SASS_KERNELS = {"bfloat16": ("flash_attention_wgmma_kernel", 10),
                   "float32": ("flash_attention_f32_kernel", 12)}


def k5_sass(library: str) -> dict:
    """Instructions of K5's kernels in the built library's SASS
    (`cuobjdump -sass`), by dtype: {"functions": instantiations, "HGMMA",
    "UTMALDG", "HMMA", "FFMA", "TF32": totals over them, "lacking":
    instantiations that do not show their kernel's instructions}. The bf16
    wgmma kernel shows HGMMA (wgmma) and UTMALDG (TMA loads) in each
    instantiation and no HMMA (mma.sync); the f32 kernel UTMALDG and FFMA
    in each and no tensor-core instruction (HGMMA, HMMA) and no TF32
    operand anywhere."""
    import re

    from wav2vec2_tpu_torch.ops import cuda_build

    cuobjdump = Path(cuda_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", library], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    ops = {op: re.compile(rf"\b{op}\b") for op in K5_SASS_OPS}
    ops["TF32"] = re.compile("tf32", re.IGNORECASE)  # a TF32 operand type anywhere
    per_function, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            current = next((dtype for dtype, (kernel, _) in K5_SASS_KERNELS.items()
                            if kernel in name), None)
            if current:
                current = (current, name)
                per_function[current] = dict.fromkeys(ops, 0)
        elif current:
            for op, pattern in ops.items():
                per_function[current][op] += bool(pattern.search(line))
    need = {"bfloat16": ("HGMMA", "UTMALDG"), "float32": ("UTMALDG", "FFMA")}
    result = {}
    for dtype in K5_SASS_KERNELS:
        funcs = {name: c for (d, name), c in per_function.items() if d == dtype}
        counts = {op: sum(c[op] for c in funcs.values()) for op in ops}
        counts["functions"] = len(funcs)
        counts["lacking"] = [name for name, c in funcs.items()
                             if not all(c[op] for op in need[dtype])]
        result[dtype] = counts
    return result


def check_k5_sass(sass: dict) -> None:
    """Fail unless each K5 kernel has all its instantiations, each with its
    instructions, the bf16 kernel no mma.sync, and the f32 kernel no
    tensor-core or TF32 instruction (its products exact FMAs)."""
    for dtype, (kernel, n) in K5_SASS_KERNELS.items():
        c = sass[dtype]
        bad = c["functions"] != n or c["lacking"] or c["HMMA"]
        if dtype == "float32":
            bad = bad or c["HGMMA"] or c["TF32"]
        if bad:
            raise AssertionError(f"the {dtype} K5 kernel's SASS ({kernel}): {c}; want {n} "
                                 "instantiations, each with its instructions")


def sdpa_backend(q, k, v, attn_mask, scale) -> str:
    """The backend scaled_dot_product_attention picks for these arguments,
    as its dispatcher chooses it (`torch._fused_sdp_choice`): "math",
    "flash_attention", "efficient_attention" or "cudnn_attention"."""
    import torch
    from torch.nn.attention import SDPBackend

    choice = torch._fused_sdp_choice(q, k, v, attn_mask=attn_mask, scale=scale)
    return SDPBackend(choice).name.lower()


def time_flash(device, card, self_attn, b, nh, t, hd):
    """K5 at the slice's shape (for the conformer large at 32 × 10 s: B=32,
    NH=16, T=499 → T_pad=512, hd=64; bf16, rel, masked): the kernel alone
    on padded inputs, its plain
    version, one library call (scaled_dot_product_attention with the
    position term and mask as a precomputed bf16 bias), and the port's
    factorized attention core at the same shape (layer 0's biases and
    linear_pos), and the f32 kernel at the same shape (the conformer's f32
    forward launches it; `time_flash_shape`). Checks both kernels against
    the plain version there too."""
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
    bound_ms, bound_by = flash_bound(b, nh, t_pad, hd, 2, PEAK_BF16_OPS_PER_S)
    work = 6 * t_pad * t_pad * hd * b * nh
    print(f"time: K5 bf16 (wgmma kernel) {work / (k_ms * 1e-3) / 1e12:.1f} TFLOP/s of the "
          f"6·T_pad²·hd work, {bound_ms / k_ms:.1%} of its bound ({bound_ms:.4f} ms by "
          f"{bound_by}); SDPA {lib_ms:.4f} ms, K5/SDPA {k_ms / lib_ms:.2f} {card}")
    print(f"time: K5 kernel {k_ms:.4f} ms vs plain PyTorch {p_ms:.3f} ms at B={b} NH={nh} "
          f"T={t} (T_pad={t_pad}) hd={hd} bf16 rel mask (device time, medians; plain, kernel, "
          f"kernel, plain); bound {bound_ms:.4f} ms by {bound_by}; relative error "
          f"{rel_err:.2e} {card}")
    # the f32 launches of the conformer's parity and default forwards
    f32 = time_flash_shape(device, card, b, nh, t, hd, rel=True, dtype="float32")
    print(f"time: library call scaled_dot_product_attention(q, k, v, attn_mask=bd*scale + "
          f"mask, scale) {lib_ms:.4f} ms at the same shape (bd precomputed, its construction "
          f"excluded; relative difference to the plain version {lib_err:.2e}); the port's "
          f"factorized attention core {core_ms:.4f} ms (device time, medians) {card}")
    return dict(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, bound_ms=bound_ms,
                bound_by=bound_by, err=err, f32=f32)


def kernel_time_split(fwd, ranges=()):
    """Device time of one call of `fwd` by kernel, from torch.profiler:
    {group: ms} over K5, GEMMs, convolutions and the rest (elementwise and
    reductions), the total, the five longest kernels, and {label: ms} for
    each (module, function name, label) of `ranges`: the function runs
    inside `record_function(label)` for the profiled call only, and its
    kernels' device time is summed over its calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    fwd()
    torch.cuda.synchronize()
    originals = []
    for module, attr, label in ranges:
        fn = getattr(module, attr)

        def wrapped(*a, _fn=fn, _label=label, **kw):
            with record_function(_label):
                return _fn(*a, **kw)

        setattr(module, attr, wrapped)
        originals.append((module, attr, fn))
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fwd()
            torch.cuda.synchronize()
    finally:
        for module, attr, fn in originals:
            setattr(module, attr, fn)
    labels = {label for *_, label in ranges}
    spans = {}
    for label in labels:
        # the CPU-side range sums its kernels; the GPU-side annotation
        # spans them (used where the first reads 0)
        events = [e for e in prof.events() if e.name == label]
        cpu = sum(e.device_time_total for e in events if e.device_type == DeviceType.CPU)
        gpu = sum(e.device_time_total for e in events if e.device_type == DeviceType.CUDA)
        spans[label] = (cpu or gpu) / 1e3
    kernels = [(e.key, e.device_time_total / 1e3) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.device_time_total > 0
               and e.key not in labels]
    groups = {"K5": 0.0, "GEMM": 0.0, "convolution": 0.0, "other": 0.0}
    for name, ms in kernels:
        low = name.lower()
        group = ("K5" if "flash_attention" in low
                 else "GEMM" if any(w in low for w in ("gemm", "nvjet", "xmma", "cutlass"))
                 else "convolution" if "conv" in low or "cudnn" in low
                 else "other")
        groups[group] += ms
    top = sorted(kernels, key=lambda kv: -kv[1])[:5]
    return groups, sum(groups.values()), top, spans


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
    the forward with and without K5, the f32 forward's time and K5's share
    of it, the frontend alone, the forward's device time by kernel group, the batch path's realtime factor and
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
        del on, off
        print(f"conformer f32 forward through K5 vs the factorized forward: relative max "
              f"error {flag_err:.2e} on the logits (bound 1e-3), 32 x 10 s")
        # the f32 forward (the default of the runtime, long-form, online and
        # the CLI) through K5's f32 kernel: its time and K5's share
        f32_ms = cuda_time_ms(lambda: forward(params, True, torch.float32), 3)
        f32_groups, f32_busy, _, _ = kernel_time_split(lambda: forward(params, True,
                                                                       torch.float32))
        del params
        f32_split = ("not measured (torch.profiler saw no CUDA kernel)" if not f32_busy else
                     f"K5 {f32_groups['K5']:.3f} ms of {f32_busy:.3f} busy ms "
                     f"({f32_groups['K5'] / f32_busy:.1%}; GEMM {f32_groups['GEMM']:.3f}, "
                     f"convolution {f32_groups['convolution']:.3f}, other "
                     f"{f32_groups['other']:.3f})")
        print(f"time: conformer rel-pos large f32 forward through K5 {f32_ms:.3f} ms, 32 x 10 "
              f"s (CUDA events, median of 3); by kernel (torch.profiler, one forward): "
              f"{f32_split} {card}")
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
        groups, busy_ms, top, _ = kernel_time_split(lambda: forward(p, True, torch.bfloat16))
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
    k5["f32_forward"] = dict(ms=f32_ms, k5_ms=f32_groups["K5"], busy_ms=f32_busy)
    return counts, k5, params_np


# --- the wav2vec2-encoder families ----------------------------------------
# the presets of the families phase (wav2vec2_tpu_torch/models/presets.py),
# each at its full width and depth, with the config.json model_type its HF
# checkpoint carries; the base-width ones first, mms-1b last
FAMILY_PRESETS = {
    "hubert-base-ls960": "hubert",
    "unispeech-sat-base-100h": "unispeech-sat",
    "mhubert-147": "hubert",
    "wavlm-base-plus": "wavlm",
    "data2vec-audio-base-960h": "data2vec-audio",
    "sew-base": "sew",
    "sew-d-base": "sew-d",
    "wav2vec2-large-960h-lv60": "wav2vec2",
    "xlsr-53": "wav2vec2",
    "hubert-large-ls960-ft": "hubert",
    "unispeech-large-phoneme": "unispeech",
    "wavlm-large": "wavlm",
    "wav2vec2-large-adapter": "wav2vec2",
    "wav2vec2-conformer-rope-large-960h": "wav2vec2-conformer",
    "w2v-bert-2.0": "wav2vec2-bert",
    "mms-1b": "wav2vec2",
}
# presets whose parameter tree has the shapes of another's (all fields equal
# but the vocabulary): they take its random weights, each with norms,
# biases and head drawn anew
SHARED_TREE = {"hubert-base-ls960": "wav2vec2-base-960h",
               "unispeech-sat-base-100h": "wav2vec2-base-960h",
               "xlsr-53": "wav2vec2-large-960h-lv60",
               "hubert-large-ls960-ft": "wav2vec2-large-960h-lv60",
               "unispeech-large-phoneme": "wav2vec2-large-960h-lv60"}
TIMED_PRESETS = ("wav2vec2-large-960h-lv60", "w2v-bert-2.0", "mms-1b")
FORCED_K5_PRESETS = ("wav2vec2-large-960h-lv60", "mms-1b",
                     "wav2vec2-conformer-rope-large-960h", "sew-base", "w2v-bert-2.0")
FAMILY_BATCH = 8
FAMILY_DIR_LAYERS = 2
FAMILY_CLI_CASES = 8
# the conv adapter's 160 ms frames hold about 6 words in 10 s of a
# transcript of the smoke's short words; 20 ms frames take 2 a second, and
# frames in between (w2v-BERT's adapter: 40 ms) in proportion
ADAPTER_WORDS_PER_S, WORDS_PER_S = 0.5, 2.0
_NORM_KEYS = {"layer_norm", "final_layer_norm", "norm", "proj_layer_norm",
              "ffn1_layer_norm", "ffn2_layer_norm", "self_attn_layer_norm", "output_norm",
              "rel_embeddings_layer_norm", "depthwise_layer_norm", "residual_layer_norm",
              "ffn_layer_norm"}


def family_words_per_s(cfg):
    """Transcript density that the preset's frames hold: 2 words a second
    at 20 ms, in proportion to coarser frames, at least 0.5."""
    return max(ADAPTER_WORDS_PER_S, WORDS_PER_S * 20.0 / cfg.frame_stride_ms(SAMPLE_RATE))


def perturb_tree(tree, seed):
    """A copy of the numpy tree with every norm affine, folded BatchNorm,
    WavLM gate constant and bias drawn from `seed` (init_params leaves
    them at 1 or 0, where a wrong transpose or a missed affine would pass
    unseen), the conformer's pos_bias_u/v non-zero, and SEW-D's
    rel_embeddings and w2v-BERT's distance_embedding drawn anew; the other
    leaves are shared."""
    rng = np.random.default_rng(seed)

    def draw(a, one):
        return np.float32(1.0 if one else 0.0) + np.float32(0.2) * rng.standard_normal(
            a.shape, dtype=np.float32)

    def walk(node, parent):
        if isinstance(node, list):
            return [walk(v, parent) for v in node]
        out = {}
        for k, v in node.items():
            if isinstance(v, (dict, list)):
                out[k] = walk(v, k)
            elif parent in _NORM_KEYS or parent == "batch_norm":
                out[k] = draw(v, k in ("weight", "scale"))
            elif k == "gru_rel_pos_const":
                out[k] = draw(v, True)
            elif k in ("bias", "pos_bias_u", "pos_bias_v"):
                out[k] = draw(v, False)
            elif k in ("rel_embeddings", "distance_embedding"):
                out[k] = np.float32(0.02) * rng.standard_normal(v.shape, dtype=np.float32)
            else:
                out[k] = v
        return out

    return walk(tree, None)


def family_inputs(rng, vocab, units, words_per_s, batch=FAMILY_BATCH, n_pad_s=10.0):
    """A padded batch of `batch` white-noise utterances from 10 s down to
    6 s (padded to `n_pad_s`) with transcripts of `words_per_s` words a
    second: the smoke's words, or phoneme symbols of 2-5 to a word.
    Returns (transcripts, token sequences, audio int16, audio lengths,
    tokens, token lengths)."""
    from wav2vec2_tpu_torch.align.tokenization import (
        build_token_sequence_case_aware,
        build_token_sequence_phoneme,
    )

    secs = np.linspace(n_pad_s, 6.0, batch)
    symbols = [s for s in vocab if vocab[s] > 4]
    transcripts = []
    for sec in secs:
        n = max(2, round(words_per_s * sec))
        if units == "phoneme":
            words = (" ".join(rng.choice(symbols, size=int(rng.integers(2, 6))))
                     for _ in range(n))
            transcripts.append(" | ".join(words))
        else:
            pool = WORDS[:8] if words_per_s < 1 else WORDS
            transcripts.append(" ".join(rng.choice(pool, size=n)))
    build = build_token_sequence_phoneme if units == "phoneme" else build_token_sequence_case_aware
    seqs = [build(t, vocab, 0, 4) for t in transcripts]
    n_pad = int(n_pad_s * SAMPLE_RATE)
    audio = np.zeros((batch, n_pad), np.int16)
    a_l = (secs * SAMPLE_RATE).astype(np.int32)
    for j, n in enumerate(a_l):
        audio[j, :n] = (rng.normal(size=n) * 4000).clip(-32768, 32767)
    s_pad = _round_s_pad(max(len(s.tokens) for s in seqs))
    tokens = np.zeros((batch, s_pad), np.int32)
    for j, s in enumerate(seqs):
        tokens[j, : len(s.tokens)] = s.tokens
    s_l = np.array([len(s.tokens) for s in seqs], np.int32)
    return transcripts, seqs, audio, a_l, tokens, s_l


def _round_s_pad(s):
    """S_pad on the batch engine's grid: 128·2^k."""
    n = 128
    while n < s:
        n *= 2
    return n


def lp_gate(lp, ref, t_lens, what):
    """bench.py's log-prob gate over the valid frames: mean |Δ| <= 0.05,
    p99 |Δ| <= 0.3. Returns (mean, p99)."""
    d = np.concatenate([np.abs(lp[j, :t].astype(np.float64) - ref[j, :t]).ravel()
                        for j, t in enumerate(t_lens)])
    mean_d, p99_d = float(d.mean()), float(np.percentile(d, 99))
    if not (mean_d <= 0.05 and p99_d <= 0.3):
        raise AssertionError(f"{what}: log-probs mean|Δ|={mean_d} (cap 0.05), "
                             f"p99|Δ|={p99_d} (cap 0.3)")
    return mean_d, p99_d


def run_family(device, card, name, cfg, params, vocab, units):
    """One preset through `BatchAligner.submit_padded_batch` on a padded
    batch of 8 utterances (10 s down to 6 s) at bf16 and at f32 (TF32 off),
    with the gates: (a) K1's paths of the bf16 batch == viterbi_numpy on 4
    rows; (b) each utterance's f32 log-probs in the padded batch within
    1e-4 of its unpadded forward; (c) bf16 against f32 log-probs within
    bench.py's gate; and every utterance aligned to all its words (units),
    in order and monotone, on the 160 ms grid for the conv adapter.
    Returns (launch counts, the bf16 aligner, the f32 aligner, the device
    inputs, the normalized audio, the bf16 forward ms)."""
    import torch

    from wav2vec2_tpu_torch.models.ctc_model import log_softmax_logits, wav2vec2_forward
    from wav2vec2_tpu_torch.ops.viterbi_ref import viterbi_numpy
    from wav2vec2_tpu_torch.parallel.batching import BatchAligner, _normalize_batch

    rng = np.random.default_rng(30)
    _, seqs, *arrays = family_inputs(rng, vocab, units, family_words_per_s(cfg))
    inputs = [torch.from_numpy(a).to(device) for a in arrays]
    aligners = {dtype: BatchAligner(cfg, params, vocab, compute_dtype=dtype, device=device,
                                    normalize_on_device=True, units=units)
                for dtype in ("bfloat16", "float32")}
    reset_launches()
    lp, outs = {}, {}
    for dtype, aligner in aligners.items():
        handles = aligner.submit_padded_batch(*inputs, return_log_probs=True)
        outs[dtype] = aligner.group_batch(seqs, handles)
        lp[dtype] = handles[-1].cpu().numpy()
        if dtype == "bfloat16":
            paths, t_lens = handles[0].cpu().numpy(), handles[1].cpu().numpy()
    counts = read_launches()
    t_pad = cfg.conv_output_length(arrays[0].shape[1])
    for dtype, x in lp.items():
        if not np.isfinite(x).all() or x.shape != (FAMILY_BATCH, t_pad, cfg.vocab_size):
            raise AssertionError(f"{name} {dtype}: log-probs not finite or of shape {x.shape}")
    for j in range(4):
        t_i = int(t_lens[j])
        oracle = [s for s, _ in viterbi_numpy(lp["bfloat16"][j, :t_i], np.asarray(seqs[j].tokens))]
        if list(paths[j, :t_i]) != oracle:
            raise AssertionError(f"{name}: gate (a): K1 path differs from viterbi_numpy at {j}")
    stride_ms = cfg.frame_stride_ms(SAMPLE_RATE)
    for dtype, rows in outs.items():
        for j, (seq, out) in enumerate(zip(seqs, rows)):
            check_words(out.words, seq.normalized_words, f"{name} {dtype} utterance {j}")
            if any(w.start_ms % stride_ms or w.end_ms % stride_ms for w in out.words):
                raise AssertionError(f"{name}: boundaries off the {stride_ms:g} ms grid")
    audio = _normalize_batch(inputs[0], inputs[1])
    f32 = aligners["float32"]
    worst = 0.0
    with torch.inference_mode():
        for j in range(FAMILY_BATCH):
            n = int(arrays[1][j])
            alone = log_softmax_logits(wav2vec2_forward(
                f32.params, audio[j:j + 1, :n], f32.cfg, compute_dtype=torch.float32))
            alone = alone[0].cpu().numpy()
            if alone.shape[0] != int(t_lens[j]):
                raise AssertionError(f"{name}: unpadded forward gave {alone.shape[0]} frames, "
                                     f"want {int(t_lens[j])}")
            worst = max(worst, float(np.abs(lp["float32"][j, : alone.shape[0]] - alone).max()))
    if worst > 1e-4:
        raise AssertionError(f"{name}: gate (b): padded vs unpadded f32 log-probs differ by "
                             f"{worst} (bound 1e-4)")
    mean_d, p99_d = lp_gate(lp["bfloat16"], lp["float32"], t_lens, f"{name}: gate (c)")
    bf16 = aligners["bfloat16"]
    with torch.inference_mode():
        fwd = lambda: wav2vec2_forward(bf16.params, audio, bf16.cfg,  # noqa: E731
                                       audio_lens=inputs[1], compute_dtype=torch.bfloat16)
        fwd()
        fwd_ms = cuda_time_ms(fwd, 3)
    print(f"family {name}: {FAMILY_BATCH} x 6-10 s (T_pad={t_pad}, S_pad={arrays[2].shape[1]}, "
          f"{stride_ms:g} ms frames, units {units}), gates passed: (a) K1 == viterbi_numpy "
          f"(4 rows); (b) padded vs unpadded f32 max|Δ|={worst:.2e}; (c) bf16 vs f32 "
          f"mean|Δ|={mean_d:.4f} p99|Δ|={p99_d:.4f}; all units in order; launches "
          f"{ {k: n for k, n in counts.items() if n} }; bf16 forward {fwd_ms:.3f} ms "
          f"(CUDA events, median of 3) {card}")
    return counts, bf16, f32, inputs, audio


def forced_k5(name, cfg, bf16, f32, inputs, audio):
    """WAV2VEC2_FLASH_FORCE=1 on the preset's batch: K5 once per layer that
    takes it (every encoder layer; for w2v-BERT only the adapter's
    position-free attention, never its relative_key blocks) in the f32 and
    the bf16 forward, the f32 forward within 1e-3 relative of the default
    forward's logits (the conformer's gate), the bf16 log-probs within
    bench.py's gate of the default f32 ones (the f32 launches in the f32
    kernel, the bf16 ones in the wgmma kernel). Returns the K5 launches
    ("k5", and by kernel "k5_fma", "k5_wgmma")."""
    import dataclasses

    import torch

    from wav2vec2_tpu_torch.models.ctc_model import log_softmax_logits, wav2vec2_forward
    from wav2vec2_tpu_torch.ops import flash_attention as fa

    cfg = dataclasses.replace(cfg, use_flash_attention=True)  # as BatchAligner sets it
    with torch.inference_mode():
        default = wav2vec2_forward(f32.params, audio, cfg, audio_lens=inputs[1])
        os.environ[fa.FORCE_ENV] = "1"
        try:
            reset_launches()
            forced = wav2vec2_forward(f32.params, audio, cfg, audio_lens=inputs[1])
            c32 = read_launches()
            reset_launches()
            forced_bf16 = wav2vec2_forward(bf16.params, audio, cfg, audio_lens=inputs[1],
                                           compute_dtype=torch.bfloat16)
            c16 = read_launches()
            n32, n16 = c32["k5"], c16["k5"]
        finally:
            del os.environ[fa.FORCE_ENV]
        rel_err = float((forced - default).abs().max()) / float(default.abs().max())
        t_lens = [cfg.conv_output_length(int(n)) for n in inputs[1].cpu().numpy()]
        ref = log_softmax_logits(default).cpu().numpy()
        mean_d, p99_d = lp_gate(log_softmax_logits(forced_bf16).cpu().numpy(), ref, t_lens,
                                f"{name} forced K5 bf16")
    bert = cfg.encoder_style == "conformer_bert"
    n_layers = cfg.num_adapter_layers if bert else cfg.num_hidden_layers
    what = "adapter layers" if bert else "layers"
    if not n32 == c32["k5_fma"] == n16 == c16["k5_wgmma"] == n_layers:
        raise AssertionError(f"{name} forced: K5 launched {c32} (f32) and {c16} (bf16) "
                             f"for {n_layers} {what}")
    if not rel_err <= 1e-3:
        raise AssertionError(f"{name} forced: f32 forward through K5 vs the default: relative "
                             f"error {rel_err} (bound 1e-3)")
    width = (cfg.output_hidden_size or cfg.hidden_size) if bert else cfg.hidden_size
    print(f"family {name}, WAV2VEC2_FLASH_FORCE=1: K5 {n32} launches in the f32 forward, "
          f"{n16} in the bf16 one ({n_layers} {what}, head dim "
          f"{width // cfg.num_attention_heads}); f32 logits vs the default forward "
          f"relative max error {rel_err:.2e} (bound 1e-3); bf16 log-probs vs default f32 "
          f"mean|Δ|={mean_d:.4f} p99|Δ|={p99_d:.4f}")
    return {key: c32[key] + c16[key] for key in ("k5", "k5_fma", "k5_wgmma")}


def time_family(card, name, aligner, vocab):
    """The preset at B=32 x 10 s bf16 through `time_batch_path` (3 batches,
    double-buffered) and its forward alone (CUDA events), split by kernel
    group; for w2v-BERT also the device time of the mel frontend and of the
    relative_key terms within it."""
    import torch

    from wav2vec2_tpu_torch.models import encoder, mel
    from wav2vec2_tpu_torch.models.ctc_model import wav2vec2_forward
    from wav2vec2_tpu_torch.parallel.batching import _normalize_batch

    rtf, total_s, peak_gb, wait_ms, group_ms = time_batch_path(aligner, vocab, 32, repeats=3)
    _, audio, a_l, _, _ = batch_inputs(np.random.default_rng(2), vocab, 32, 10.0)
    audio, a_l = (torch.from_numpy(a).to(aligner.device) for a in (audio, a_l))
    with torch.inference_mode():
        audio = _normalize_batch(audio, a_l)
        fwd = lambda: wav2vec2_forward(aligner.params, audio, aligner.cfg,  # noqa: E731
                                       audio_lens=a_l, compute_dtype=torch.bfloat16)
        fwd()
        fwd_ms = cuda_time_ms(fwd, 3)
        ranges = []
        if aligner.cfg.frontend_style == "mel":
            ranges.append((mel, "mel_frontend", "mel frontend"))
        if aligner.cfg.position_embeddings_type == "relative_key":
            ranges.append((encoder, "_relative_key_term", "relative_key term"))
        groups, busy_ms, top, spans = kernel_time_split(fwd, ranges)
    print(f"time: {name} batch path {rtf:.1f}x realtime (3 batches of 32 x 10 s, bf16, "
          f"submit/drain double-buffered, {total_s / 3 * 1e3:.1f} ms wall per batch; host "
          f"waited {wait_ms:.1f} ms, grouped {group_ms:.1f} ms; peak device memory "
          f"{peak_gb:.2f} GB); forward {fwd_ms:.3f} ms (CUDA events, median of 3) {card}")
    split = ("not measured (torch.profiler saw no CUDA kernel)" if not busy_ms else
             f"device busy {busy_ms:.3f} ms; "
             + ", ".join(f"{g} {ms:.3f} ms" for g, ms in groups.items())
             + "".join(f"; of it the {label} {ms:.3f} ms" for label, ms in spans.items())
             + "; longest: " + "; ".join(f"{k[:60]} {ms:.3f} ms" for k, ms in top))
    print(f"time: {name} forward by kernel (torch.profiler, one forward, 32 x 10 s bf16): "
          f"{split} {card}")
    return dict(rtf=rtf, batch_ms=total_s / 3 * 1e3, forward_ms=fwd_ms, peak_gb=peak_gb,
                **spans)


def time_flash_shape(device, card, b, nh, t, hd, rel=False, dtype="bfloat16"):
    """K5 at one masked shape in `dtype`: the kernel alone, its plain
    version and scaled_dot_product_attention on the same dtype (with `rel`,
    given the position term and the mask as a precomputed bias, its
    construction excluded; the backend it picked named), with the bound of
    the 4·T_pad²·hd operations a (batch, head) does (q·kᵀ and P·V;
    6·T_pad²·hd with `rel`) at the dtype's peak (989 TFLOP/s bf16 on the
    tensor cores, 67 f32). Plain masked attention at B=32, NH=16, T=499
    (T_pad 512) is the shape of the forced forwards at 32 x 10 s (head dim
    80 in column chunks); B=1, NH=16, T=249 (T_pad 256) with `rel` is an
    online window of the conformer rel-pos large; B=4 NH=16 and B=8 NH=8
    at T=499 with `rel` are the (m2) mesh's local tiles (f32 there); T=1
    499 (T_pad 1 536) is long-form's 30 s chunk (f32 by default)."""
    import torch
    import torch.nn.functional as F

    from wav2vec2_tpu_torch.models.layers import full_f32_precision
    from wav2vec2_tpu_torch.ops import flash_attention as fa
    from wav2vec2_tpu_torch.ops import flash_attention_ref

    scale = hd ** -0.5
    rng = np.random.default_rng(14)
    q, k, v, mask, q_pos, rel_r = flash_inputs(rng, b, nh, t, hd, dtype, rel, True, device)
    pq, pk, pv, pmask, pq_pos = fa.pad_inputs(q, k, v, mask, q_pos, rel_r)
    del q, k, v, mask, q_pos
    t_pad = pq.shape[2]
    kernel = lambda: fa.flash_attention(pq, pk, pv, pmask, q_pos=pq_pos,  # noqa: E731
                                        rel_r=rel_r, scale=scale)

    def plain():
        with full_f32_precision():
            return flash_attention_ref.attention(pq, pk, pv, pmask, q_pos=pq_pos, rel_r=rel_r,
                                                 scale=scale)

    got, want = kernel().float(), plain().float()
    err = float((got - want).abs().max())
    rel_err = err / float(want.abs().max())
    del got, want
    if rel_err > FLASH_REL_BOUND[dtype]:
        raise AssertionError(f"K5 {dtype} B={b} T={t} hd={hd} rel={rel}: relative error "
                             f"{rel_err}")
    f32 = dtype == "float32"
    k_ms, p_ms = interleaved_ms(kernel, plain, 5 if f32 else 20, 3)
    with torch.inference_mode(), full_f32_precision():
        bias = pmask[:, None, None, :]
        if rel:
            bias = flash_attention_ref.rel_scores(pq_pos, rel_r) * scale + bias
        bias = bias.to(pq.dtype)
        library = lambda: F.scaled_dot_product_attention(pq, pk, pv, attn_mask=bias,  # noqa: E731
                                                         scale=scale)
        library()
        lib_ms = kernel_ms(library, 5 if f32 else 20)
        backend = sdpa_backend(pq, pk, pv, bias, scale)
        del bias
    bound_ms, bound_by = flash_bound(b, nh, t_pad, hd, pq.element_size(),
                                     PEAK_F32_OPS_PER_S if f32 else PEAK_BF16_OPS_PER_S,
                                     rel=rel)
    what = "rel-pos masked attention" if rel else "plain masked attention (forced)"
    work = (6 if rel else 4) * t_pad * t_pad * hd * b * nh
    kind = "f32 (exact FMA kernel)" if f32 else "bf16"
    print(f"time: K5 {what} hd={hd}: kernel {k_ms:.4f} ms vs plain "
          f"PyTorch {p_ms:.3f} ms vs SDPA {lib_ms:.4f} ms ({backend}; K5/SDPA "
          f"{k_ms / lib_ms:.2f}) at B={b} NH={nh} T={t} (T_pad={t_pad}) {kind}; "
          f"{work / (k_ms * 1e-3) / 1e12:.1f} TFLOP/s of the {6 if rel else 4}·T_pad²·hd work; "
          f"bound {bound_ms:.4f} ms by {bound_by} ({bound_ms / k_ms:.1%} of it); relative error "
          f"{rel_err:.2e} (device time, medians) {card}")
    return dict(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, bound_ms=bound_ms,
                bound_by=bound_by, err=err, sdpa_backend=backend)


# f32 K5 on the main paths besides the conformer's batch shape (timed in
# `time_flash`): (b, nh, t, hd, rel) of the forced plain forwards at hd 64
# (lv60) and 80 (mms-1b), the conformer's online window, long-form's 30 s
# chunk and the (m2) mesh's two tiles
F32_FLASH_SHAPES = ((32, 16, 499, 64, False), (32, 16, 499, 80, False), (1, 16, 249, 64, True),
                    (2, 16, 1499, 64, True), (4, 16, 499, 64, True), (8, 8, 499, 64, True))


def time_flash_f32(device, card):
    """The f32 K5 kernel at `F32_FLASH_SHAPES` (`time_flash_shape`)."""
    return [time_flash_shape(device, card, *shape[:4], rel=shape[4], dtype="float32")
            for shape in F32_FLASH_SHAPES]


def family_config_dict(cfg, model_type, n_layers):
    """The config.json of a preset's HF-format directory, cut to
    `n_layers` encoder layers."""
    import dataclasses

    d = {k: v for k, v in dataclasses.asdict(cfg).items() if v is not None}
    d.pop("use_flash_attention")
    return {**d, "model_type": model_type, "num_hidden_layers": n_layers}


def run_family_dir(device, card, name, model_type, cfg, tree, vocab, units, root: Path):
    """The preset at full width and 2 layers as an HF-format directory
    (`params_to_hf_flat_dict` under its model_type's prefix), loaded by
    `ForcedAlignerBuilder` at f32: its units on one 8 s request equal
    `BatchAligner`'s at f32 on the same weights, every boundary equal.
    Returns the launch counts."""
    from wav2vec2_tpu_torch import AlignmentInput, ForcedAlignerBuilder, Wav2Vec2Config
    from wav2vec2_tpu_torch.config import Wav2Vec2ModelConfig
    from wav2vec2_tpu_torch.models.params import params_from_jax, params_to_hf_flat_dict
    from wav2vec2_tpu_torch.parallel.batching import BatchAligner
    from wav2vec2_tpu_torch.pipeline.defaults import PhonemeGrouper, PhonemeTokenizer
    from wav2vec2_tpu_torch.utils.checkpoint import save_safetensors

    d = family_config_dict(cfg, model_type, FAMILY_DIR_LAYERS)
    cfg2 = Wav2Vec2ModelConfig.from_dict(d)
    tree2 = first_layers(tree, FAMILY_DIR_LAYERS)
    root.mkdir()
    (root / "config.json").write_text(json.dumps(d))
    (root / "vocab.json").write_text(json.dumps(vocab))
    save_safetensors(root / "model.safetensors",
                     params_to_hf_flat_dict(tree2, cfg2, model_type=model_type))
    builder = ForcedAlignerBuilder(Wav2Vec2Config(
        model_path=str(root / "model.safetensors"), config_path=str(root / "config.json"),
        vocab_path=str(root / "vocab.json"), device=str(device)))
    if units == "phoneme":
        builder = builder.with_tokenizer(PhonemeTokenizer()).with_word_grouper(PhonemeGrouper())
    aligner = builder.build()
    rng = np.random.default_rng(31)
    (transcript,), seqs, audio, a_l, _, _ = family_inputs(
        rng, vocab, units, family_words_per_s(cfg), batch=1, n_pad_s=8.0)
    samples = audio[0, : a_l[0]].astype(np.float32) / np.float32(32768)
    reset_launches()
    got = aligner.align(AlignmentInput(SAMPLE_RATE, samples, transcript)).words
    want = BatchAligner(cfg2, params_from_jax(tree2, device=device), vocab,
                        compute_dtype="float32", device=device, units=units) \
        .align_utterances([samples], [transcript])[0].words
    counts = read_launches()
    check_words(got, seqs[0].normalized_words, f"{name} directory, single entry")
    if [(w.word, w.start_ms, w.end_ms) for w in got] != \
            [(w.word, w.start_ms, w.end_ms) for w in want]:
        raise AssertionError(f"{name} directory: single and batch units or boundaries differ")
    size_mb = (root / "model.safetensors").stat().st_size / 1e6
    print(f"family {name}: HF-format directory ({model_type}, {FAMILY_DIR_LAYERS} layers, "
          f"{size_mb:.0f} MB) through ForcedAlignerBuilder at f32: {len(got)} units, every "
          f"boundary equal to BatchAligner's ({cfg.frame_stride_ms(SAMPLE_RATE):g} ms frames); "
          f"launches { {k: n for k, n in counts.items() if n} } {card}")
    return counts


def run_family_cli(device, card, model_dir: Path, vocab):
    """`alignment_report` (batch, bf16, textgrid) with an HF-format model
    directory over the first 8 utterances of the CLI phase's dataset: every
    utterance gets a TextGrid with all its words in order."""
    from wav2vec2_tpu_torch.cli.alignment_report import run

    cases, _ = cli_cases(np.random.default_rng(11))
    cases = cases[:FAMILY_CLI_CASES]
    with tempfile.TemporaryDirectory() as tmp:
        data = write_librispeech(Path(tmp), cases, np.random.default_rng(12))
        reset_launches()
        t0 = time.perf_counter()
        rc = run(["--model-dir", str(model_dir), "--dataset-root", str(data), "--device",
                  str(device), "--output-format", "textgrid", "--compute-dtype", "bfloat16"])
        wall = time.perf_counter() - t0
        counts = read_launches()
        if rc != 0:
            raise AssertionError(f"alignment_report with {model_dir.name} exited {rc}")
        grids = sorted(data.rglob("*.TextGrid"))
        texts = {}
        for trans in data.rglob("*.trans.txt"):
            for line in trans.read_text().splitlines():
                uid, text = line.split(" ", 1)
                texts[uid] = text.split()
        if len(grids) != FAMILY_CLI_CASES:
            raise AssertionError(f"alignment_report with {model_dir.name} wrote {len(grids)} "
                                 f"TextGrids for {FAMILY_CLI_CASES} utterances")
        for grid in grids:
            words = [w.upper() for w, *_ in textgrid_words(grid)]
            if words != [w.upper() for w in texts[grid.name.split(".")[0]]]:
                raise AssertionError(f"{grid.name}: words differ from the transcript")
    audio_s = sum(sec for sec, _ in cases)
    print(f"family cli: alignment_report --model-dir {model_dir.name} (batch, bf16, textgrid) "
          f"over {FAMILY_CLI_CASES} utterances ({audio_s:.1f} s): all words in order; wall "
          f"{wall:.3f} s; launches { {k: n for k, n in counts.items() if n} } {card}")
    return counts


def run_families(device, card, vocab):
    """The families phase: the 16 presets of FAMILY_PRESETS at full width and
    depth through the batch entry (gates (a)-(c)); lv60, w2v-BERT and
    mms-1b timed at 32 x 10 s bf16; K5 forced on lv60 (head dim 64),
    mms-1b (80), the rotary conformer, SEW (at the pooled length) and
    w2v-BERT's adapter (never its relative_key blocks); K5 on forced plain
    attention timed at hd 64 and 80;
    one HF-format directory (2 layers) per preset but xlsr-53 (lv60's
    family) through `ForcedAlignerBuilder`, and the CLI with the
    hubert-large directory. Weights from `init_params` with a numpy seed,
    drawn on host threads ahead of the card; norms, BatchNorms, gates and
    biases drawn anew by `perturb_tree`. Returns (launches of the phase,
    K5's plain-attention times by head dim, the timed presets' numbers)."""
    import dataclasses
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from wav2vec2_tpu_torch.models import presets
    from wav2vec2_tpu_torch.models.params import init_params, params_from_jax

    ph_vocab = phoneme_vocab()
    cfgs = {name: presets.PRESETS[name](
        PHONEME_VOCAB if name == "unispeech-large-phoneme" else 32) for name in FAMILY_PRESETS}
    sources = list(dict.fromkeys(SHARED_TREE.get(name, name) for name in FAMILY_PRESETS))
    for name, src in SHARED_TREE.items():
        src_cfg = presets.PRESETS[src](32)
        if dataclasses.replace(cfgs[name], vocab_size=32) != src_cfg:
            raise AssertionError(f"{name} does not have {src}'s parameter shapes")
    last_use = {SHARED_TREE.get(name, name): name for name in FAMILY_PRESETS}
    totals = {}
    plain_k5, timed = {}, {}
    t_start = time.perf_counter()
    with ThreadPoolExecutor(max_workers=4) as pool, tempfile.TemporaryDirectory() as tmp:
        trees = {src: pool.submit(init_params, presets.PRESETS[src](32), 100 + i)
                 for i, src in enumerate(sources)}
        for i, (name, model_type) in enumerate(FAMILY_PRESETS.items()):
            cfg, src = cfgs[name], SHARED_TREE.get(name, name)
            t0 = time.perf_counter()
            tree = perturb_tree(trees[src].result(), 200 + i)
            wait_s = time.perf_counter() - t0
            if last_use[src] == name:
                del trees[src]
            if tree["lm_head"]["bias"].shape != (cfg.vocab_size,):
                h = tree["lm_head"]["kernel"].shape[0]
                head = np.random.default_rng(300 + i).standard_normal((h, cfg.vocab_size),
                                                                      dtype=np.float32)
                tree["lm_head"] = {
                    "kernel": head * np.float32((2.0 / (h + cfg.vocab_size)) ** 0.5),
                    "bias": np.zeros(cfg.vocab_size, np.float32)}
            units = "phoneme" if name == "unispeech-large-phoneme" else "word"
            v = ph_vocab if units == "phoneme" else vocab
            params = params_from_jax(tree, device=device)
            n_params = sum(x.numel() for x in tree_leaves(params))
            print(f"family {name}: {n_params / 1e6:.1f} M parameters (host init waited "
                  f"{wait_s:.1f} s)")
            counts, bf16, f32, inputs, audio = run_family(device, card, name, cfg, params,
                                                          v, units)
            _add_counts(totals, counts)
            if name in FORCED_K5_PRESETS:
                _add_counts(totals, forced_k5(name, cfg, bf16, f32, inputs, audio))
            del f32, params
            if name in TIMED_PRESETS:
                reset_launches()
                timed[name] = time_family(card, name, bf16, v)
                _add_counts(totals, read_launches())
            del bf16, inputs, audio
            torch.cuda.empty_cache()
            if name != "xlsr-53":
                _add_counts(totals, run_family_dir(device, card, name, model_type, cfg, tree, v,
                                                   units, Path(tmp) / name))
            del tree
        _add_counts(totals, run_family_cli(device, card, Path(tmp) / "hubert-large-ls960-ft",
                                           vocab))
    for hd in (64, 80):
        plain_k5[hd] = time_flash_shape(device, card, 32, 16, 499, hd)
    print(f"families phase: {len(FAMILY_PRESETS)} presets in "
          f"{time.perf_counter() - t_start:.1f} s; launches {totals} {card}")
    return totals, plain_k5, timed


# --- the serving slice: the daemon, online alignment, int8, doctor --------
SERVE_REQUESTS = 96
SERVE_CLIENTS = 16
SERVE_CHECKED_ALONE = 16
SERVE_WORDS_PER_S = 2
SERVE_INT8_REQUESTS = 8
STREAMS = 4
STREAM_SECONDS = 60.0
STREAM_PIECE = 5120  # 0.32 s
ONLINE_SECONDS = 60.0
ONLINE_WORDS = 120
ONLINE_CONFORMER_SECONDS = 30.0
ONLINE_KNOBS = dict(chunk_sec=5.0, overlap_sec=1.0, finalize_margin_sec=2.0)


def http(url, path, payload=None, method="POST", timeout=300):
    """(status, JSON body) of one request to the daemon."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def pcm16_audio(rng, n):
    """(the pcm16 payload, the f32 samples the daemon decodes from it) of
    n samples of noise."""
    import base64

    pcm = np.clip(np.round(rng.normal(0, 0.1, n) * 32768.0), -32768, 32767).astype("<i2")
    return ({"pcm16": base64.b64encode(pcm.tobytes()).decode()},
            pcm.astype(np.float32) / np.float32(32768.0))


def pcm16_audio_of(audio):
    """The pcm16 payload of f32 samples decoded from pcm16 (exact)."""
    import base64

    pcm = np.round(audio * np.float32(32768.0)).astype("<i2")
    return {"pcm16": base64.b64encode(pcm.tobytes()).decode()}


def word_tuples(words):
    return [(w.word, w.start_ms, w.end_ms, w.confidence) for w in words]


def check_json_words(words, want, n_samples, stride_ms, what):
    """The transcript's words in order, boundaries monotone and inside the
    audio."""
    if [w["word"] for w in words] != list(want):
        raise AssertionError(f"{what}: words {[w['word'] for w in words]} are not the "
                             "transcript's in order")
    for a, b in zip(words, words[1:]):
        if not a["start_ms"] <= a["end_ms"] <= b["start_ms"] <= b["end_ms"]:
            raise AssertionError(f"{what}: words not monotone: {a} then {b}")
    if words and words[-1]["end_ms"] > n_samples / SAMPLE_RATE * 1e3 + stride_ms:
        raise AssertionError(f"{what}: a word ends past the audio: {words[-1]}")


def stream_session(url, text, audio):
    """One /stream session pushed in 0.32 s pieces: (words emitted along
    the way, the flush's words)."""
    import base64

    code, out = http(url, "/stream", {"transcript": text, **ONLINE_KNOBS})
    if code != 200:
        raise AssertionError(f"/stream start: {code} {out}")
    sid = out["stream_id"]
    pcm = np.clip(np.round(audio * 32768.0), -32768, 32767).astype("<i2")
    emitted = []
    for i in range(0, len(pcm), STREAM_PIECE):
        code, out = http(url, f"/stream/{sid}", {"audio": {
            "pcm16": base64.b64encode(pcm[i: i + STREAM_PIECE].tobytes()).decode()}})
        if code != 200:
            raise AssertionError(f"/stream push: {code} {out}")
        emitted += out["words"]
    code, out = http(url, f"/stream/{sid}/flush")
    if code != 200:
        raise AssertionError(f"/stream flush: {code} {out}")
    return emitted, out["words"]


def alone_agreement(aligner, items, batched, stride_ms):
    """(words exact, within one frame, total) of the daemon's answers
    against each (audio, transcript) aligned alone by `align_utterances`."""
    exact = within = total = 0
    for (audio, text), words in zip(items, batched):
        alone = aligner.align_utterances([audio], [text])[0].words
        if [w["word"] for w in words] != [w.word for w in alone]:
            raise AssertionError("a batched answer's words differ from the alone run's")
        for got, want in zip(words, alone):
            d = max(abs(got["start_ms"] - want.start_ms), abs(got["end_ms"] - want.end_ms))
            total, exact, within = total + 1, exact + (d == 0), within + (d <= stride_ms)
    return exact, within, total


def run_serve(device, card, model_dir: Path, cfg, vocab):
    """The serving daemon at the full width and depth of wav2vec2-base:
    `build_service_from_model_dir` (bf16, 25 ms window, max_batch 32) on a
    model directory written by the port's writer, `warmup_aligner` at 4 and
    8 s, an `AlignHTTPServer` on 127.0.0.1:0 with a `StreamRegistry`. 16
    client threads send 96 /align requests (2-12 s, 2 words a second,
    pcm16 base64 and float lists, some as srt/vtt) while 4 /stream sessions
    push 60 s each in 0.32 s pieces. Gates: (s1) every /align is 200 with
    the transcript's words in order, monotone and inside the audio; (s2)
    /stats counts 96 aligned with batches larger than 1; (s3) 16 of the
    requests sent together to an f32 service on the same directory: every
    word within one frame of the same utterance aligned alone, >= 99%
    exact (the bf16 agreement is printed: bf16 results move with the
    batch's GEMM shapes, and random weights leave paths near-tied);
    (s4) in a burst, the request whose transcript cannot fit gets 400 and
    the others 200; (s5, read by the caller) K1 launched, resident; each
    stream's flush has the words of the same stream run alone in process,
    boundaries within one frame, and its emitted words are a prefix of it.
    Then an int8 service on the same directory answers 8 requests."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from wav2vec2_tpu_torch.align.online import OnlineAligner
    from wav2vec2_tpu_torch.serve import (
        AlignHTTPServer,
        StreamRegistry,
        build_service_from_model_dir,
        make_handler,
        warmup_aligner,
    )

    stride_ms = cfg.frame_stride_ms(SAMPLE_RATE)
    t0 = time.perf_counter()
    service, label = build_service_from_model_dir(model_dir, "bfloat16", window_ms=25,
                                                  max_batch=32, device=str(device))
    load_s = time.perf_counter() - t0
    if label != torch.cuda.get_device_name(0):
        raise AssertionError(f"the service's device label is {label!r}")
    t0 = time.perf_counter()
    shapes = warmup_aligner(service.aligner, [4, 8], max_batch=32)
    warm_s = time.perf_counter() - t0
    streams = StreamRegistry(service.aligner, "bfloat16")
    httpd = AlignHTTPServer(("127.0.0.1", 0), make_handler(service, label, streams))
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{httpd.server_port}"
    rng = np.random.default_rng(40)
    requests = []
    for i in range(SERVE_REQUESTS):
        n = int(rng.uniform(2.0, 12.0) * SAMPLE_RATE)
        payload_audio, audio = pcm16_audio(rng, n)
        text = " ".join(rng.choice(WORDS, size=max(1, round(SERVE_WORDS_PER_S * n
                                                               / SAMPLE_RATE))))
        if i % 4 == 3:
            payload_audio = audio.tolist()
        fmt = {5: "srt", 11: "vtt"}.get(i % 16, "words")
        requests.append((audio, text, fmt,
                         {"audio": payload_audio, "transcript": text, "format": fmt}))
    stream_texts = [" ".join(rng.choice(WORDS, size=int(SERVE_WORDS_PER_S * STREAM_SECONDS)))
                    for _ in range(STREAMS)]
    stream_audio = [pcm16_audio(rng, int(STREAM_SECONDS * SAMPLE_RATE))[1]
                    for _ in range(STREAMS)]
    stream_out = [None] * STREAMS

    def stream(i):
        try:
            stream_out[i] = stream_session(url, stream_texts[i], stream_audio[i])
        except BaseException as e:  # raised again below, on the main thread
            stream_out[i] = e

    try:
        t0 = time.perf_counter()
        stream_threads = [threading.Thread(target=stream, args=(i,)) for i in range(STREAMS)]
        for t in stream_threads:
            t.start()
        with ThreadPoolExecutor(max_workers=SERVE_CLIENTS) as pool:
            answers = list(pool.map(lambda r: http(url, "/align", r[3]), requests))
        align_s = time.perf_counter() - t0
        for t in stream_threads:
            t.join(timeout=600)
        streams_s = time.perf_counter() - t0
        for i, ((audio, text, fmt, _), (code, body)) in enumerate(zip(requests, answers)):
            if code != 200:
                raise AssertionError(f"gate (s1): request {i} answered {code}: {body}")
            if fmt == "words":
                check_json_words(body["words"], text.split(), len(audio), stride_ms,
                                 f"gate (s1), request {i}")
            elif not (body["subtitles"].startswith("WEBVTT" if fmt == "vtt" else "1\n")
                      and all(w in body["subtitles"] for w in text.split())):
                raise AssertionError(f"gate (s1): request {i}'s {fmt} lacks its words")
        code, stats = http(url, "/stats", method="GET")
        hist = {int(k): n for k, n in stats["batch_size_histogram"].items()}
        if stats["utterances_aligned"] != SERVE_REQUESTS or max(hist) < 2:
            raise AssertionError(f"gate (s2): /stats {stats}")
        checked = [i for i, r in enumerate(requests) if r[2] == "words"][:SERVE_CHECKED_ALONE]
        bf16_alone = alone_agreement(service.aligner, [requests[i][:2] for i in checked],
                                     [answers[i][1]["words"] for i in checked], stride_ms)
        burst = [requests[j][3] for j in range(7)]
        burst.insert(3, {"audio": [0.01] * 4800, "transcript": " ".join(WORDS)})
        with ThreadPoolExecutor(max_workers=len(burst)) as pool:
            codes = [(c, b) for c, b in pool.map(lambda p: http(url, "/align", p), burst)]
        if [c for c, _ in codes] != [200] * 3 + [400] + [200] * 4 \
                or "too short" not in codes[3][1]["error"]:
            raise AssertionError(f"gate (s4): burst answered {[c for c, _ in codes]}")
        # the same requests again as pcm16 alone, with no stream beside them:
        # how much of the latency is the float-list JSON and the streams
        busy0 = stats["audio_seconds"] / stats["realtime_factor"]
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            with ThreadPoolExecutor(max_workers=SERVE_CLIENTS) as pool:
                quiet = list(pool.map(lambda r: http(url, "/align", {
                    **r[3], "audio": pcm16_audio_of(r[0])}), requests))
            quiet_s = time.perf_counter() - t0
        kernel_s = sum(e.device_time_total for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA) / 1e6
        _, stats2 = http(url, "/stats", method="GET")
        quiet_rtf = (stats2["audio_seconds"] - stats["audio_seconds"]) / (
            stats2["audio_seconds"] / stats2["realtime_factor"] - busy0)
        if any(c != 200 for c, _ in quiet):
            raise AssertionError(f"the pcm16-only pass answered {[c for c, _ in quiet]}")
        for i, result in enumerate(stream_out):
            if not isinstance(result, tuple):
                raise AssertionError(f"stream {i} failed: {result!r}") from (
                    result if isinstance(result, BaseException) else None)
            emitted, flushed = result
            solo = OnlineAligner(service.aligner.cfg, service.aligner.params, vocab,
                                 stream_texts[i], compute_dtype="bfloat16", device=device,
                                 **ONLINE_KNOBS)
            for j in range(0, len(stream_audio[i]), STREAM_PIECE):
                solo.push(stream_audio[i][j: j + STREAM_PIECE])
            want = solo.flush().words
            check_json_words(flushed, stream_texts[i].split(), len(stream_audio[i]), stride_ms,
                             f"stream {i}")
            if emitted != flushed[: len(emitted)] or not emitted:
                raise AssertionError(f"stream {i}: {len(emitted)} emitted words are not a "
                                     "prefix of its flush")
            if [w.word for w in want] != [w["word"] for w in flushed] or any(
                    max(abs(g["start_ms"] - w.start_ms), abs(g["end_ms"] - w.end_ms))
                    > stride_ms for g, w in zip(flushed, want)):
                raise AssertionError(f"stream {i}: its flush differs from the same stream "
                                     "run alone by more than one frame")
    finally:
        httpd.shutdown()
        service.close()
    # (s3) at f32: bf16 results move with the batch's shape (the GEMMs'
    # accumulation order), and random weights leave the paths near-tied
    service, _ = build_service_from_model_dir(model_dir, "float32", window_ms=25,
                                              max_batch=32, device=str(device))
    httpd = AlignHTTPServer(("127.0.0.1", 0), make_handler(service, label))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        f32_url = f"http://127.0.0.1:{httpd.server_port}"
        with ThreadPoolExecutor(max_workers=len(checked)) as pool:
            f32_answers = list(pool.map(lambda i: http(f32_url, "/align", requests[i][3]),
                                        checked))
        if any(c != 200 for c, _ in f32_answers) or max(b["batch_size"]
                                                        for _, b in f32_answers) < 2:
            raise AssertionError(f"gate (s3): f32 answers {[(c, b.get('batch_size')) for c, b in f32_answers]}")
        exact, within, total = alone_agreement(service.aligner,
                                               [requests[i][:2] for i in checked],
                                               [b["words"] for _, b in f32_answers], stride_ms)
        if not (within == total and exact >= 0.99 * total):
            raise AssertionError(f"gate (s3): {exact}/{total} exact, {within}/{total} within "
                                 "one frame of the utterances aligned alone (f32)")
    finally:
        httpd.shutdown()
        service.close()
    lat = [body["latency_ms"] for _, body in answers]
    audio_s = sum(len(r[0]) for r in requests) / SAMPLE_RATE
    print(f"serve: wav2vec2-base bf16 service built in {load_s:.3f} s, warmed {shapes} batch "
          f"shapes in {warm_s:.3f} s; {SERVE_REQUESTS} /align requests ({audio_s:.1f} s of "
          f"audio) from {SERVE_CLIENTS} clients in {align_s:.3f} s beside {STREAMS} /stream "
          f"sessions of {STREAM_SECONDS:g} s ({streams_s:.3f} s); gates passed: (s1) all 200 "
          f"with their words; (s2) /stats {stats['utterances_aligned']} aligned, batch sizes "
          f"{dict(sorted(hist.items()))}; (s3) at f32, {len(checked)} requests batched "
          f"together: {exact}/{total} words exact, {within}/{total} within one frame of each "
          f"aligned alone (bf16, not gated: {bf16_alone[0]}/{bf16_alone[2]} exact, "
          f"{bf16_alone[1]}/{bf16_alone[2]} within one frame); (s4) burst "
          f"{[c for c, _ in codes]}; streams equal to alone")
    print(f"time: serve /align latency p50 {np.percentile(lat, 50):.2f} ms, p99 "
          f"{np.percentile(lat, 99):.2f} ms over {SERVE_REQUESTS} requests at {SERVE_CLIENTS} "
          f"clients (latency_ms, beside {STREAMS} streams); /stats realtime_factor "
          f"{stats['realtime_factor']} (audio seconds over the worker's busy seconds) {card}")
    lat = [body["latency_ms"] for _, body in quiet]
    print(f"time: serve /align again, pcm16 only and no stream: {quiet_s:.3f} s for "
          f"{SERVE_REQUESTS} requests, latency p50 {np.percentile(lat, 50):.2f} ms, p99 "
          f"{np.percentile(lat, 99):.2f} ms, {quiet_rtf:.1f}x realtime over the worker's busy "
          f"seconds; device kernels {kernel_s:.3f} s of the pass's wall (torch.profiler, CUDA "
          f"activity only: the card idle {1 - kernel_s / quiet_s:.1%}) {card}")

    service, _ = build_service_from_model_dir(model_dir, "bfloat16", window_ms=25,
                                              max_batch=32, quantize_int8=True,
                                              device=str(device))
    try:
        with ThreadPoolExecutor(max_workers=SERVE_INT8_REQUESTS) as pool:
            outs = list(pool.map(lambda r: service.submit(r[0], r[1]),
                                 [r for r in requests if r[2] == "words"][:SERVE_INT8_REQUESTS]))
        for (out, _), r in zip(outs, [r for r in requests if r[2] == "words"]):
            check_words(out.words, r[1].split(), "int8 service")
        q = service.aligner.params["encoder"]["layers"]["attention"]["q_proj"]
        if q["kernel_q"].dtype != torch.int8 or service.aligner.cfg.use_flash_attention:
            raise AssertionError("the int8 service is not quantized, or runs K5")
    finally:
        service.close()
    print(f"serve --quantize-int8: {SERVE_INT8_REQUESTS} requests on the same directory "
          f"aligned every word in order (batch sizes {sorted(bs for _, bs in outs)})")


def online_run(cfg, params, vocab, text, audio, piece, device, dtype="bfloat16",
               normalize="window", record=False):
    """One `OnlineAligner` stream (chunk 5 s, overlap 1 s, margin 2 s),
    warmed up, pushed in pieces of `piece` samples and flushed, with its
    window forwards timed by CUDA events and its host DP and finalize by
    the host clock. Returns a dict of the words and the times (and each
    window's input and log-probs with `record`)."""
    import torch

    from wav2vec2_tpu_torch.align.online import OnlineAligner

    ol = OnlineAligner(cfg, params, vocab, text, compute_dtype=dtype, normalize=normalize,
                       device=device, **ONLINE_KNOBS)
    ol.warmup()
    events, windows, host = [], [], {"dp": 0.0, "finalize": 0.0}
    fwd, dp_append, finalize = ol._fwd, ol.dp.append, ol._finalize

    def timed_fwd(p, a, n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fwd(p, a, n)
        end.record()
        events.append((start, end))
        if record:
            windows.append((a.clone(), int(n[0]), out))
        return out

    def timed(name, fn):
        def run(*a):
            t0 = time.perf_counter()
            try:
                return fn(*a)
            finally:
                host[name] += time.perf_counter() - t0
        return run

    ol._fwd, ol.dp.append, ol._finalize = timed_fwd, timed("dp", dp_append), \
        timed("finalize", finalize)
    emitted, push_ms = [], []
    t0 = time.perf_counter()
    for i in range(0, len(audio), piece):
        t1 = time.perf_counter()
        emitted += ol.push(audio[i: i + piece])
        push_ms.append((time.perf_counter() - t1) * 1e3)
    out = ol.flush().words
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dict(emitted=emitted, words=out, push_ms=push_ms, wall=wall, windows=windows,
                fwd_ms=[s.elapsed_time(e) for s, e in events], host=host, aligner=ol)


def check_stable_prefix(run, text, what):
    """(o1): the words emitted along the way are a prefix of the flush,
    word, start, end and confidence; all of the transcript's words."""
    check_words(run["words"], text.split(), what)
    if not run["emitted"] or word_tuples(run["emitted"]) != \
            word_tuples(run["words"])[: len(run["emitted"])]:
        raise AssertionError(f"gate (o1), {what}: {len(run['emitted'])} emitted words are not "
                             "a prefix of the flush")


def print_online(card, label, run, seconds):
    per_s = {k: v * 1e3 / seconds for k, v in run["host"].items()}
    print(f"time: online {label}: per push p50 {np.percentile(run['push_ms'], 50):.3f} ms, p99 "
          f"{np.percentile(run['push_ms'], 99):.3f} ms ({len(run['push_ms'])} pushes); window "
          f"forward {statistics.median(run['fwd_ms']):.3f} ms (CUDA events, median of "
          f"{len(run['fwd_ms'])}); host DP {per_s['dp']:.3f} ms and finalize "
          f"{per_s['finalize']:.3f} ms per audio second; stream {seconds / run['wall']:.1f}x "
          f"realtime (push + flush wall) {card}")


def run_online(device, card, cfg, params, vocab):
    """`OnlineAligner` on wav2vec2-base at full width and depth, 60 s with
    120 words, chunk 5 s, overlap 1 s, margin 2 s, at bf16 and f32. Gates:
    (o1) emitted words a prefix of the flush; (o2) 0.1 s and 1.7 s pieces
    give an identical flush; (o3) at f32 with normalize="none" the words of
    `align_longform` on the same audio and windows, boundaries monotone;
    (o4) each window's f32 log-probs within 1e-4 of the batch forward on
    the same windows."""
    import torch

    from wav2vec2_tpu_torch.align.longform import align_longform
    from wav2vec2_tpu_torch.models.ctc_model import log_softmax_logits, wav2vec2_forward
    from wav2vec2_tpu_torch.pipeline.runtime import normalize_audio

    rng = np.random.default_rng(41)
    audio = pcm16_audio(rng, int(ONLINE_SECONDS * SAMPLE_RATE))[1]
    text = " ".join(rng.choice(WORDS, size=ONLINE_WORDS))
    bf16 = online_run(cfg, params, vocab, text, audio, STREAM_PIECE, device)
    check_stable_prefix(bf16, text, "online bf16")
    pieces = [online_run(cfg, params, vocab, text, audio, n, device)
              for n in (1600, 27200)]
    if not word_tuples(pieces[0]["words"]) == word_tuples(pieces[1]["words"]) \
            == word_tuples(bf16["words"]):
        raise AssertionError("gate (o2): 0.1 s, 0.32 s and 1.7 s pieces give different flushes")
    norm = normalize_audio(audio)
    f32 = online_run(cfg, params, vocab, text, norm, STREAM_PIECE, device, dtype="float32",
                     normalize="none", record=True)
    check_stable_prefix(f32, text, "online f32")
    offline = align_longform(norm, text, params, cfg, vocab, chunk_sec=5.0, overlap_sec=1.0,
                             compute_dtype="float32", device=device)
    if [w.word for w in offline.words] != [w.word for w in f32["words"]]:
        raise AssertionError("gate (o3): online f32 words differ from align_longform's")
    with torch.inference_mode():
        audio_w = torch.cat([a for a, _, _ in f32["windows"]])
        lens = torch.tensor([n for _, n, _ in f32["windows"]], dtype=torch.int32, device=device)
        batch_lp = log_softmax_logits(wav2vec2_forward(params, audio_w, cfg, audio_lens=lens,
                                                       compute_dtype=torch.float32))
    lp_err = 0.0
    for j, (_, n, lp) in enumerate(f32["windows"]):
        t = cfg.conv_output_length(n)
        lp_err = max(lp_err, float((lp[0, :t] - batch_lp[j, :t]).abs().max()))
    if not lp_err <= 1e-4:
        raise AssertionError(f"gate (o4): window log-probs {lp_err} from the batch forward")
    print(f"online: wav2vec2-base, {ONLINE_SECONDS:g} s with {ONLINE_WORDS} words, gates passed: "
          f"(o1) {len(bf16['emitted'])} bf16 and {len(f32['emitted'])} f32 words emitted before "
          f"the flush, a prefix of it; (o2) 0.1/0.32/1.7 s pieces give the same flush; (o3) "
          f"f32 words == align_longform's; (o4) {len(f32['windows'])} windows' f32 log-probs "
          f"within {lp_err:.2e} of the batch forward (bound 1e-4)")
    print_online(card, "wav2vec2-base bf16, 0.32 s pieces", bf16, ONLINE_SECONDS)
    print_online(card, "wav2vec2-base f32, 0.32 s pieces", f32, ONLINE_SECONDS)
    print_online(card, "wav2vec2-base bf16, 0.1 s pieces", pieces[0], ONLINE_SECONDS)


def run_online_conformer(device, card, conformer_np, vocab):
    """The conformer rel-pos large at full width and depth online: 30 s at
    bf16 with the service's aligner (`BatchAligner`'s config and bf16
    weights, its kernel switch on): (o1) holds, and K5 runs 24 times a
    window at B=1, T=249 (T_pad 256). Then K5 alone at that shape against
    its plain version, SDPA and its bound. Returns (launches, K5 row)."""
    import torch

    from wav2vec2_tpu_torch.config import Wav2Vec2ModelConfig
    from wav2vec2_tpu_torch.models.params import params_from_jax
    from wav2vec2_tpu_torch.ops import flash_attention as fa
    from wav2vec2_tpu_torch.parallel.batching import BatchAligner

    cfg = Wav2Vec2ModelConfig.from_dict(CONFORMER_CONFIG)
    aligner = BatchAligner(cfg, params_from_jax(conformer_np, device=device), vocab,
                           "bfloat16", device=device)
    rng = np.random.default_rng(42)
    audio = pcm16_audio(rng, int(ONLINE_CONFORMER_SECONDS * SAMPLE_RATE))[1]
    text = " ".join(rng.choice(WORDS, size=int(SERVE_WORDS_PER_S * ONLINE_CONFORMER_SECONDS)))
    shapes, real = [], fa.flash_attention

    def recording(q, *a, **kw):
        shapes.append((q.shape[0], fa.pad_len(q.shape[2])))
        return real(q, *a, **kw)

    fa.flash_attention = recording
    try:
        reset_launches()
        run = online_run(aligner.cfg, aligner.params, vocab, text, audio, STREAM_PIECE, device)
        counts = read_launches()
    finally:
        fa.flash_attention = real
    check_stable_prefix(run, text, "online conformer")
    windows = len(run["fwd_ms"]) + 1  # and the warm-up window
    if counts["k5"] != cfg.num_hidden_layers * windows or set(shapes) != {(1, 256)}:
        raise AssertionError(f"online conformer: {counts} over {windows} windows at (B, T_pad) "
                             f"{set(shapes)}; want K5 {cfg.num_hidden_layers} a window at (1, 256)")
    print(f"online: conformer rel-pos large, {ONLINE_CONFORMER_SECONDS:g} s bf16, (o1) passed "
          f"({len(run['emitted'])} words emitted before the flush); K5 {counts['k5']} launches "
          f"over {windows} windows at B=1 T_pad=256")
    print_online(card, "conformer rel-pos large bf16, 0.32 s pieces", run,
                 ONLINE_CONFORMER_SECONDS)
    del aligner
    nh = cfg.num_attention_heads
    row = time_flash_shape(device, card, 1, nh, cfg.conv_output_length(80_000),
                           cfg.hidden_size // nh, rel=True)
    return counts, row


def run_int8(device, card, cfg, params, vocab, bf16_aligner):
    """`BatchAligner(quantize_int8=True)` against bf16 on the same 32 x 10 s
    batch of the batch entry. Gates: (i1) `linear_int8` at wav2vec2-base's
    shapes ([B·T, 768] x [768, 3072] and back): int32 accumulators equal
    to an f64 product of the same int8 values, the card's int8 tree equal
    to the one quantized on the host, the output bit-equal to the same
    function on the CPU (512 rows); (i2) the JAX package's bound on the
    log-probs (max |Δ| < 0.25·max|lp_bf16| + 0.1) and equal word
    sequences; (i3) no K5 launch under int8. Returns the launches."""
    import torch

    from wav2vec2_tpu_torch.models.layers import gelu
    from wav2vec2_tpu_torch.models.quantize import (
        int8_matmul,
        linear_int8,
        quantize_linear_int8,
        quantize_rows,
    )
    from wav2vec2_tpu_torch.parallel.batching import BatchAligner

    seqs, *arrays = batch_inputs(np.random.default_rng(0), vocab, 32, 10.0)
    inputs = [torch.from_numpy(a).to(device) for a in arrays]
    int8 = BatchAligner(cfg, params, vocab, "bfloat16", device=device, normalize_on_device=True,
                        quantize_int8=True)
    ffn_q = int8.params["encoder"]["layers"]["feed_forward"]
    ffn = params["encoder"]["layers"]["feed_forward"]
    rows = 32 * cfg.conv_output_length(arrays[0].shape[1])
    x = torch.from_numpy(np.random.default_rng(43).normal(size=(rows, cfg.hidden_size))
                         .astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    checked = []
    with torch.inference_mode():
        for name in ("intermediate_dense", "output_dense"):
            host = quantize_linear_int8({k: v.cpu() for k, v in ffn[name].items()})
            q = {k: v[0] for k, v in ffn_q[name].items()}
            if not all(torch.equal(ffn_q[name][k].cpu(), host[k]) for k in ("kernel_q", "scale")):
                raise AssertionError(f"gate (i1): {name}'s int8 tree differs from the host's")
            xq, _ = quantize_rows(x)
            acc = int8_matmul(xq, q["kernel_q"])
            if not torch.equal(acc.double(), xq.double() @ q["kernel_q"].double()):
                raise AssertionError(f"gate (i1): {name}'s int32 accumulators differ from f64")
            y = linear_int8(x, q["kernel_q"], q["scale"], q["bias"])
            y_cpu = linear_int8(x[:512].cpu(), q["kernel_q"].cpu(), q["scale"].cpu(),
                                q["bias"].cpu())
            if not torch.equal(y[:512].cpu().view(torch.int16), y_cpu.view(torch.int16)):
                raise AssertionError(f"gate (i1): {name}'s card output differs from the CPU's")
            checked.append(f"[{x.shape[0]}, {x.shape[1]}] x {list(q['kernel_q'].shape)}")
            x = gelu(y)
        reset_launches()
        hq = int8.submit_padded_batch(*inputs, return_log_probs=True)
        outs_q = int8.group_batch(seqs, hq)
        counts = read_launches()
        hb = bf16_aligner.submit_padded_batch(*inputs, return_log_probs=True)
        outs_b = bf16_aligner.group_batch(seqs, hb)
    if counts["k5"] or counts["k1"] < 1:
        raise AssertionError(f"gate (i3): the int8 batch launched {counts}")
    lp_q, lp_b, t_lens = hq[-1].cpu().numpy(), hb[-1].cpu().numpy(), hq[1].cpu().numpy()
    d_max = max(float(np.abs(lp_q[j, :t] - lp_b[j, :t]).max()) for j, t in enumerate(t_lens))
    ref = max(float(np.abs(lp_b[j, :t]).max()) for j, t in enumerate(t_lens))
    if not d_max < 0.25 * ref + 0.1:
        raise AssertionError(f"gate (i2): int8 log-probs max|Δ| {d_max}, bound {0.25 * ref + 0.1}")
    stride_ms = cfg.frame_stride_ms(SAMPLE_RATE)
    total = exact = within = 0
    for j, (q, b) in enumerate(zip(outs_q, outs_b)):
        if [w.word for w in q.words] != [w.word for w in b.words]:
            raise AssertionError(f"gate (i2): int8 words differ from bf16's at utterance {j}")
        for wq, wb in zip(q.words, b.words):
            d = max(abs(wq.start_ms - wb.start_ms), abs(wq.end_ms - wb.end_ms))
            total, exact, within = total + 1, exact + (d == 0), within + (d <= stride_ms)
    print(f"int8: gates passed: (i1) linear_int8 at {' and '.join(checked)}: int32 "
          f"accumulators == f64 product, the card's int8 tree == the host's, output bit-equal "
          f"to the CPU's (512 rows); (i2) log-probs max|Δ| {d_max:.4f} < bound "
          f"{0.25 * ref + 0.1:.4f}, words equal on 32 x 10 s (boundaries, not gated: "
          f"{exact}/{total} exact, {within}/{total} within one frame); (i3) launches {counts}")
    with torch.inference_mode():
        from wav2vec2_tpu_torch.models.ctc_model import wav2vec2_forward
        from wav2vec2_tpu_torch.parallel.batching import _normalize_batch

        audio = _normalize_batch(inputs[0], inputs[1])
        fwd = {name: (lambda a=a: wav2vec2_forward(a.params, audio, cfg, audio_lens=inputs[1],
                                                   compute_dtype=torch.bfloat16))
               for name, a in (("bf16", bf16_aligner), ("int8", int8))}
        ms = {name: [] for name in fwd}
        for name in ("bf16", "int8", "int8", "bf16"):
            fwd[name]()
            ms[name].append(cuda_time_ms(fwd[name], 3))
    split = {}
    for name in ("bf16", "int8"):
        groups, busy_ms, _, _ = kernel_time_split(fwd[name])
        split[name] = ("not measured" if not busy_ms else f"busy {busy_ms:.3f} ms: " + ", ".join(
            f"{g} {ms:.3f}" for g, ms in groups.items() if g != "K5"))
    rtf = {name: time_batch_path(a, vocab, 32, repeats=3)[0]
           for name, a in (("int8", int8), ("bf16", bf16_aligner))}
    print(f"time: wav2vec2-base forward int8 {statistics.median(ms['int8']):.3f} ms vs bf16 "
          f"{statistics.median(ms['bf16']):.3f} ms for 32 x 10 s (CUDA events, medians; bf16, "
          f"int8, int8, bf16); batch path int8 {rtf['int8']:.1f}x vs bf16 {rtf['bf16']:.1f}x "
          f"realtime (3 batches of 32 x 10 s each) {card}")
    print(f"time: the int8 forward by kernel group (torch.profiler, one forward; int8's GEMMs "
          f"are cuBLASLt's): int8 {split['int8']}; bf16 {split['bf16']} {card}")
    return counts


def check_doctor(proc, card_name):
    """The `doctor` subprocess started on the serve directory: exit 0, its
    accelerator line names the card, its kernel line is ok."""
    out, err = proc.communicate(timeout=300)
    lines = out.splitlines()
    acc = [line for line in lines if " accelerator: " in line]
    kern = [line for line in lines if " cuda kernels: " in line]
    if proc.returncode != 0 or not acc or card_name not in acc[0] \
            or not acc[0].startswith("[  ok]") or not kern or not kern[0].startswith("[  ok]"):
        raise AssertionError(f"doctor exited {proc.returncode}:\n{out}\n{err[-2000:]}")
    print("doctor: exit 0; " + " | ".join(line for line in lines
                                          if "accelerator" in line or "cuda kernels" in line
                                          or "model.safetensors" in line))


ONNX_SECONDS = (4.0, 5.0, 6.0, 7.0, 8.0, 9.0, 10.0, 12.0)
ONNX_WORDS = 14
ONNX_TIMED_REPEATS = 3
ONNX_CLI_CASES = ((3.0, "THE QUICK FOX"), (5.5, "OVER THE LAZY DOG TONIGHT"),
                  (8.0, "WHILE SINGING ANCIENT MELODIES UNDER BRIGHT STARS"))
X1_BOUND = 1e-4  # session logits against the port's own f32 forward


def counted(fn):
    """fn() with the launch counts set to 0 just before it; (result, counts)."""
    reset_launches()
    out = fn()
    return out, read_launches()


def run_onnx(device, card, cfg, params_np, vocab):
    """The ONNX runtime on the card (wav2vec2-base, 12 layers, f32): the
    port's exporter (twice: the same bytes), `OnnxRuntimeBackend(device=
    "cuda")` through `ForcedAlignerBuilder` on 8 requests of 4-12 s beside
    the torch backend at f32 on the same weights (both read the model
    directory), and the CLI with `--runtime onnx`. Gates (x1) session
    logits within 1e-4 of the port's f32 forward on the card, (x2) words
    and milliseconds equal to the torch backend's, (x3) K1 on every request
    up to 512 frames, K2 on the 12 s one, no K5, (x4) the provider names
    CUDA, (x5) the CLI exits 0 with every word in order. Returns the launch
    counts."""
    import torch

    from wav2vec2_tpu_torch import AlignmentInput, ForcedAlignerBuilder, Wav2Vec2Config
    from wav2vec2_tpu_torch.cli.alignment_report import run
    from wav2vec2_tpu_torch.models.ctc_model import wav2vec2_forward
    from wav2vec2_tpu_torch.models.params import load_safetensors_params, params_to_device
    from wav2vec2_tpu_torch.onnx import export_ctc_model
    from wav2vec2_tpu_torch.ops import viterbi_cuda
    from wav2vec2_tpu_torch.pipeline.onnx_runtime import OnnxRuntimeBackend
    from wav2vec2_tpu_torch.pipeline.runtime import normalize_audio

    totals: dict[str, int] = {}
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        write_model_dir(d, BASE_CONFIG, params_np, cfg, vocab)
        params = load_safetensors_params(d / "model.safetensors", cfg)  # what both runtimes read
        t0 = time.perf_counter()
        data = export_ctc_model(cfg, params).encode()
        export_s = time.perf_counter() - t0
        if export_ctc_model(cfg, params).encode() != data:
            raise AssertionError("the exporter wrote other bytes on its second call")
        (d / "model.onnx").write_bytes(data)
        backend = OnnxRuntimeBackend(d / "model.onnx", cfg, device=str(device))
        label = backend.device_label()
        if "CUDA" not in label:
            raise AssertionError(f"gate (x4): the ONNX session runs on {label}")
        nodes = len(backend._session._graph.nodes)
        print(f"onnx: exported wav2vec2-base ({len(data) / 1e6:.1f} MB, {nodes} nodes) in "
              f"{export_s:.2f} s, the same bytes twice; session {label} {card}")

        def config(weights):
            return Wav2Vec2Config(model_path=str(d / weights), config_path=str(d / "config.json"),
                                  vocab_path=str(d / "vocab.json"), device=str(device))

        onnx_aligner = ForcedAlignerBuilder(config("model.onnx")) \
            .with_runtime_backend(backend).build()
        torch_aligner = ForcedAlignerBuilder(config("model.safetensors")) \
            .with_backend_options(compute_dtype="float32").build()
        params_dev = params_to_device(params, device)
        rng = np.random.default_rng(11)
        requests = [(sec, (rng.normal(size=int(sec * SAMPLE_RATE)) * 0.1).astype(np.float32),
                     " ".join(rng.choice(WORDS, size=ONNX_WORDS))) for sec in ONNX_SECONDS]
        warm = AlignmentInput(SAMPLE_RATE, requests[-1][1], requests[-1][2])
        for aligner in (onnx_aligner, torch_aligner):  # cuDNN / cuBLAS first calls
            _add_counts(totals, counted(lambda a=aligner: a.align_profiled(warm))[1])
        x1_err, rows = 0.0, []
        for i, (sec, samples, text) in enumerate(requests):
            inp = AlignmentInput(SAMPLE_RATE, samples, text)
            got, counts = counted(lambda: onnx_aligner.align_profiled(inp))
            _add_counts(totals, counts)
            t_len = cfg.conv_output_length(len(samples))
            want_tier = "k1" if t_len <= viterbi_cuda.K1_MAX_FRAMES else "k2"
            if counts[want_tier] < 1 or counts["k5"]:
                raise AssertionError(f"gate (x3): request {i} ({sec:g} s, T={t_len}) "
                                     f"launched {counts}, want {want_tier} and no k5")
            want, counts = counted(lambda: torch_aligner.align_profiled(inp))
            _add_counts(totals, counts)
            check_words(got.output.words, text.split(), f"onnx request {i}")
            if word_tuples_ms(got.output.words) != word_tuples_ms(want.output.words):
                raise AssertionError(f"gate (x2): request {i}: the ONNX runtime's words "
                                     "differ from the torch backend's at f32")
            norm = normalize_audio(samples)[None]
            (logits,) = backend._session.run(None, {"audio": norm})
            with torch.inference_mode():
                ref = wav2vec2_forward(params_dev, torch.from_numpy(norm).to(device), cfg)
            err = float(np.abs(logits - ref.cpu().numpy()).max())
            x1_err = max(x1_err, err)
            if not err <= X1_BOUND:
                raise AssertionError(f"gate (x1): request {i}: session logits {err:.3g} "
                                     f"from the f32 forward (bound {X1_BOUND})")
            onnx_ms, torch_ms = [got.timings.forward_ms], [want.timings.forward_ms]
            for _ in range(ONNX_TIMED_REPEATS - 1):
                for aligner, ms in ((onnx_aligner, onnx_ms), (torch_aligner, torch_ms)):
                    res, counts = counted(lambda a=aligner: a.align_profiled(inp))
                    _add_counts(totals, counts)
                    ms.append(res.timings.forward_ms)
            rows.append((sec, t_len, want_tier, statistics.median(onnx_ms),
                         statistics.median(torch_ms)))
        for sec, t_len, tier, o_ms, t_ms in rows:
            print(f"time: onnx {sec:g} s request (T={t_len}, DP {tier}): session "
                  f"{o_ms:.2f} ms vs torch f32 forward {t_ms:.2f} ms ({o_ms / t_ms:.2f}x; "
                  f"host clock around synchronized calls, median of {ONNX_TIMED_REPEATS}) "
                  f"{card}")
        print(f"onnx: gates (x1) max |session - forward| {x1_err:.3g} <= {X1_BOUND}, (x2) "
              f"{len(requests)} requests' words and ms equal the torch backend's, (x3) K1/K2 "
              f"as the tier rule picks, no K5; {nodes} torch calls (one a node) per session "
              "run")

        root = write_librispeech(d / "data", ONNX_CLI_CASES, np.random.default_rng(12))
        argv = ["--model-dir", str(d), "--dataset-root", str(root), "--runtime", "onnx",
                "--device", str(device), "--output-format", "textgrid"]
        rc, counts = counted(lambda: run(argv))
        _add_counts(totals, counts)
        grids = sorted(root.rglob("*.TextGrid"))
        if rc != 0 or len(grids) != len(ONNX_CLI_CASES):
            raise AssertionError(f"gate (x5): the CLI with --runtime onnx exited {rc} and "
                                 f"wrote {len(grids)} TextGrids")
        for grid in grids:  # <speaker>-<chapter>-<case index>.TextGrid
            text = ONNX_CLI_CASES[int(grid.stem.split("-")[-1])][1]
            if [w for w, _, _ in textgrid_words(grid)] != text.split():
                raise AssertionError(f"gate (x5): {grid.name} holds other words than {text!r}")
        if counts["k1"] < 1 or counts["k5"]:
            raise AssertionError(f"gate (x5): the ONNX CLI launched {counts}")
        print(f"onnx: gate (x5) the CLI with --runtime onnx wrote {len(grids)} TextGrids, "
              f"every word in order; launches {counts}")
    return totals


def word_tuples_ms(words):
    return [(w.word, w.start_ms, w.end_ms) for w in words]


# the tiny synthetic-tone train→align task of tests/test_train_align_e2e.py
TONE_N = 1600  # 100 ms a synthetic "phoneme"
TONE_N_PAD = 24000
TONES = {1: 440.0, 2: 880.0, 4: 1320.0, 5: 1760.0}
TONE_CONFIG = dict(
    model_type="wav2vec2", hidden_size=48, num_hidden_layers=2, num_attention_heads=2,
    intermediate_size=96, conv_dim=[24, 24], conv_kernel=[10, 4], conv_stride=[5, 4],
    num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4, pad_token_id=0,
    vocab_size=8, feat_extract_norm="group", conv_bias=False,
)
TONE_VOCAB = {"a": 1, "b": 2, "|": 3, "c": 4, "d": 5}
TONE_CHARS = {1: "a", 2: "b", 4: "c", 5: "d"}
TRAIN_BATCH, TRAIN_SECONDS, TRAIN_TIMED_STEPS = 32, 10.0, 8
# AdamW at lr 1e-5 for (t1): at optax's default 1e-4 the first steps of the
# random-init base model on one noise batch swing up and down (B=4 x 3 s on
# the CPU: 308.03, 375.53, 286.05, 398.23, ... in the JAX package and the
# same to 0.1 in the port), so "the last loss below the first" would judge
# the learning rate, not the port; at 1e-5 the same run goes 308.0 -> 218.7
TRAIN_LR = 1e-5


class ToneTask:
    """Batches of tone words with their labels (`make_batch`), as the JAX
    package's end-to-end test draws them."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def sample(self):
        return [list(self.rng.choice([1, 2, 4, 5], size=int(self.rng.integers(2, 4))))
                for _ in range(int(self.rng.integers(2, 4)))]

    def synth(self, label_seq):
        wav, t = [], 0
        for word in label_seq:
            for lid in word:
                wav.append(0.3 * np.sin(2 * np.pi * TONES[lid] * np.arange(TONE_N) / SAMPLE_RATE)
                           + self.rng.normal(size=TONE_N) * 0.01)
                t += TONE_N
            sil = int(self.rng.integers(800, 2400))
            wav.append(self.rng.normal(size=sil) * 0.01)
            t += sil
        return np.concatenate(wav).astype(np.float32)[:TONE_N_PAD]

    def make_batch(self, bs):
        audio = np.zeros((bs, TONE_N_PAD), np.float32)
        a_l = np.zeros(bs, np.int32)
        labels = np.zeros((bs, 16), np.int32)
        l_l = np.zeros(bs, np.int32)
        words = []
        for i in range(bs):
            s = self.sample()
            w = self.synth(s)
            audio[i, : len(w)] = w / max(w.std(), 1e-6)
            a_l[i] = len(w)
            flat = [lid for word in s for lid in (word + [3])][:-1][:16]
            labels[i, : len(flat)] = flat
            l_l[i] = len(flat)
            words.append(" ".join("".join(TONE_CHARS[c] for c in word) for word in s))
        return (audio, a_l, labels, l_l), words


def detach_tree(tree):
    """The tree with every tensor detached from autograd."""
    if isinstance(tree, dict):
        return {k: detach_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [detach_tree(v) for v in tree]
    return tree.detach()


def tree_grads(tree, prefix="", whole=lambda g: g):
    """{path: gradient on the host} of a tree of leaves after backward();
    `whole` makes a DTensor's gradient whole first."""
    if isinstance(tree, dict):
        return {k: g for key, v in tree.items()
                for k, g in tree_grads(v, f"{prefix}{key}/", whole).items()}
    if isinstance(tree, list):
        return {k: g for i, v in enumerate(tree)
                for k, g in tree_grads(v, f"{prefix}{i}/", whole).items()}
    return {prefix[:-1]: whole(tree.grad.detach()).cpu()}


def grad_error(got, want):
    """(error, leaf) of the worst leaf by max|Δ| / max(the leaf's max |want|,
    1e-3 × the tree's largest |want|): the CPU tests' rule
    (tests/test_torch_port_train.py), a floor for the leaf whose exact
    gradient is 0."""
    floor = 1e-3 * max(float(g.abs().max()) for g in want.values())
    return max((float((got[k] - w).abs().max()) / max(float(w.abs().max()), floor), k)
               for k, w in want.items())


def run_training(device, card, cfg, params_np):
    """CTC training on the card. (t1) wav2vec2-base, 32 x 10 s, bf16
    compute over f32 weights, AdamW (lr `TRAIN_LR`): 2 warm-up and 8 timed
    steps on one batch, every loss finite and the last below the first. (t2) the tiny
    tone task, 120 f32 steps (loss below a fifth of its first), then
    `BatchAligner` on the trained weights recovers every word in order.
    (t3) one f32 step of a 2-layer wav2vec2-base on the card against the
    same step on the host CPU: gradients within 1e-4 (relative, as the CPU
    tests hold them to JAX's), and no K5 even with WAV2VEC2_FLASH_FORCE=1.
    (t4) save_params / restore_params round-trip t2's tree bit-exact, and an
    aligner on the restored tree gives the same words. Returns the launch
    counts."""
    import dataclasses

    import torch

    from wav2vec2_tpu_torch.config import Wav2Vec2ModelConfig
    from wav2vec2_tpu_torch.models.ctc_model import frame_lengths, wav2vec2_forward
    from wav2vec2_tpu_torch.models.params import params_from_jax
    from wav2vec2_tpu_torch.ops import flash_attention as fa
    from wav2vec2_tpu_torch.parallel import train
    from wav2vec2_tpu_torch.parallel.batching import BatchAligner
    from wav2vec2_tpu_torch.utils.checkpoint import restore_params, save_params

    totals: dict[str, int] = {}
    # --- (t1) ------------------------------------------------------------
    rng = np.random.default_rng(21)
    n = int(TRAIN_SECONDS * SAMPLE_RATE)
    label_lens = rng.integers(80, 121, size=TRAIN_BATCH).astype(np.int32)
    labels = rng.integers(5, cfg.vocab_size, size=(TRAIN_BATCH, 120)).astype(np.int32)
    batch = [torch.from_numpy(a).to(device) for a in (
        rng.normal(size=(TRAIN_BATCH, n)).astype(np.float32),
        np.full(TRAIN_BATCH, n, np.int32), labels, label_lens)]
    state = train.init_train_state(params_from_jax(params_np, device=device),
                                   train.make_optimizer(learning_rate=TRAIN_LR))
    step = train.make_train_step(cfg, None, compute_dtype=torch.bfloat16)
    losses, step_ms = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    for i in range(2 + TRAIN_TIMED_STEPS):
        t0 = time.perf_counter()
        (state, loss), counts = counted(lambda: step(state, *batch))
        losses.append(float(loss))
        if i >= 2:
            step_ms.append((time.perf_counter() - t0) * 1e3)
        _add_counts(totals, counts)
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"gate (t1): losses {losses}")
    # forward and backward alone, CUDA events (the step's own code, no update)
    fwd_ms, bwd_ms = [], []
    t_lens = frame_lengths(cfg, batch[1])
    for _ in range(3):
        state.opt_state.zero_grad(set_to_none=True)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        logits = wav2vec2_forward(state.params, batch[0], cfg, audio_lens=batch[1],
                                  compute_dtype=torch.bfloat16)
        loss = train.ctc_loss_from_logits(logits, t_lens, batch[2], batch[3], cfg.pad_token_id)
        ev[1].record()
        loss.backward()
        ev[2].record()
        ev[2].synchronize()
        fwd_ms.append(ev[0].elapsed_time(ev[1]))
        bwd_ms.append(ev[1].elapsed_time(ev[2]))
    state.opt_state.zero_grad(set_to_none=True)
    del logits, loss
    med = statistics.median(step_ms)
    print(f"time: train step wav2vec2-base bf16 (f32 weights, AdamW lr {TRAIN_LR:g}) at {TRAIN_BATCH} x "
          f"{TRAIN_SECONDS:g} s: median {med:.1f} ms (min {min(step_ms):.1f}, max "
          f"{max(step_ms):.1f}, {TRAIN_TIMED_STEPS} steps, host clock to the loss); forward "
          f"{statistics.median(fwd_ms):.1f} ms, backward {statistics.median(bwd_ms):.1f} ms "
          f"(CUDA events, median of 3); {TRAIN_BATCH * TRAIN_SECONDS / (med / 1e3):.1f} "
          f"training audio-seconds per second; peak device memory {peak_gb:.2f} GB {card}")
    print(f"train: gate (t1) losses {[round(x, 3) for x in losses]}: finite, last < first")
    del state, step, batch

    # --- (t2) and (t4) ---------------------------------------------------
    tone_cfg = Wav2Vec2ModelConfig.from_dict(TONE_CONFIG)
    from wav2vec2_tpu_torch.models.params import init_params

    task = ToneTask(0)
    state = train.init_train_state(params_from_jax(init_params(tone_cfg, 0), device=device),
                                   train.make_optimizer(learning_rate=2e-3))
    step = train.make_train_step(tone_cfg, None, compute_dtype=torch.float32)
    t0 = time.perf_counter()
    first = None
    for _ in range(120):
        tensors, _ = task.make_batch(8)
        (state, loss), counts = counted(lambda: step(state, *tensors))
        _add_counts(totals, counts)
        first = float(loss) if first is None else first
    last = float(loss)
    train_s = time.perf_counter() - t0
    if not last < first / 5:
        raise AssertionError(f"gate (t2): CTC training went from {first:.3f} to {last:.3f}")
    trained = detach_tree(state.params)
    with tempfile.TemporaryDirectory() as tmp:
        save_params(Path(tmp) / "ckpt", trained)
        restored = restore_params(Path(tmp) / "ckpt", like=trained)
    for a, b in zip(tree_leaves(trained), tree_leaves(restored)):
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError("gate (t4): the restored tree differs from the trained one")
    outs = {}
    for name, tree in (("trained", trained), ("restored", restored)):
        aligner = BatchAligner(tone_cfg, tree, TONE_VOCAB, compute_dtype="float32",
                               device=device)
        probe = ToneTask(1)
        results = []
        for _ in range(5):
            (audio, a_l, _, _), words = probe.make_batch(1)
            out, counts = counted(lambda: aligner.align_utterances(
                [audio[0, : a_l[0]]], [words[0]], audio_multiple=TONE_N_PAD,
                token_multiple=16)[0])
            _add_counts(totals, counts)
            t_pad = tone_cfg.conv_output_length(TONE_N_PAD)
            if sum(counts[t] for t in ("k1", "k2", "k3", "k4")) < 1:
                raise AssertionError(f"gate (t2): no Viterbi kernel launched: {counts}")
            check_words(out.words, words[0].split(), f"gate (t2), {name} weights")
            results.append(word_tuples_ms(out.words))
        outs[name] = (results, counts)
    if outs["trained"][0] != outs["restored"][0]:
        raise AssertionError("gate (t4): the restored tree aligns other words or times")
    print(f"train: gate (t2) tone task loss {first:.3f} -> {last:.3f} in 120 f32 steps "
          f"({train_s:.1f} s, {train_s / 120 * 1e3:.1f} ms a step with its host batch), 5 "
          f"utterances aligned word for word (T_pad {t_pad}: DP launches "
          f"{outs['trained'][1]}); gate (t4) save/restore bit-exact, the same words and ms")
    del state, step, trained, restored

    # --- (t3) ------------------------------------------------------------
    cfg2 = dataclasses.replace(cfg, num_hidden_layers=2, use_flash_attention=True)
    tree2 = first_layers(params_np, 2)
    rng = np.random.default_rng(23)
    batch2 = (rng.normal(size=(2, 2 * SAMPLE_RATE)).astype(np.float32),
              np.asarray([2 * SAMPLE_RATE, 30000], np.int32),
              rng.integers(5, cfg.vocab_size, size=(2, 30)).astype(np.int32),
              np.asarray([30, 22], np.int32))
    grads, t3_losses = {}, {}
    os.environ[fa.FORCE_ENV] = "1"
    try:
        for where in ("cuda", "cpu"):
            dev = device if where == "cuda" else torch.device("cpu")
            st = train.init_train_state(params_from_jax(tree2, device=dev), train.make_optimizer())
            (st, loss), counts = counted(lambda: train.make_train_step(
                cfg2, None, compute_dtype=torch.float32)(st, *batch2))
            _add_counts(totals, counts)
            if counts["k5"]:
                raise AssertionError(f"gate (t3): the train step launched K5: {counts}")
            t3_losses[where] = float(loss)
            grads[where] = tree_grads(st.params)
    finally:
        del os.environ[fa.FORCE_ENV]
    err, worst = grad_error(grads["cuda"], grads["cpu"])
    loss_err = abs(t3_losses["cuda"] - t3_losses["cpu"]) / abs(t3_losses["cpu"])
    if not (err <= 1e-4 and loss_err <= 1e-5):
        raise AssertionError(f"gate (t3): card vs CPU gradients {err:.3g} at {worst} (bound "
                             f"1e-4), loss {loss_err:.3g} (bound 1e-5)")
    print(f"train: gate (t3) one f32 step of a 2-layer wav2vec2-base, card vs host CPU: "
          f"loss {loss_err:.3g} relative, gradients {err:.3g} at worst ({worst}; bound "
          f"1e-4), no K5 under "
          f"{fa.FORCE_ENV}=1")
    return totals


# --- the device mesh ------------------------------------------------------
MESH_BATCH, MESH_SECONDS = 8, 10.0  # (m2)'s batch path, base and conformer
MESH_TRAIN_ROWS, MESH_TRAIN_SECONDS = 4, 4.0  # (m2)'s train step
MESH_LONGFORM_MINUTES = 3.0
MESH_RANKS = 2
MESH_CHILD_TIMEOUT_S = 420


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def synced_ms(fn):
    """(fn(), wall ms) with the card synchronised on both sides."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def submit_and_group(aligner, seqs, inputs):
    """One padded batch through `aligner`: (handles, words per row)."""
    handles = aligner.submit_padded_batch(*inputs, return_log_probs=True)
    return handles, [word_tuples_ms(o.words) for o in aligner.group_batch(seqs, handles)]


def run_mesh_m1(device, card, cfg, params_np, vocab):
    """(m1) A world of one rank under NCCL and the mesh (1×1), wav2vec2-base
    at full width and depth: `BatchAligner(mesh=)` on 32 × 10 s bf16 against
    `mesh=None`, paths and log-probs bit-equal, words and ms equal, both
    timed (submit and group, 3 repeats); `make_train_step(mesh=)` on 32 ×
    10 s bf16 beside the unsharded step from the same weights, both timed,
    both losses printed (finite, within 1e-3 relative). Returns the launch
    counts of the mesh runs."""
    import torch
    import torch.distributed as dist

    from wav2vec2_tpu_torch.models.params import params_from_jax
    from wav2vec2_tpu_torch.parallel import mesh as pmesh
    from wav2vec2_tpu_torch.parallel import train
    from wav2vec2_tpu_torch.parallel.batching import BatchAligner

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                            world_size=1)
    totals: dict[str, int] = {}
    try:
        mesh = pmesh.make_mesh(model=1, device="cuda")
        seqs, audio, a_l, tokens, s_l = batch_inputs(np.random.default_rng(0), vocab, 32, 10.0)
        inputs = [torch.from_numpy(a).to(device) for a in (audio, a_l, tokens, s_l)]
        aligners = {
            "mesh=None": BatchAligner(cfg, params_from_jax(params_np, device=device), vocab,
                                      "bfloat16", device=device, normalize_on_device=True),
            "mesh (1x1)": BatchAligner(cfg, params_from_jax(params_np, device=device), vocab,
                                       "bfloat16", device=device, normalize_on_device=True,
                                       mesh=mesh),
        }
        runs, times = {}, {k: [] for k in aligners}
        for name in (*aligners, *reversed(aligners), *aligners):
            (out, counts), ms = synced_ms(lambda: counted(
                lambda: submit_and_group(aligners[name], seqs, inputs)))
            runs.setdefault(name, out)
            times[name].append(ms)
            if name != "mesh=None":
                _add_counts(totals, counts)
        (h0, w0), (h1, w1) = runs["mesh=None"], runs["mesh (1x1)"]
        if not (torch.equal(h0[0], h1[0]) and torch.equal(h0[-1], h1[-1]) and w0 == w1):
            raise AssertionError("gate (m1): the (1x1) mesh's paths, log-probs or words differ "
                                 "from mesh=None's")
        if totals.get("k1", 0) < 1:
            raise AssertionError(f"gate (m1): the mesh batch launched {totals}")
        if not torch.equal(h1[0], plain_version("k1", h1[-1].contiguous(), inputs[2], h1[1],
                                                inputs[3])):
            raise AssertionError("gate (m1): the mesh batch's paths are not K1's plain version")
        t_none, t_mesh = (statistics.median(times[k]) for k in aligners)
        print(f"mesh (m1): BatchAligner(mesh=(1x1)) under NCCL, 32 x 10 s bf16: paths and "
              f"log-probs bit-equal to mesh=None, words and ms equal, paths == K1's plain "
              f"version; submit + group "
              f"{t_mesh:.1f} ms vs {t_none:.1f} ms (median of 3, host clock, synchronised): "
              f"the mesh path's overhead {t_mesh - t_none:+.1f} ms "
              f"({(t_mesh / t_none - 1) * 100:+.1f}%) {card}")
        del aligners, runs, h0, h1

        rng = np.random.default_rng(21)
        n = int(TRAIN_SECONDS * SAMPLE_RATE)
        batch = (rng.normal(size=(TRAIN_BATCH, n)).astype(np.float32),
                 np.full(TRAIN_BATCH, n, np.int32),
                 rng.integers(5, cfg.vocab_size, size=(TRAIN_BATCH, 120)).astype(np.int32),
                 rng.integers(80, 121, size=TRAIN_BATCH).astype(np.int32))
        losses, step_ms = {}, {}
        for name in ("unsharded", "mesh (1x1)"):
            sharded = name != "unsharded"
            tree = params_from_jax(params_np, device=device)
            state = train.init_train_state(pmesh.shard_params(tree, mesh) if sharded else tree,
                                           train.make_optimizer(learning_rate=TRAIN_LR))
            step = train.make_train_step(cfg, None, mesh=mesh if sharded else None,
                                         compute_dtype=torch.bfloat16)
            args = (pmesh.distribute_rows(mesh, *batch) if sharded else
                    [torch.from_numpy(a).to(device) for a in batch])
            ms, vals = [], []
            for _ in range(3):
                ((state, loss), counts), t = synced_ms(lambda: counted(
                    lambda: step(state, *args)))
                vals.append(float(pmesh.full(loss)))
                ms.append(t)
                if counts["k5"]:
                    raise AssertionError(f"gate (m1): a train step launched K5: {counts}")
            losses[name], step_ms[name] = vals, ms
            del state, step, tree, args
        first = [losses[k][0] for k in losses]
        if not (np.isfinite(sum(losses.values(), [])).all()
                and abs(first[1] - first[0]) <= 1e-3 * abs(first[0])):
            raise AssertionError(f"gate (m1): train losses {losses}")
        print(f"mesh (m1): make_train_step(mesh=(1x1)) 32 x 10 s bf16: losses "
              f"{[round(x, 4) for x in losses['mesh (1x1)']]} vs unsharded "
              f"{[round(x, 4) for x in losses['unsharded']]}; step "
              f"{statistics.median(step_ms['mesh (1x1)'][1:]):.1f} ms vs "
              f"{statistics.median(step_ms['unsharded'][1:]):.1f} ms (host clock, steps 2-3) "
              f"{card}")
    finally:
        dist.destroy_process_group()
    return totals


def mesh_rank(rank: int, world: int, tmp: str):
    """One rank of (m2): gloo on the one card, the phases of `mesh_phases`;
    what it got goes to `tmp`/rank<r>.json."""
    import traceback

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                            world_size=world)
    try:
        result = mesh_phases(rank)
    except Exception:  # the parent reads it and fails the smoke
        result = {"error": traceback.format_exc()}
    with open(Path(tmp) / f"rank{rank}.json", "w") as f:
        json.dump(result, f)
    dist.destroy_process_group()


def _k5_tiles():
    """Wrap K5's launch to record each launch's q shape and keep the first
    launch's inputs; returns (shapes, first inputs, undo)."""
    from wav2vec2_tpu_torch.ops import flash_attention as fa

    shapes, first, real = [], [], fa._launch

    def launch(q, k, v, mask, q_pos, rel_r, scale):
        shapes.append(tuple(q.shape))
        if not first:
            first.append((q, k, v, mask, q_pos, rel_r, scale))
        return real(q, k, v, mask, q_pos, rel_r, scale)

    fa._launch = launch
    return shapes, first, lambda: setattr(fa, "_launch", real)


def mesh_phases(rank: int) -> dict:
    """(m2) on this rank: the batch path (wav2vec2-base f32 at (2×1), int8
    serving of it at (1×2), the conformer rel-pos large f32 with K5 at
    (2×1) and (1×2)), `align_longform`
    at (2×1) and `make_train_step` at (2×1) and (1×2), each against the
    unsharded run on this rank, with its launch counts, times and each
    kernel held against its plain version."""
    import torch
    from torch.distributed.tensor.debug import CommDebugMode

    from wav2vec2_tpu_torch import align_longform
    from wav2vec2_tpu_torch.align import longform
    from wav2vec2_tpu_torch.align.tokenization import build_token_sequence_case_aware
    from wav2vec2_tpu_torch.config import Wav2Vec2ModelConfig
    from wav2vec2_tpu_torch.models.params import init_params, params_from_jax
    from wav2vec2_tpu_torch.ops import flash_attention as fa
    from wav2vec2_tpu_torch.ops import flash_attention_ref, viterbi_cuda
    from wav2vec2_tpu_torch.parallel import mesh as pmesh
    from wav2vec2_tpu_torch.parallel import train
    from wav2vec2_tpu_torch.parallel.batching import BatchAligner

    device = torch.device("cuda", 0)
    vocab = make_vocab()
    meshes = {"2x1": pmesh.make_mesh(model=1, device="cuda"),
              "1x2": pmesh.make_mesh(model=2, device="cuda")}
    out: dict = {"counts": {}, "max_err": {}, "lines": []}

    def count(name, counts):
        out["counts"][name] = counts

    # --- the batch path, wav2vec2-base f32 at (2x1) -----------------------
    cfg = Wav2Vec2ModelConfig.from_dict(BASE_CONFIG)
    params_np = init_params(cfg, seed=0)
    seqs, audio, a_l, tokens, s_l = batch_inputs(np.random.default_rng(0), vocab, MESH_BATCH,
                                                 MESH_SECONDS)
    inputs = [torch.from_numpy(a).to(device) for a in (audio, a_l, tokens, s_l)]
    plain = BatchAligner(cfg, params_from_jax(params_np, device=device), vocab, "float32",
                         device=device, normalize_on_device=True)
    submit_and_group(plain, seqs, inputs)  # first call: cuBLAS's and the allocator's set-up
    (ref, ref_words), ref_ms = synced_ms(lambda: submit_and_group(plain, seqs, inputs))
    sharded = BatchAligner(cfg, params_from_jax(params_np, device=device), vocab, "float32",
                           device=device, normalize_on_device=True, mesh=meshes["2x1"])
    submit_and_group(sharded, seqs, inputs)  # first call: DTensor's rule caches
    ((got, words), counts), ms = synced_ms(lambda: counted(
        lambda: submit_and_group(sharded, seqs, inputs)))
    lp_err = float((got[-1] - ref[-1]).abs().max())
    if not (torch.equal(got[0], ref[0]) and words == ref_words and lp_err <= 1e-4):
        raise AssertionError(f"gate (m2) base (2x1): paths equal {torch.equal(got[0], ref[0])}, "
                             f"words equal {words == ref_words}, log-probs {lp_err:.3g} "
                             "(bound 1e-4)")
    k1 = viterbi_cuda.viterbi_batch(got[-1].contiguous(), inputs[2], got[1], inputs[3], tier="k1")
    if not torch.equal(k1, plain_version("k1", got[-1].contiguous(), inputs[2], got[1],
                                         inputs[3])) or counts["k1"] < 1:
        raise AssertionError(f"gate (m2) base (2x1): K1 vs its plain version, launches {counts}")
    out["max_err"]["k1"] = 0.0
    count("base (2x1)", counts)
    out["lines"].append(
        f"base f32 (2x1), {MESH_BATCH} x {MESH_SECONDS:g} s: paths equal, words and ms equal, "
        f"log-probs {lp_err:.3g} from the unsharded run; K1 == its plain version; this "
        f"rank's launches {counts}; submit + group {ms:.1f} ms vs unsharded {ref_ms:.1f} ms")
    del plain, sharded, ref, got

    # --- int8 serving at (1x2), base f32: the int32 partial sums ----------
    plain = BatchAligner(cfg, params_from_jax(params_np, device=device), vocab, "float32",
                         device=device, normalize_on_device=True, quantize_int8=True)
    submit_and_group(plain, seqs, inputs)
    (ref, ref_words), ref_ms = synced_ms(lambda: submit_and_group(plain, seqs, inputs))
    sharded = BatchAligner(cfg, pmesh.shard_params(params_np, meshes["1x2"]), vocab, "float32",
                           device=device, normalize_on_device=True, quantize_int8=True,
                           mesh=meshes["1x2"])
    submit_and_group(sharded, seqs, inputs)
    comm = CommDebugMode()
    with comm:
        ((got, words), counts), ms = synced_ms(lambda: counted(
            lambda: submit_and_group(sharded, seqs, inputs)))
    lp_err = float((got[-1] - ref[-1]).abs().max())
    lp_got = got[-1].contiguous()
    if not torch.equal(got[0], plain_version("k1", lp_got, inputs[2], got[1], inputs[3])):
        raise AssertionError("gate (m2) int8 (1x2): the sharded paths are not K1's plain "
                             "version on the sharded log-probs")
    agree = tie_agreement(got, ref, inputs[2], words, ref_words)
    if not (lp_err <= 1e-4 and agree["ok"] and counts["k1"] >= 1):
        raise AssertionError(f"gate (m2) int8 (1x2): log-probs {lp_err:.3g} (bound 1e-4), "
                             f"{agree}, launches {counts}")
    count("int8 (1x2)", counts)
    comms = {str(c).split(".")[-1]: n for c, n in comm.get_comm_counts().items()}
    out["lines"].append(
        f"int8 base f32 (1x2), {MESH_BATCH} x {MESH_SECONDS:g} s: log-probs {lp_err:.3g} from "
        f"the unsharded int8 run; paths == K1's plain version; {agree['text']}; DTensor "
        f"collectives {comms}; submit + group {ms:.1f} ms vs unsharded {ref_ms:.1f} ms")
    del plain, sharded, ref, got

    # --- the conformer rel-pos large f32 with K5 at (2x1) and (1x2) -------
    ccfg = Wav2Vec2ModelConfig.from_dict(CONFORMER_CONFIG)
    cnp = conformer_params(ccfg, seed=10)
    plain = BatchAligner(ccfg, params_from_jax(cnp, device=device), vocab, "float32",
                         device=device, normalize_on_device=True, use_flash_attention=True)
    submit_and_group(plain, seqs, inputs)
    (ref, ref_words), ref_ms = synced_ms(lambda: submit_and_group(plain, seqs, inputs))
    del plain
    nh, hd = ccfg.num_attention_heads, ccfg.hidden_size // ccfg.num_attention_heads
    t_pad = 512
    want_tile = {"2x1": (MESH_BATCH // MESH_RANKS, nh, t_pad, hd),
                 "1x2": (MESH_BATCH, nh // MESH_RANKS, t_pad, hd)}
    for key, mesh in meshes.items():
        tree = params_from_jax(cnp, device=device)
        params = pmesh.shard_params(tree, mesh) if key == "1x2" else tree
        sharded = BatchAligner(ccfg, params, vocab, "float32", device=device,
                               normalize_on_device=True, use_flash_attention=True, mesh=mesh)
        submit_and_group(sharded, seqs, inputs)
        shapes, first, undo = _k5_tiles()
        comm = CommDebugMode()
        try:
            with comm:
                ((got, words), counts), ms = synced_ms(lambda: counted(
                    lambda: submit_and_group(sharded, seqs, inputs)))
        finally:
            undo()
        lp_err = float((got[-1] - ref[-1]).abs().max())
        if counts["k5"] != ccfg.num_hidden_layers or set(shapes) != {want_tile[key]}:
            raise AssertionError(f"gate (m2) conformer ({key}): K5 launched {counts['k5']} "
                                 f"times on tiles {set(shapes)}; want "
                                 f"{ccfg.num_hidden_layers} on {want_tile[key]}")
        lp_got = got[-1].contiguous()
        k1 = viterbi_cuda.viterbi_batch(lp_got, inputs[2], got[1], inputs[3], tier="k1")
        if not (torch.equal(k1, got[0]) and torch.equal(
                k1, plain_version("k1", lp_got, inputs[2], got[1], inputs[3]))):
            raise AssertionError(f"gate (m2) conformer ({key}): the sharded paths are not "
                                 "K1's plain version on the sharded log-probs")
        agree = tie_agreement(got, ref, inputs[2], words, ref_words)
        if not (lp_err <= 1e-3 and agree["ok"]):
            raise AssertionError(f"gate (m2) conformer ({key}): log-probs {lp_err:.3g} (bound "
                                 f"1e-3), {agree}")
        q, k, v, mask, q_pos, rel_r, scale = first[0]
        with torch.no_grad():
            kern = fa._launch(q, k, v, mask, q_pos, rel_r, scale)
            want = flash_attention_ref.attention(q, k, v, mask, q_pos=q_pos, rel_r=rel_r,
                                                 scale=scale)
        k5_err = float((kern - want).abs().max()) / float(want.abs().max())
        if k5_err > FLASH_REL_BOUND["float32"]:
            raise AssertionError(f"gate (m2) conformer ({key}): K5 on a local tile vs its plain "
                                 f"version {k5_err:.3g}")
        out["max_err"]["k5"] = max(out["max_err"].get("k5", 0.0), k5_err)
        count(f"conformer ({key})", counts)
        comms = {str(c).split(".")[-1]: n for c, n in comm.get_comm_counts().items()}
        out["lines"].append(
            f"conformer rel-pos large f32 ({key}), {MESH_BATCH} x {MESH_SECONDS:g} s: K5 "
            f"{counts['k5']} launches on this rank, each on a {want_tile[key]} tile, vs its "
            f"plain version {k5_err:.3g} relative; log-probs {lp_err:.3g} from the unsharded "
            f"K5 forward; paths == K1's plain version; {agree['text']}; DTensor collectives "
            f"{comms}; submit + group {ms:.1f} ms vs unsharded {ref_ms:.1f} ms")
        del sharded, params, tree, got
    del ref

    # --- align_longform at (2x1), 3 min of wav2vec2-base f32 --------------
    rng = np.random.default_rng(4)
    la = rng.normal(size=int(MESH_LONGFORM_MINUTES * 60 * SAMPLE_RATE)).astype(np.float32)
    text = " ".join(LONGFORM_WORDS * int(MESH_LONGFORM_MINUTES * 15))
    base = params_from_jax(params_np, device=device)
    want, ref_ms = synced_ms(lambda: align_longform(la, text, base, cfg, vocab,
                                                    compute_dtype="float32", device=device))
    (got, counts), ms = synced_ms(lambda: counted(lambda: align_longform(
        la, text, base, cfg, vocab, compute_dtype="float32", device=device,
        mesh=meshes["2x1"])))
    if word_tuples_ms(got.words) != word_tuples_ms(want.words):
        raise AssertionError("gate (m2) long-form (2x1): words or ms differ from mesh=None's")
    seq = build_token_sequence_case_aware(text, vocab, 0, vocab.get("|", 0))
    with torch.inference_mode(False), torch.no_grad():
        spans, chunks = longform.sharded_chunk_log_probs(
            longform.normalize_audio(la), pmesh.place_params(base, meshes["2x1"]), cfg,
            30 * SAMPLE_RATE, 5 * SAMPLE_RATE, torch.float32, 32, meshes["2x1"])
    lp = longform.stitch_log_probs(chunks, spans, cfg.frame_stride_samples(),
                                   cfg.conv_output_length(len(la)))
    s_pad = -(-len(seq.tokens) // longform.TOKEN_MULTIPLE) * longform.TOKEN_MULTIPLE
    tier = viterbi_cuda.select_tier(lp.shape[0], s_pad, lp.shape[1])
    if counts[tier] != 1:
        raise AssertionError(f"gate (m2) long-form: the DP took {tier}, launches {counts}")
    tok = np.zeros(s_pad, np.int32)
    tok[: len(seq.tokens)] = seq.tokens
    args = (torch.from_numpy(lp)[None].to(device), torch.from_numpy(tok)[None].to(device),
            torch.tensor([lp.shape[0]], dtype=torch.int32, device=device),
            torch.tensor([len(seq.tokens)], dtype=torch.int32, device=device))
    if not torch.equal(viterbi_cuda.viterbi_batch(*args, tier=tier), plain_version(tier, *args)):
        raise AssertionError(f"gate (m2) long-form: {tier} vs its plain version")
    out["max_err"][tier] = 0.0
    count("long-form (2x1)", counts)
    out["lines"].append(
        f"align_longform (2x1), {MESH_LONGFORM_MINUTES:g} min f32, {len(got.words)} words: "
        f"words and ms equal mesh=None's; the DP took {tier} (T={lp.shape[0]}, S_pad={s_pad}), "
        f"== its plain version; {ms / 1e3:.2f} s vs mesh=None {ref_ms / 1e3:.2f} s")
    del base

    # --- make_train_step at (2x1) and (1x2), base f32 4 x 4 s -------------
    rng = np.random.default_rng(23)
    n = int(MESH_TRAIN_SECONDS * SAMPLE_RATE)
    batch = (rng.normal(size=(MESH_TRAIN_ROWS, n)).astype(np.float32),
             np.full(MESH_TRAIN_ROWS, n, np.int32),
             rng.integers(5, cfg.vocab_size, size=(MESH_TRAIN_ROWS, 40)).astype(np.int32),
             np.full(MESH_TRAIN_ROWS, 40, np.int32))
    cfg_t = Wav2Vec2ModelConfig.from_dict({**BASE_CONFIG})
    state = train.init_train_state(params_from_jax(params_np, device=device),
                                   train.make_optimizer())
    step = train.make_train_step(cfg_t, None, compute_dtype=torch.float32)
    state, loss = step(state, *batch)
    ref_loss, ref_grads = float(loss), tree_grads(state.params)
    _, ref_ms = synced_ms(lambda: step(state, *batch))  # the second step, timed
    del state
    for key, mesh in meshes.items():
        state = train.init_train_state(pmesh.shard_params(params_np, mesh),
                                       train.make_optimizer())
        step = train.make_train_step(cfg_t, None, mesh=mesh, compute_dtype=torch.float32)
        comm = CommDebugMode()
        with comm:
            (state, loss), counts = counted(lambda: step(state, *batch))
        got_loss = float(pmesh.full(loss))
        grads = tree_grads(state.params, whole=pmesh.full)
        (_, again), ms = synced_ms(lambda: counted(lambda: step(state, *batch)))
        counts = {k: n + again[k] for k, n in counts.items()}
        err, worst = grad_error(grads, ref_grads)
        loss_err = abs(got_loss - ref_loss) / abs(ref_loss)
        if not (loss_err <= 1e-5 and err <= 1e-4 and counts["k5"] == 0 and state.step == 1):
            raise AssertionError(f"gate (m2) train ({key}): loss {loss_err:.3g} (bound 1e-5), "
                                 f"gradients {err:.3g} at {worst} (bound 1e-4), launches "
                                 f"{counts}")
        count(f"train ({key})", counts)
        comms = {str(c).split(".")[-1]: n for c, n in comm.get_comm_counts().items()}
        out["lines"].append(
            f"make_train_step ({key}), base f32 {MESH_TRAIN_ROWS} x {MESH_TRAIN_SECONDS:g} s: "
            f"loss {got_loss:.5f} vs {ref_loss:.5f} ({loss_err:.2g} relative), gradients "
            f"{err:.3g} at worst ({worst}), no K5; DTensor collectives {comms}; step "
            f"{ms:.0f} ms vs unsharded {ref_ms:.0f} ms (host clock, the second step)")
        del state
    return out


def tie_agreement(got, ref, tokens, words, ref_words) -> dict:
    """The sharded batch's alignment against the unsharded one's where
    their log-probs differ by f32 rounding (the sum over heads split over
    'model' adds in another order): the word sequences must be equal, and
    every row whose path differs must be a tie, its path scoring on the
    unsharded log-probs within the bound the difference allows of the
    unsharded (optimal) path's. Exactly: if |Δ| <= e_t at frame t, each
    path's score moves by at most Σ e_t, so the sharded optimum loses at
    most 2·Σ e_t on the unsharded log-probs; the f32 sums of the DP add at
    most 2·T·2⁻²⁴·|score|. Returns {"ok", "text"} with the rows whose paths
    differ, the worst gap against its bound and the boundaries' agreement
    (exact, within one frame)."""
    import torch

    paths, t_lens = got[0].long(), got[1]
    lp_ref, lp_got = ref[-1].double(), got[-1].double()
    tok = tokens.long()
    same_words = [[w[0] for w in a] for a in words] == [[w[0] for w in a] for a in ref_words]
    ok = same_words
    differ, worst = [], None
    for j in range(paths.shape[0]):
        t = int(t_lens[j])
        if torch.equal(paths[j, :t], ref[0][j, :t].long()):
            continue
        frames = torch.arange(t, device=paths.device)

        def score(path, lp=lp_ref[j]):
            return float(lp[frames, tok[j, path[:t]]].sum())

        best = score(ref[0][j].long())
        gap = best - score(paths[j])
        bound = (2 * float((lp_got[j, :t] - lp_ref[j, :t]).abs().amax(-1).sum())
                 + 2 * t * 2.0 ** -24 * abs(best))
        differ.append(j)
        worst = max(worst or (gap, bound), (gap, bound), key=lambda x: x[0] - x[1])
        ok = ok and gap <= bound
    pairs = [(a, b) for row, ref_row in zip(words, ref_words) for a, b in zip(row, ref_row)]
    exact = sum(a == b for a, b in pairs)
    within = sum(max(abs(a[1] - b[1]), abs(a[2] - b[2])) <= 20 for a, b in pairs)
    text = (f"word sequences {'equal' if same_words else 'DIFFER'}; rows whose path differs {differ}"
            + (f" (worst score gap {worst[0]:.3g} on the unsharded log-probs, bound "
               f"{worst[1]:.3g}: ties)" if differ else "")
            + f"; boundaries {exact}/{len(pairs)} exact, {within}/{len(pairs)} within one frame")
    return {"ok": ok, "text": text}


def run_mesh_m2(card):
    """(m2) Two processes on the one card under gloo (CUDA tensors), each a
    rank of meshes (2×1) and (1×2), running `mesh_phases`; a child that
    fails, exits non-zero or outlives MESH_CHILD_TIMEOUT_S fails the smoke
    (every child is stopped). Returns (launch counts summed over the ranks,
    max error per kernel)."""
    import multiprocessing

    import torch

    torch.cuda.empty_cache()
    ctx = multiprocessing.get_context("spawn")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=mesh_rank, args=(r, MESH_RANKS, tmp))
                 for r in range(MESH_RANKS)]
        for p in procs:
            p.start()
        try:
            deadline = time.monotonic() + MESH_CHILD_TIMEOUT_S
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        codes = [p.exitcode for p in procs]
        results = []
        for r in range(MESH_RANKS):
            path = Path(tmp) / f"rank{r}.json"
            results.append(json.loads(path.read_text()) if path.exists() else None)
    if codes != [0] * MESH_RANKS or any(r is None or "error" in r for r in results):
        errors = [r.get("error") if r else "no result" for r in results]
        raise AssertionError(f"gate (m2): the ranks exited {codes}: {errors}")
    totals: dict[str, int] = {}
    max_err: dict[str, float] = {}
    for r, res in enumerate(results):
        for phase, counts in res["counts"].items():
            _add_counts(totals, counts)
        for k, e in res["max_err"].items():
            max_err[k] = max(max_err.get(k, 0.0), e)
        for line in res["lines"]:
            print(f"mesh (m2) rank {r}: {line} {card}")
    print(f"mesh (m2): {MESH_RANKS} ranks under gloo on one card, "
          f"{time.perf_counter() - t0:.1f} s with the ranks' start; launches over the ranks "
          f"{totals}")
    return totals, max_err


def tree_leaves(tree):
    """The tensors of a parameter tree."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _add_counts(totals, counts):
    for k, n in counts.items():
        totals[k] = totals.get(k, 0) + n


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
    sass = k5_sass(info["library"])
    for dtype, (kernel, _) in K5_SASS_KERNELS.items():
        c = sass[dtype]
        print(f"sass: the {dtype} K5 kernel ({kernel}, {c['functions']} instantiations): "
              + ", ".join(f"{op} {c[op]}" for op in K5_SASS_OPS)
              + " instructions (cuobjdump -sass)")
    check_k5_sass(sass)
    for lib in native_build.SOURCES:
        t0 = time.perf_counter()
        path = native_build.build(lib, force=True)
        print(f"build: {native_build.SOURCES[lib].name} -> {path} in "
              f"{time.perf_counter() - t0:.3f} s (g++ {' '.join(native_build.CXX_FLAGS)})")

    for shape in ((499, 256, 32), (3047, 128, 32), (37, 61, 397), (HOUR_FRAMES, 12_672, 392),
                  (2400, 4100, 32), (512, 4096, 32), (1000, 16_388, 32), (5000, 3700, 8000),
                  (1499, 768, 32), (601, 61, 29), (499, 256, 392), (2400, 256, 32), (64, 128, 8),
                  (12_000, 20_480, 32), (20_000, 40_064, 32), (60_000, 24_064, 32),
                  (HOUR_FRAMES, 99_072, 32), (HOUR_FRAMES, 86_400, 392), (100, 131_072, 32)):
        for tier in viterbi_cuda.TIERS:
            if viterbi_cuda.library_smem_bytes(tier, *shape) != viterbi_cuda.smem_bytes(tier, *shape):
                raise AssertionError(f"{tier} at {shape}: the wrapper's shared-memory size "
                                     "differs from the kernel's")
        if viterbi_cuda.library_k1_mode(*shape) != viterbi_cuda.k1_mode(*shape):
            raise AssertionError(f"k1 at {shape}: the wrapper's mode differs from the kernel's")
    # K4's cluster rule (blocks, strips, threads, slices) as the launcher has it
    for s_pad in (61, 128, 1024, 4100, 16_384, 16_388, 20_480, 24_064, 40_064, 86_400, 99_072,
                  131_072, 131_076):
        for cluster in range(viterbi_cuda.MAX_CLUSTER + 2):
            want = (*viterbi_cuda.cluster_shape(s_pad, cluster),
                    viterbi_cuda.cluster_slices(s_pad, cluster))
            if viterbi_cuda.library_cluster(s_pad, cluster) != want:
                raise AssertionError(f"k4 at S_pad={s_pad} on {cluster} blocks: the wrapper's "
                                     f"cluster {want} differs from the launcher's "
                                     f"{viterbi_cuda.library_cluster(s_pad, cluster)}")
    print("shape rules: shared-memory sizes, K1's modes and K4's clusters (blocks, strips, "
          "threads, slices) equal the compiled launchers'")
    for hd in range(1, fa.HEAD_DIM_CAP + 1):
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
    flash_err = check_flash(device, flash_cases())
    max_err["k5"] = flash_err["bfloat16"]
    max_err["k5_f32"] = max(flash_err["float32"], check_flash_head_dims(device))
    for b, nh in ((4, 16), (8, 8)):  # the (m2) mesh's local conformer tiles
        time_flash_shape(device, card, b, nh, 499, 64, rel=True)
    f32_rows = time_flash_f32(device, card)
    max_err["k5_f32"] = max(max_err["k5_f32"], *(row["err"] for row in f32_rows))
    hour_rows = hour_scale(device, card)
    tier_crossover(device, card, hour_rows)
    max_err["k4_cluster"], w1_rows = check_cluster_w1(device, card)
    w2_rows = cluster_hour_w2(device, card)

    cfg = Wav2Vec2ModelConfig.from_dict(BASE_CONFIG)
    vocab = make_vocab()
    params_np = init_params(cfg, seed=0)
    params = params_from_jax(params_np, device=device)

    # --- the paths, each counted from 0 -----------------------------------
    launches = {name: 0 for name in (*viterbi_cuda.TIERS, "k5", "k1_resident", "k1_device",
                                     "k5_wgmma", "k5_fma")}

    def add(counts, phase, want=None):
        for tier, n in counts.items():
            launches[tier] = launches.get(tier, 0) + n
        if want is not None and counts[want] < 1:
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
    if counts.get("k4_cluster_1", 0) != counts["k4"]:
        raise AssertionError(f"the 10 min long-form ran K4 on a cluster: {counts}")
    max_err["k4"] = max(max_err["k4"], k4_run["err"])
    # (w3) 20 min: 23 999 states, past one block's strips
    counts, w3_run = run_longform(device, cfg, params, vocab, minutes=20.0, card=card)
    add(counts, "the 20 min long-form entry", "k4_cluster_2")
    max_err["k4_cluster"] = max(max_err["k4_cluster"], w3_run["err"])

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
    # --- the serving slice: daemon, online, int8, doctor -----------------
    t_slice = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        write_model_dir(Path(tmp), BASE_CONFIG, params_np, cfg, vocab)
        doctor = subprocess.Popen(
            [sys.executable, "-m", "wav2vec2_tpu_torch.doctor", "--model-dir", tmp],
            cwd=str(Path(__file__).resolve().parent), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        try:
            reset_launches()
            run_serve(device, card, Path(tmp), cfg, vocab)
            counts = read_launches()
            add(counts, "the serving daemon", "k1_resident")
            if counts["k1_device"] or counts["k5"]:
                raise AssertionError(f"gate (s5): the daemon launched {counts}")
            print(f"serve: gate (s5) passed, launches {counts}")
            check_doctor(doctor, name)
        finally:
            if doctor.poll() is None:
                doctor.kill()
                doctor.wait()
    reset_launches()
    run_online(device, card, cfg, params, vocab)
    counts = read_launches()
    add(counts, "the online aligner (wav2vec2-base)")
    add(run_int8(device, card, cfg, params, vocab, aligner), "int8 serving", "k1")
    print(f"time: the serving slice's phases took {time.perf_counter() - t_slice:.1f} s {card}")
    # --- the conformer rel-pos family: K5 on its path --------------------
    del aligner, params, inputs
    counts, k5_run, conformer_np = run_conformer(device, vocab, card)
    add(counts, "the conformer batch entry", "k5")
    max_err["k5"] = max(max_err["k5"], k5_run["err"])
    max_err["k5_f32"] = max(max_err["k5_f32"], k5_run["f32"]["err"])
    counts, k5_online = run_online_conformer(device, card, conformer_np, vocab)
    add(counts, "the conformer online aligner", "k5")
    online_k5_launches = counts["k5"]
    max_err["k5"] = max(max_err["k5"], k5_online["err"])
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
    # --- the wav2vec2-encoder families, K5 forced on plain attention ------
    counts, plain_k5, _ = run_families(device, card, vocab)
    add(counts, "the families phase", "k1")
    if counts.get("k5", 0) < 1:
        raise AssertionError(f"the families phase never launched K5: {counts}")
    # --- the ONNX runtime and CTC training on the card ------------------
    t_slice = time.perf_counter()
    add(run_onnx(device, card, cfg, params_np, vocab), "the ONNX runtime", "k1")
    print(f"time: the ONNX phase took {time.perf_counter() - t_slice:.1f} s {card}")
    t_slice = time.perf_counter()
    add(run_training(device, card, cfg, params_np), "CTC training")
    print(f"time: the training phase took {time.perf_counter() - t_slice:.1f} s {card}")
    # --- the device mesh: (m1) one rank under NCCL, (m2) two under gloo ----
    t_slice = time.perf_counter()
    add(run_mesh_m1(device, card, cfg, params_np, vocab), "the (1x1) mesh", "k1")
    print(f"time: the (m1) mesh phase took {time.perf_counter() - t_slice:.1f} s {card}")
    t_slice = time.perf_counter()
    counts, mesh_err = run_mesh_m2(card)
    add(counts, "the (m2) mesh ranks", "k1")
    if counts.get("k5", 0) < 1:
        raise AssertionError(f"the (m2) mesh ranks never launched k5: {counts}")
    for tier, e in mesh_err.items():
        key = "k5_f32" if tier == "k5" else tier  # the mesh's K5 launches are f32
        max_err[key] = max(max_err[key], e)
    print(f"time: the (m2) mesh phase took {time.perf_counter() - t_slice:.1f} s {card}")
    print(f"launch counts on the paths: {launches}")
    K4_CLUSTERS_RUN.update(n for n, c in viterbi_cuda.k4_clusters.items() if c)
    if not {1, 2}.issubset(K4_CLUSTERS_RUN):
        raise AssertionError(f"K4 ran with clusters of {sorted(K4_CLUSTERS_RUN)}")
    if not (launches["k5_wgmma"] >= 1 and launches["k5_fma"] >= 1
            and launches["k5_wgmma"] + launches["k5_fma"] == launches["k5"]):
        raise AssertionError(f"K5's launches by kernel on the paths: {launches}; want both "
                             "kernels launched, summing to k5")
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
    # every cluster size K4 ran with in this smoke (path runs and checks)
    line[-1]["clusters"] = sorted(K4_CLUSTERS_RUN)
    bound_ms, bound_by = dp_bound("k4", *w3_run["shape"][:4], *w3_run["shape"][4:])
    line.append({
        "name": "viterbi_k4_cluster",  # K4 past 16 384 states: (w3), 20 min, a cluster of 2
        "route": "cuda",
        "source": "wav2vec2_tpu_torch/csrc/viterbi_blocked.cu",
        "replaces": f"wav2vec2_tpu/ops/viterbi_pallas.py:{replaces['k4']}",
        "launches": sum(c for k, c in launches.items()
                        if k.startswith("k4_cluster_") and int(k.rsplit("_", 1)[1]) > 1),
        "max_abs_err": max_err["k4_cluster"],
        "ms": w3_run["ms"],
        "plain_ms": w3_run["plain_ms"],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "clusters": [w3_run["cluster"]],
    })
    line.append({
        "name": "flash_attention_k5",  # bf16: flash_attention_wgmma_kernel
        "route": "cuda",
        "source": "wav2vec2_tpu_torch/csrc/flash_attention.cu",
        "replaces": "wav2vec2_tpu/ops/flash_attention.py:124",
        "launches": launches["k5_wgmma"],
        "max_abs_err": max_err["k5"],
        "ms": k5_run["ms"],
        "plain_ms": k5_run["plain_ms"],
        "bound_ms": k5_run["bound_ms"],
        "bound_by": k5_run["bound_by"],
        "library_ms": k5_run["library_ms"],
    })
    line.append({
        "name": "flash_attention_k5_f32",  # f32: flash_attention_f32_kernel, the slice's shape
        "route": "cuda",
        "source": "wav2vec2_tpu_torch/csrc/flash_attention.cu",
        "replaces": "wav2vec2_tpu/ops/flash_attention.py:124",
        "launches": launches["k5_fma"],
        "max_abs_err": max_err["k5_f32"],
        "ms": k5_run["f32"]["ms"],
        "plain_ms": k5_run["f32"]["plain_ms"],
        "bound_ms": k5_run["f32"]["bound_ms"],
        "bound_by": k5_run["f32"]["bound_by"],
        "library_ms": k5_run["f32"]["library_ms"],
    })
    line.append({
        "name": "flash_attention_k5_online",  # K5 at an online window: B=1, T_pad 256
        "route": "cuda",
        "source": "wav2vec2_tpu_torch/csrc/flash_attention.cu",
        "replaces": "wav2vec2_tpu/ops/flash_attention.py:124",
        "launches": online_k5_launches,
        "max_abs_err": k5_online["err"],
        "ms": k5_online["ms"],
        "plain_ms": k5_online["plain_ms"],
        "bound_ms": k5_online["bound_ms"],
        "bound_by": k5_online["bound_by"],
        "library_ms": k5_online["library_ms"],
    })
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
