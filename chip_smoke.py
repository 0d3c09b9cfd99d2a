"""Smoke test of the PyTorch/CUDA port (`wav2vec2_tpu_torch`) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds the CUDA kernel from `wav2vec2_tpu_torch/csrc/`, holds it
against its plain PyTorch version and the numpy oracle, drives the port's
main path at the full width of wav2vec2-base (random weights from a numpy
seed) through both entry points — `BatchAligner.submit_padded_batch` on
32 × 10 s and `ForcedAlignerBuilder` on 3 requests — checks the results
with the gates of `bench.py`, and times the kernel, the forward and the
batch path. Every failure raises and the exit code is non-zero; without a
CUDA device it exits non-zero before running anything. The last line of
standard output is one JSON object naming the device.
"""

from __future__ import annotations

import json
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
WORDS = ["THE", "QUICK", "BROWN", "FOX", "JUMPS", "OVER", "LAZY", "DOG",
         "WHILE", "SINGING", "ANCIENT", "MELODIES", "UNDER", "BRIGHT",
         "WINTER", "STARS", "NEAR", "FROZEN", "RIVERS", "TONIGHT"]
SAMPLE_RATE = 16000
S_PAD = 256


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
    # edge cases: s_len=1; s_len=2*t_len (tightest band); repeated tokens
    # [0,1,0,1,0] (skip rule); t_len < T_pad; -inf emissions
    t_pad, s_pad = 64, 128
    lp = random_log_probs(rng, 5, t_pad, 8)
    lp[4, :, 3] = -np.inf
    tokens = rng.integers(0, 8, size=(5, s_pad)).astype(np.int32)
    tokens[2, :5] = [0, 1, 0, 1, 0]
    tokens[4, :40:2] = 3
    cases.append(("edge cases T_pad=64 S_pad=128", lp, tokens,
                  np.array([64, 20, 12, 64, 40], np.int32),
                  np.array([1, 40, 5, 128, 40], np.int32)))
    b, t, s_pad = 4, 1499, 768
    cases.append(("large B=4 T=1499 S_pad=768", random_log_probs(rng, b, t, v),
                  rng.integers(0, v, size=(b, s_pad)).astype(np.int32),
                  np.array([1499, 1499, 1200, 900], np.int32),
                  np.array([768, 700, 500, 300], np.int32)))
    return cases


def check_kernel(device, cases, oracle_rows=3):
    """Kernel vs its plain PyTorch version (all rows, all frames) and vs the
    numpy oracle (a few rows), bit-identical. Returns the max abs path
    difference (0) and the number of rows compared."""
    import torch

    from wav2vec2_tpu_torch.ops import viterbi_cuda, viterbi_ref

    worst = 0
    for name, lp, tok, t_lens, s_lens in cases:
        args = [torch.from_numpy(a).to(device) for a in (lp, tok, t_lens, s_lens)]
        got = viterbi_cuda.viterbi_batch(*args).cpu().numpy()
        plain = viterbi_ref.viterbi_batch(*args).cpu().numpy()
        diff = int(np.abs(got.astype(np.int64) - plain).max())
        worst = max(worst, diff)
        if diff:
            bad = np.argwhere(got != plain)[0]
            raise AssertionError(f"{name}: kernel path differs from the plain version "
                                 f"at (row, frame) {tuple(bad)}")
        for j in range(min(oracle_rows, len(t_lens))):
            t_i, s_i = int(t_lens[j]), int(s_lens[j])
            ref = np.asarray([s for s, _ in viterbi_ref.viterbi_numpy(
                lp[j, :t_i], tok[j, :s_i])], np.int32)
            if not (got[j, :t_i] == ref).all() or not (got[j, t_i:] == ref[-1]).all():
                raise AssertionError(f"{name}: row {j} differs from viterbi_numpy")
        print(f"kernel check [{name}]: paths bit-identical to the plain version "
              f"({got.shape[0]} rows) and to viterbi_numpy ({min(oracle_rows, len(t_lens))} rows)")
    return worst


def batch_inputs(rng, vocab, batch, seconds):
    from wav2vec2_tpu_torch.align.tokenization import build_token_sequence_case_aware

    n = int(seconds * SAMPLE_RATE)
    transcripts = [" ".join(rng.permutation(WORDS)) for _ in range(batch)]
    seqs = [build_token_sequence_case_aware(t, vocab, 0, 4) for t in transcripts]
    audio = (rng.normal(size=(batch, n)) * 4000).clip(-32768, 32767).astype(np.int16)
    tokens = np.zeros((batch, S_PAD), np.int32)
    for j, s in enumerate(seqs):
        tokens[j, : len(s.tokens)] = s.tokens
    a_l = np.full(batch, n, np.int32)
    s_l = np.array([len(s.tokens) for s in seqs], np.int32)
    return seqs, audio, a_l, tokens, s_l


def run_batch_entry(device, cfg, params, vocab, batch, seconds, n_check):
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
    print(f"batch entry: {batch} x {seconds:g} s bf16, gates passed: (a) paths == viterbi_numpy "
          f"({n_check} utts); (b) grouping {exact}/{total} exact, {within_one}/{total} within "
          f"one frame; (c) bf16 vs f32 log-probs mean|Δ|={mean_d} p99|Δ|={p99_d}, words equal")
    return aligner, inputs


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
        words = res.output.words
        if len(words) != n_words:
            raise AssertionError(f"request {i}: {len(words)} words, want {n_words}")
        for a, b in zip(words, words[1:]):
            if not (a.start_ms <= a.end_ms <= b.start_ms <= b.end_ms):
                raise AssertionError(f"request {i}: words not monotone: {a} then {b}")
        results.append(res)
        print(f"single entry: request {i} ({sec:g} s, T={t_len}, S={s_len}): "
              f"{len(words)} words, monotone; forward {res.timings.forward_ms:.3f} ms, "
              f"dp+evidence {res.timings.dp_ms:.3f} ms, total {res.timings.total_ms:.3f} ms")
    return results


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


def time_batch_path(aligner, vocab, batch, repeats):
    """Steady-state throughput of the batch entry, as bench.py measures
    it: input staged on the device once, then `repeats` batches
    double-buffered (the next batch is enqueued before this one's results
    are copied back and grouped on the host). Returns (realtime factor,
    wall seconds, peak device memory in GB)."""
    import torch

    seqs, *arrays = batch_inputs(np.random.default_rng(2), vocab, batch, 10.0)
    inputs = [torch.from_numpy(a).to(aligner.device) for a in arrays]
    aligner.group_batch(seqs, aligner.submit_padded_batch(*inputs))  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    inflight = aligner.submit_padded_batch(*inputs)
    for _ in range(repeats - 1):
        nxt = aligner.submit_padded_batch(*inputs)
        aligner.group_batch(seqs, inflight)
        inflight = nxt
    outs = [o.words for o in aligner.group_batch(seqs, inflight)]
    total_s = time.perf_counter() - t0
    if not all(len(w) > 0 for w in outs):
        raise AssertionError(f"B={batch}: an utterance aligned to no words in the timed loop")
    return (repeats * batch * 10.0 / total_s, total_s,
            torch.cuda.max_memory_allocated() / 1e9)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs only on a GPU",
              file=sys.stderr)
        return 2
    from wav2vec2_tpu_torch.config import Wav2Vec2ModelConfig
    from wav2vec2_tpu_torch.models.params import init_params, params_from_jax
    from wav2vec2_tpu_torch.ops import viterbi_cuda, viterbi_ref

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

    info = viterbi_cuda.build(force=True)
    ptxas = " | ".join(l.strip() for l in info["compiler_output"].splitlines()
                       if "registers" in l or "smem" in l)
    print(f"build: {viterbi_cuda.SOURCE.name} -> {info['library']} in {info['seconds']:.3f} s "
          f"(nvcc {' '.join(viterbi_cuda.NVCC_FLAGS)}); ptxas: {ptxas}")

    rng = np.random.default_rng(0)
    cases = kernel_cases(rng)
    max_err = check_kernel(device, cases)

    cfg = Wav2Vec2ModelConfig.from_dict(BASE_CONFIG)
    vocab = make_vocab()
    params_np = init_params(cfg, seed=0)
    params = params_from_jax(params_np, device=device)

    launches = {}
    viterbi_cuda.viterbi_batch.launches = 0
    aligner, inputs = run_batch_entry(device, cfg, params, vocab,
                                              batch=32, seconds=10.0, n_check=16)
    torch.cuda.synchronize()
    launches["batch"] = viterbi_cuda.viterbi_batch.launches
    if launches["batch"] < 1:
        raise AssertionError("the batch entry never launched the K1 kernel")

    with tempfile.TemporaryDirectory() as tmp:
        write_model_dir(Path(tmp), BASE_CONFIG, params_np, cfg, vocab)
        viterbi_cuda.viterbi_batch.launches = 0
        single = run_single_entry(device, Path(tmp), durations=(4.0, 8.0, 12.0), n_words=14)
        torch.cuda.synchronize()
        launches["single"] = viterbi_cuda.viterbi_batch.launches
    if launches["single"] < len(single):
        raise AssertionError(f"the single-utterance entry launched K1 {launches['single']} "
                             f"times for {len(single)} requests")
    print(f"launch counts of K1 on the main path: batch entry {launches['batch']}, "
          f"single-utterance entry {launches['single']}")

    # --- times, each beside the card's name and power limit --------------
    _, lp, tok, t_lens, s_lens = cases[0]
    args = [torch.from_numpy(a).to(device) for a in (lp, tok, t_lens, s_lens)]
    kernel = lambda: viterbi_cuda.viterbi_batch(*args)  # noqa: E731
    plain = lambda: viterbi_ref.viterbi_batch(*args)  # noqa: E731
    kernel(), plain()
    torch.cuda.synchronize()
    p1, k1 = cuda_time_ms(plain, 5), cuda_time_ms(kernel, 50)
    k2, p2 = cuda_time_ms(kernel, 50), cuda_time_ms(plain, 5)
    k_ms, p_ms = statistics.median([k1, k2]), statistics.median([p1, p2])
    print(f"time: K1 kernel {k_ms:.4f} ms vs plain PyTorch {p_ms:.4f} ms at B=128 T=499 "
          f"S_pad=256 (CUDA events, medians; plain, kernel, kernel, plain) {card}")

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
        rtf, total_s, peak_gb = time_batch_path(aligner, vocab, batch, repeats=5)
        print(f"time: batch path {rtf:.1f}x realtime (5 batches of {batch} x 10 s, bf16, "
              f"submit/drain double-buffered, {total_s:.3f} s wall, peak device memory "
              f"{peak_gb:.2f} GB) {card}")
    print(f"total smoke time {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": [{
        "name": "viterbi_k1",
        "route": "cuda",
        "source": "wav2vec2_tpu_torch/csrc/viterbi.cu",
        "replaces": "wav2vec2_tpu/ops/viterbi_pallas.py:59",
        "launches": launches["batch"] + launches["single"],
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
