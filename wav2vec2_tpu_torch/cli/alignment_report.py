"""alignment_report CLI — benchmark / evaluation harness (L6), on PyTorch.

Counterpart of `wav2vec2_tpu.cli.alignment_report` (the equivalent of the
Rust reference's `alignment_report` binary, src/bin/alignment_report.rs):
aligns a LibriSpeech-layout dataset and emits JSON quality reports,
TextGrid files, SRT/WebVTT subtitles, or perf JSONL with the same schema,
flags, and env-var mirrors (WAV2VEC2_REPORT_*).

json/textgrid/srt/vtt modes stream the dataset through the bucketed batch
aligner (`BatchAligner.align_stream`) by default, with a thread pool
decoding FLAC ahead of it; perf mode measures the per-utterance profiled
path exactly like the reference protocol (warmup on first case, N timed
repeats, median/mean aggregate), with per-stage memory on repeat 0.

Where the port differs from the JAX CLI: `--device` defaults to `cuda` and
accepts `cpu`; asked for `cuda` without a CUDA device, the CLI exits
non-zero and never carries on on the CPU. `--runtime` is `torch` or
`onnx`; `onnx` runs the exported graph (`--onnx-model`, default
MODEL_DIR/model.onnx) through `pipeline.onnx_runtime.OnnxRuntimeBackend` on
`--device`, one utterance at a time (the batch engine is switched off, as
in the JAX CLI). `--torch-profile
DIR` writes a `torch.profiler` trace of the perf loop where the JAX CLI
has `--jax-profile`.

Usage:
    python -m wav2vec2_tpu_torch.cli.alignment_report --model-dir M \
        --dataset-root D --output-format {json,textgrid,perf,srt,vtt} \
        [--device cpu] [--perf-out out.jsonl] ...
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time
from datetime import datetime, timezone
from pathlib import Path

import torch

from ..align.report import (
    Meta,
    Report,
    aggregate_reports,
    attach_outlier_traces,
    compute_sentence_report,
    infer_split,
)
from ..config import Wav2Vec2Config, Wav2Vec2ModelConfig, load_vocab
from ..data.audio import read_audio_mono
from ..data.librispeech import (
    filter_cases,
    load_case_filter,
    load_cases_from_textgrids,
    load_cases_from_transcripts,
    resolve_dataset_base_and_subsets,
)
from ..data.textgrid import write_textgrid
from ..errors import InvalidInputError
from ..types import AlignmentInput
from ..utils.device import device_label, select_device
from . import perf_report_formatter as perf_fmt
from .json_report_formatter import write_report

OUTLIER_TRACE_TOP_N = 20


def _env(name, default=None):
    return os.environ.get(f"WAV2VEC2_REPORT_{name}", default)


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="alignment_report",
        description="Generate deterministic forced-alignment quality reports",
    )
    p.add_argument("--model-dir", default=_env("MODEL_DIR", "models/wav2vec2_base_960h"))
    p.add_argument("--dataset-root", default=_env("DATASET_ROOT", "test-data"))
    p.add_argument("--cases-file", default=_env("CASES_FILE"))
    p.add_argument("--out", default=_env("OUT"))
    p.add_argument("--limit", type=int, default=_env("LIMIT"))
    p.add_argument("--offset", type=int, default=int(_env("OFFSET", "0")))
    p.add_argument(
        "--device", default=_env("DEVICE", "cuda"),
        help="torch device: cuda (default; exits non-zero without a CUDA "
             "device) or cpu",
    )
    p.add_argument(
        "--runtime", default=_env("RUNTIME", "torch"), choices=["torch", "onnx"],
        help="model runtime backend (the reference CLI's candle/onnx "
             "selection, alignment_report.rs:180-249); onnx runs the "
             "exported graph on --device, one utterance at a time",
    )
    p.add_argument(
        "--onnx-model", default=_env("ONNX_MODEL"),
        help="path to the exported .onnx graph, for --runtime onnx "
             "(default MODEL_DIR/model.onnx)",
    )
    p.add_argument(
        "--compute-dtype", default=_env("COMPUTE_DTYPE", "float32"),
        choices=["float32", "bfloat16"],
    )
    p.add_argument(
        "--units", default=_env("UNITS", "word"),
        choices=["word", "phoneme"],
        help="alignment unit: 'word' runs the full grouping orchestrator; "
             "'phoneme' treats the transcript as whitespace-separated vocab "
             "symbols and emits tight per-phone units (for phoneme-CTC "
             "models; the reference's envisioned switchable grouping mode)",
    )
    p.add_argument(
        "--output-format", default=_env("FORMAT", "json"),
        choices=["json", "textgrid", "perf", "srt", "vtt"],
        help="json report, Praat TextGrids, perf JSONL (reference formats), "
             "or SRT/WebVTT subtitles (beyond-parity)",
    )
    p.add_argument("--textgrid-suffix", default=_env("TEXTGRID_SUFFIX", ""))
    p.add_argument("--no-overwrite", action="store_true",
                   default=_env("NO_OVERWRITE", "") == "1",
                   help="skip cases whose TextGrid output already exists "
                        "(operational resume, like the python reference's "
                        "--no-overwrite)")
    p.add_argument(
        "--batch", action=argparse.BooleanOptionalAction, default=True,
        help="bucketed batch alignment for json/textgrid modes",
    )
    p.add_argument(
        "--audio-bucket-seconds", type=float,
        default=float(_env("AUDIO_BUCKET_SECONDS", "1.0")),
        help="audio bucket granularity in seconds; lengths round up on a "
             "pow2 grid from this base. Larger values trade padding FLOPs "
             "for fewer distinct batch shapes",
    )
    p.add_argument(
        "--max-batch", type=int, default=int(_env("MAX_BATCH", "64")),
        help="max utterances per device batch (batch dims pad to pow2)",
    )
    p.add_argument("--perf-out", default=_env("PERF_OUT"))
    p.add_argument("--perf-warmup", type=int, default=int(_env("PERF_WARMUP", "10")))
    p.add_argument("--perf-repeats", type=int, default=int(_env("PERF_REPEATS", "30")))
    p.add_argument(
        "--perf-aggregate", default=_env("PERF_AGGREGATE", "median"),
        choices=["median", "mean"],
    )
    p.add_argument("--perf-append", action="store_true",
                   default=_env("PERF_APPEND", "") == "1")
    p.add_argument("--perf-scaling-report", action="store_true",
                   default=_env("PERF_SCALING_REPORT", "") == "1")
    p.add_argument("--torch-profile", default=_env("TORCH_PROFILE"),
                   help="directory for a torch.profiler trace of the perf "
                        "loop (perf_trace.json, Chrome trace format; the "
                        "analog of the reference's tier-2 profiling)")
    return p


class _ProgressLine:
    """Per-case progress on stderr (the reference CLI's indicatif bar,
    alignment_report.rs): an in-place-updating line with rate + ETA on a
    TTY, a print every 25 cases otherwise (logs/CI stay readable)."""

    def __init__(self, total: int, label: str = "aligning"):
        self.total = total
        self.label = label
        self.t0 = time.perf_counter()
        self.tty = sys.stderr.isatty()

    def update(self, done: int) -> None:
        if self.tty:
            elapsed = time.perf_counter() - self.t0
            rate = done / elapsed if elapsed > 0 else 0.0
            eta = (self.total - done) / rate if rate > 0 else 0.0
            width = 24
            filled = int(width * done / self.total) if self.total else width
            bar = "#" * filled + "-" * (width - filled)
            print(f"\r[{bar}] {self.label} {done}/{self.total} "
                  f"({rate:.1f}/s, eta {eta:.0f}s) ",
                  end="", file=sys.stderr, flush=True)
        elif done % 25 == 0:
            print(f"[alignment_report] {done}/{self.total}", file=sys.stderr)

    def finish(self) -> None:
        if self.tty:
            print(file=sys.stderr)


def _require(path: Path, what: str) -> Path:
    if not path.exists():
        raise SystemExit(f"error: missing {what}: {path}")
    return path


def _select_device(name: str) -> torch.device:
    """The torch device the CLI runs on (`utils.device.select_device`:
    cuda or cpu, and cuda only where a CUDA device is present, with no
    silent fall-back to the CPU); a refusal exits with its message."""
    try:
        return select_device(name)
    except InvalidInputError as e:
        raise SystemExit(f"error: {e}") from None


def _load_model(args):
    """Model dir must contain weights + config.json + vocab.json
    (alignment_report.rs:964-1006). The onnx runtime needs the .onnx graph
    instead of safetensors weights."""
    model_dir = Path(args.model_dir)
    config_path = _require(model_dir / "config.json", "config.json")
    vocab_path = _require(model_dir / "vocab.json", "vocab.json")
    if args.runtime == "onnx":
        weights_path = _require(_onnx_path(args, model_dir), "model.onnx")
    else:
        weights_path = _require(model_dir / "model.safetensors", "model.safetensors")
    model_cfg = Wav2Vec2ModelConfig.load(config_path)
    # phoneme mode looks symbols up verbatim — keep multi-codepoint keys
    vocab = load_vocab(
        vocab_path,
        single_char_only=getattr(args, "units", "word") != "phoneme",
    )
    return model_dir, weights_path, config_path, vocab_path, model_cfg, vocab


def _load_cases(args, json_mode: bool):
    dataset_root, subsets = resolve_dataset_base_and_subsets(args.dataset_root)
    existing = [s for s in subsets if s.exists()]
    if not existing:
        raise SystemExit(f"error: no subset directories found under {dataset_root}")
    if json_mode:
        try:
            cases = load_cases_from_textgrids(dataset_root, existing)
        except FileNotFoundError:
            # fall back to trans.txt (report without references)
            cases = load_cases_from_transcripts(dataset_root, existing)
    else:
        cases = load_cases_from_transcripts(dataset_root, existing)
    case_ids = load_case_filter(args.cases_file) if args.cases_file else None
    cases = filter_cases(cases, case_ids, args.offset, args.limit)
    if not cases:
        raise SystemExit("error: no cases after filtering")
    return dataset_root, cases


def _make_batch_aligner(args, model_cfg, vocab, params):
    from ..parallel.batching import BatchAligner

    return BatchAligner(
        model_cfg, params, vocab, compute_dtype=args.compute_dtype,
        device=args.device, units=args.units,
    )


def _with_units(builder, units):
    """Inject phoneme-mode tokenizer/grouper."""
    if units == "phoneme":
        from ..pipeline.defaults import PhonemeGrouper, PhonemeTokenizer

        builder = (
            builder.with_tokenizer(PhonemeTokenizer())
            .with_word_grouper(PhonemeGrouper())
        )
    return builder


def _onnx_path(args, model_dir: Path) -> Path:
    return Path(args.onnx_model) if args.onnx_model else model_dir / "model.onnx"


def _make_single_aligner(args, model_dir, model_cfg):
    from ..pipeline.builder import ForcedAlignerBuilder

    if args.runtime == "onnx":
        from ..pipeline.onnx_runtime import OnnxRuntimeBackend

        onnx_path = _onnx_path(args, model_dir)
        backend = OnnxRuntimeBackend(onnx_path, model_cfg, device=args.device)
        cfg = Wav2Vec2Config(
            model_path=str(onnx_path),
            config_path=str(model_dir / "config.json"),
            vocab_path=str(model_dir / "vocab.json"),
            device=args.device,
        )
        builder = ForcedAlignerBuilder(cfg).with_runtime_backend(backend)
        return _with_units(builder, args.units).build()

    cfg = Wav2Vec2Config(
        model_path=str(model_dir / "model.safetensors"),
        config_path=str(model_dir / "config.json"),
        vocab_path=str(model_dir / "vocab.json"),
        device=args.device,
    )
    builder = (
        ForcedAlignerBuilder(cfg)
        .with_backend_options(compute_dtype=args.compute_dtype)
    )
    return _with_units(builder, args.units).build()


def run(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    t_start = time.perf_counter()
    if args.runtime == "onnx" and args.batch:
        # the ONNX backend is single-utterance (batch must be 1, matching
        # the reference's onnx runtime); the batch engine is torch-only
        args.batch = False

    from ..utils.tracing import configure_logging

    configure_logging()
    device = _select_device(args.device)
    label = device_label(device)
    print(f"[alignment_report] torch device: {device} ({label})", file=sys.stderr)

    model_dir, weights_path, _, _, model_cfg, vocab = _load_model(args)
    json_mode = args.output_format == "json"
    dataset_root, cases = _load_cases(args, json_mode)
    print(f"[alignment_report] {len(cases)} cases; format={args.output_format}",
          file=sys.stderr)

    if args.output_format == "perf":
        return _run_perf(args, model_dir, model_cfg, dataset_root, cases)

    per_case_ext = {"textgrid": "TextGrid", "srt": "srt", "vtt": "vtt"}.get(
        args.output_format
    )
    if per_case_ext and args.no_overwrite:
        # operational resume: drop cases whose output already exists BEFORE
        # aligning (python reference --no-overwrite behavior)
        def _exists(c):
            ap = dataset_root / c.audio_path
            return ap.with_name(
                f"{ap.stem}{args.textgrid_suffix}.{per_case_ext}"
            ).exists()

        keep, n_skipped = [], 0
        for c in cases:  # one stat per case (full splits are 560k+ files)
            if _exists(c):
                n_skipped += 1
            else:
                keep.append(c)
        cases = keep
        if n_skipped:
            print(f"[alignment_report] skipping {n_skipped} existing "
                  f"{per_case_ext} outputs", file=sys.stderr)
        if not cases:
            print("[alignment_report] nothing to do", file=sys.stderr)
            return 0

    # Lazily decode + align. Batch mode streams through
    # BatchAligner.align_stream so memory stays bounded by the decode
    # prefetch window + the engine's pending set — a full LibriSpeech split
    # never sits in RAM at once (upfront loading peaked at ~5 GB there).
    from ..align.tokenization import (
        build_token_sequence_case_aware,
        build_token_sequence_phoneme,
    )

    tokenize = (
        build_token_sequence_phoneme if args.units == "phoneme"
        else build_token_sequence_case_aware
    )

    def _decode(c):
        samples, rate = read_audio_mono(dataset_root / c.audio_path)
        return samples, int(len(samples) / rate * 1000)

    def _too_short(c, n_samples):
        # per-case skip instead of aborting the run (the per-utterance
        # guard raises, runtime.rs:116-121; here it becomes a warning)
        seq = tokenize(
            c.transcript, vocab, model_cfg.pad_token_id, vocab.get("|", 0)
        )
        t_i = model_cfg.conv_output_length(n_samples)
        min_frames = -(-len(seq.tokens) // 2)
        if seq.tokens and t_i < min_frames:
            print(f"[alignment_report] skipping {c.id}: audio too short for "
                  f"transcript ({t_i} frames < {min_frames})", file=sys.stderr)
            return True
        return False

    results: list[tuple] = []  # (case_pos, Case, AlignmentOutput, duration_ms)
    progress = _ProgressLine(len(cases))

    if args.batch:
        from ..models.params import load_safetensors_params

        # f32 on the device; at bf16 the aligner stores its compute
        # weights in bf16
        params = load_safetensors_params(weights_path, model_cfg, device=device)
        aligner = _make_batch_aligner(args, model_cfg, vocab, params)

        streamed: list[tuple] = []  # (case_pos, Case, duration_ms), yield order

        def _items():
            # sliding-window decode prefetch (the native FLAC decoder
            # releases the GIL, so decode overlaps device work)
            from collections import deque
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=8) as pool:
                futs: deque = deque()

                def _next():
                    pos, c, fut = futs.popleft()
                    samples, dur = fut.result()
                    if _too_short(c, len(samples)):
                        return None
                    streamed.append((pos, c, dur))
                    return samples, c.transcript

                for pos, c in enumerate(cases):
                    futs.append((pos, c, pool.submit(_decode, c)))
                    if len(futs) >= 32:
                        item = _next()
                        if item is not None:
                            yield item
                while futs:
                    item = _next()
                    if item is not None:
                        yield item

        for idx, out in aligner.align_stream(
            _items(),
            audio_multiple=max(1, int(args.audio_bucket_seconds * 16000)),
            max_batch=args.max_batch,
            max_pending=128,
        ):
            pos, c, dur = streamed[idx]
            results.append((pos, c, out, dur))
            progress.update(len(results))
    else:
        aligner = _make_single_aligner(args, model_dir, model_cfg)
        for pos, c in enumerate(cases):
            samples, dur = _decode(c)
            if _too_short(c, len(samples)):
                continue
            out = aligner.align(AlignmentInput(16000, samples, c.transcript))
            results.append((pos, c, out, dur))
            progress.update(len(results))
    progress.finish()
    if not results:
        raise SystemExit("error: no alignable cases")
    results.sort(key=lambda r: r[0])  # report/output in dataset order

    if per_case_ext:
        written = 0
        for _, c, out, dur in results:
            audio_path = dataset_root / c.audio_path
            out_path = audio_path.with_name(
                f"{audio_path.stem}{args.textgrid_suffix}.{per_case_ext}"
            )
            if args.no_overwrite and out_path.exists():
                continue
            if args.output_format == "textgrid":
                write_textgrid(
                    audio_path, c.transcript, out.words, dur,
                    suffix=args.textgrid_suffix,
                )
            else:
                from ..data.subtitles import write_subtitles

                write_subtitles(
                    audio_path, out.words, args.output_format,
                    suffix=args.textgrid_suffix,
                )
            written += 1
        print(f"[alignment_report] wrote {written} {per_case_ext} files "
              f"in {time.perf_counter() - t_start:.1f}s", file=sys.stderr)
        return 0

    # json mode
    sentences = []
    predicted_by_id = {}
    references_by_id = {}
    for _, c, out, dur in results:
        split = infer_split(c.audio_path)
        reference = c.reference_words if c.has_reference else None
        sentences.append(
            compute_sentence_report(
                c.id, split, out.words, reference, dur,
                frame_stats=out.frame_stats,
            )
        )
        predicted_by_id[c.id] = out.words
        if reference is not None:
            references_by_id[c.id] = list(reference)
    aggregates = aggregate_reports(sentences)
    attach_outlier_traces(
        sentences, predicted_by_id, references_by_id, OUTLIER_TRACE_TOP_N
    )
    report = Report(
        schema_version=1,
        meta=Meta(
            generated_at=datetime.now(timezone.utc).isoformat(),
            model_path=str(model_dir),
            device=device.type,
            frame_stride_ms=model_cfg.frame_stride_ms(16000),
            case_count=len(results),
        ),
        sentences=sentences,
        aggregates=aggregates,
    )
    out_path = Path(args.out) if args.out else Path(
        "alignment_reports"
    ) / f"alignment-report-{datetime.now(timezone.utc):%Y%m%dT%H%M%SZ}.json"
    write_report(report, out_path)
    print(f"[alignment_report] wrote {out_path} "
          f"in {time.perf_counter() - t_start:.1f}s", file=sys.stderr)
    return 0


def _run_perf(args, model_dir, model_cfg, dataset_root, cases) -> int:
    """Perf mode (alignment_report.rs:314-481): pre-normalize once per case,
    warmup ×N on the first case, ×M timed repeats, per-stage aggregation."""
    if not args.perf_out:
        raise SystemExit("error: perf mode requires --perf-out")
    from ..pipeline.runtime import normalize_audio

    aligner = _make_single_aligner(args, model_dir, model_cfg)
    agg_fn = (
        (lambda v: perf_fmt.metric_stats(v).median)
        if args.perf_aggregate == "median"
        else (lambda v: perf_fmt.metric_stats(v).mean)
    )

    profile_ctx = None
    if args.torch_profile:
        import contextlib

        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.device(args.device).type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        trace_path = Path(args.torch_profile) / "perf_trace.json"
        prof = profile(activities=activities)

        def _export():
            trace_path.parent.mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(trace_path))

        # exits run last-in first-out: the trace is exported after the
        # profiler has stopped
        profile_ctx = contextlib.ExitStack()
        profile_ctx.callback(_export)
        profile_ctx.enter_context(prof)

    appender = (
        perf_fmt.PerfJsonlAppender(args.perf_out) if args.perf_append else None
    )
    records: list[perf_fmt.PerfUtteranceRecord] = []
    scaling: list[tuple[str, int, int, int, float]] = []
    warmed = False
    try:
        for idx, c in enumerate(cases):
            samples, rate = read_audio_mono(dataset_root / c.audio_path)
            duration_ms = int(len(samples) / rate * 1000)
            inp = AlignmentInput(
                rate, samples, c.transcript, normalized=normalize_audio(samples)
            )
            stage_runs = {k: [] for k in
                          ("forward", "post", "dp", "group", "conf", "align", "total")}
            last = None
            memory = None
            try:
                if not warmed:
                    for _ in range(args.perf_warmup):
                        aligner.align_profiled(inp)
                    warmed = True
                for rep in range(max(args.perf_repeats, 1)):
                    if rep == 0:
                        # memory profiled on repeat 0 only (alignment_report.rs perf loop)
                        last, stage_memory = aligner.align_profiled_with_memory(inp)
                        memory = _perf_memory_from_stages(stage_memory)
                    else:
                        last = aligner.align_profiled(inp)
                    t = last.timings
                    for k, v in (("forward", t.forward_ms), ("post", t.post_ms),
                                 ("dp", t.dp_ms), ("group", t.group_ms),
                                 ("conf", t.conf_ms), ("align", t.align_ms),
                                 ("total", t.total_ms)):
                        stage_runs[k].append(v)
            except InvalidInputError as e:
                # per-case skip, like the json/textgrid modes: one unalignable
                # case must not abort the run and lose the aggregate
                print(f"[alignment_report] skipping {c.id}: {e}", file=sys.stderr)
                continue

            align_ms = agg_fn(stage_runs["align"])
            ts = max(last.ts_product, 1)
            record = perf_fmt.PerfUtteranceRecord(
                utterance_id=c.id,
                audio_path=c.audio_path,
                duration_ms=duration_ms,
                num_frames_t=last.num_frames_t,
                state_len=last.state_len,
                ts_product=last.ts_product,
                vocab_size=last.vocab_size,
                dtype=last.dtype,
                device=last.device,
                frame_stride_ms=last.frame_stride_ms,
                warmup=args.perf_warmup,
                repeats=args.perf_repeats,
                aggregate=args.perf_aggregate,
                forward_ms=agg_fn(stage_runs["forward"]),
                post_ms=agg_fn(stage_runs["post"]),
                dp_ms=agg_fn(stage_runs["dp"]),
                group_ms=agg_fn(stage_runs["group"]),
                conf_ms=agg_fn(stage_runs["conf"]),
                align_ms=align_ms,
                align_ms_per_ts=align_ms / ts,
                align_ms_per_t=align_ms / max(last.num_frames_t, 1),
                total_ms=agg_fn(stage_runs["total"]),
                forward_ms_repeats=stage_runs["forward"],
                post_ms_repeats=stage_runs["post"],
                dp_ms_repeats=stage_runs["dp"],
                group_ms_repeats=stage_runs["group"],
                conf_ms_repeats=stage_runs["conf"],
                align_ms_repeats=stage_runs["align"],
                total_ms_repeats=stage_runs["total"],
                memory=memory,
            )
            records.append(record)
            scaling.append(
                (c.id, last.num_frames_t, last.state_len, last.ts_product,
                 record.dp_ms)
            )
            if appender is not None:
                appender.append(record)
            if (idx + 1) % 10 == 0:
                print(f"[alignment_report] perf {idx + 1}/{len(cases)}",
                      file=sys.stderr)

    finally:
        if profile_ctx is not None:
            # finalize the trace even when a case raises
            profile_ctx.close()
            print(f"[alignment_report] torch profiler trace written to "
                  f"{trace_path}", file=sys.stderr)

    config = perf_fmt.PerfRunConfig(
        warmup=args.perf_warmup, repeats=args.perf_repeats,
        aggregate=args.perf_aggregate, append=args.perf_append,
    )
    aggregate = perf_fmt.aggregate_stats(records)
    if appender is not None:
        appender.finish()
    else:
        perf_fmt.write_json_report(args.perf_out, config, records, aggregate)
    perf_fmt.write_summary_report(
        perf_fmt.summary_path_for(args.perf_out), config, aggregate
    )

    if args.perf_scaling_report:
        _print_scaling_report(scaling)
    return 0


def _perf_memory_from_stages(stages) -> "perf_fmt.PerfMemory | None":
    """Per-stage memory for the perf record. A device reading that could
    not be taken (a CPU run) is null, never 0."""
    def snap(stage_mem):
        if stage_mem is None:
            return None
        dev = stage_mem.device
        return perf_fmt.GpuMemorySnapshot(
            gpu_used=dev.used if dev is not None else None,
            gpu_total=dev.total if dev is not None else None,
            rss_peak=stage_mem.peak_rss_bytes,
        )

    mem = perf_fmt.PerfMemory(
        forward=snap(stages.forward),
        post=snap(stages.post),
        dp=snap(stages.dp),
        group=snap(stages.group),
        conf=snap(stages.conf),
    )
    if all(v is None for v in (mem.forward, mem.post, mem.dp, mem.group, mem.conf)):
        return None
    return mem


def _print_scaling_report(scaling) -> None:
    """Per-case T/S/T·S + Pearson corr(dp_ms, T·S) + worst dp_ms/TS outliers
    (alignment_report.rs:1584-1664)."""
    print("utterance_id\tT\tS\tT*S\tdp_ms\tdp_ms/TS")
    ratios = []
    for uid, t, s, ts, dp in scaling:
        ratio = dp / max(ts, 1)
        ratios.append((ratio, uid))
        print(f"{uid}\t{t}\t{s}\t{ts}\t{dp:.3f}\t{ratio:.3e}")
    xs = [float(ts) for _, _, _, ts, _ in scaling]
    ys = [dp for *_, dp in scaling]
    corr = _pearson(xs, ys)
    print(f"pearson_corr(dp_ms, T*S) = {corr:.4f}" if corr is not None
          else "pearson_corr(dp_ms, T*S) = n/a")
    worst = sorted(ratios, reverse=True)[:5]
    print("worst dp_ms/TS outliers: " + ", ".join(f"{uid} ({r:.3e})" for r, uid in worst))


def _pearson(xs, ys):
    n = len(xs)
    if n < 2:
        return None
    mx, my = sum(xs) / n, sum(ys) / n
    cov = sum((x - mx) * (y - my) for x, y in zip(xs, ys))
    vx = sum((x - mx) ** 2 for x in xs)
    vy = sum((y - my) ** 2 for y in ys)
    if vx <= 0 or vy <= 0:
        return None
    return cov / math.sqrt(vx * vy)


def main() -> None:
    raise SystemExit(run())


if __name__ == "__main__":
    main()
