"""Serving daemon: HTTP micro-batching front end over the batch alignment
engine (counterpart of `wav2vec2_tpu.serve`).

A stdlib-only HTTP server that coalesces concurrent align requests into
padded device batches: the GPU sees large batches while each caller gets a
simple request/response API. The HTTP API, the clamps on client knobs, the
error codes and the stats keys are the JAX package's.

Design:
- requests enqueue into a micro-batch window (default 25 ms or
  `max_batch`, whichever fills first) serviced by ONE worker thread that
  owns the GPU for `/align`, while HTTP threads only parse and wait;
- batches run through `BatchAligner.align_utterances` (bucketing, padded
  batches normalized on the card by K7, submit/drain with host copies on
  a side stream: K1 on the card);
- endpoints:
    POST /align    {"audio": [f32...] | {"pcm16": base64, ...},
                    "sample_rate_hz": 16000, "transcript": "...",
                    "format": "words"|"srt"|"vtt" (default words)}
                   → {"words": [{word,start_ms,end_ms,confidence}...] |
                      "subtitles": "...",
                      "latency_ms": ..., "batch_size": ...}
    GET  /healthz  → {"status":"ok","device":<the card's name, or "cpu">}
    GET  /stats    → counters (requests, errors, audio seconds, realtime
                     factor since start, batch-size histogram)
    POST /stream   {"transcript": "...", "chunk_sec"?, "overlap_sec"?,
                    "finalize_margin_sec"?} → {"stream_id": ...}
    POST /stream/ID        {"audio": ...} → {"words": [finalized...]}
    POST /stream/ID/flush  → {"words": [complete alignment]} (ends session)
    DELETE /stream/ID      → abort
                   (live OnlineAligner sessions, each window forward run
                    by the pushing handler thread; see align/online.py)

Run:  python -m wav2vec2_tpu_torch.serve --model-dir M [--port 8000]
      [--window-ms 25] [--max-batch 64] [--compute-dtype bfloat16]
      [--quantize-int8] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import base64
import json
import queue
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np

from .errors import AlignmentError, InvalidInputError
from .types import AlignmentOutput
from .utils.device import device_label, select_device

# Reject request bodies beyond this size BEFORE reading them — a single
# client must not be able to exhaust daemon memory with one giant POST
# (default bind is loopback, but --host can expose the port).
MAX_BODY_BYTES = 256 * 1024 * 1024


class PayloadTooLargeError(Exception):
    """Content-Length exceeds the configured cap (HTTP 413)."""


@dataclass
class _Request:
    audio: np.ndarray
    transcript: str
    done: threading.Event = field(default_factory=threading.Event)
    result: AlignmentOutput | None = None
    error: Exception | None = None
    batch_size: int = 0
    enqueued_at: float = field(default_factory=time.perf_counter)


class AlignmentService:
    """Micro-batching worker around a BatchAligner. Thread-safe submit()."""

    def __init__(self, aligner, window_ms: float = 25.0, max_batch: int = 64,
                 max_queue: int = 1024):
        self.aligner = aligner
        self.window_s = window_ms / 1000.0
        self.max_batch = max_batch
        self.queue: queue.Queue[_Request] = queue.Queue(maxsize=max_queue)
        self.stats_lock = threading.Lock()
        self.stats = {
            "requests": 0, "errors": 0, "utterances_aligned": 0,
            "audio_seconds": 0.0, "busy_seconds": 0.0,
            "batches": 0, "batch_size_histogram": {},
            "started_at": time.time(),
        }
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="align-worker")
        self._worker.start()

    def submit(self, audio: np.ndarray, transcript: str,
               timeout_s: float = 120.0) -> tuple[AlignmentOutput, int]:
        req = _Request(audio=audio, transcript=transcript)
        self.queue.put(req, timeout=5.0)
        if not req.done.wait(timeout=timeout_s):
            raise TimeoutError("alignment timed out")
        if req.error is not None:
            raise req.error
        return req.result, req.batch_size

    def close(self) -> None:
        self._stop.set()
        self._worker.join(timeout=10.0)

    # -- worker -----------------------------------------------------------

    def _gather_batch(self) -> list[_Request]:
        try:
            first = self.queue.get(timeout=0.2)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.perf_counter() + self.window_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                batch.append(self.queue.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _run(self) -> None:
        while not self._stop.is_set():
            batch = self._gather_batch()
            if not batch:
                continue
            t0 = time.perf_counter()
            try:
                outputs = self.aligner.align_utterances(
                    [r.audio for r in batch],
                    [r.transcript for r in batch],
                    max_batch=self.max_batch,
                )
                for r, out in zip(batch, outputs):
                    r.result = out
                    r.batch_size = len(batch)
            except AlignmentError as e:
                # a bad utterance poisons only its batch; isolate by
                # retrying each item alone so good requests still succeed
                if len(batch) == 1:
                    batch[0].error = e
                else:
                    for r in batch:
                        try:
                            out = self.aligner.align_utterances(
                                [r.audio], [r.transcript], max_batch=1
                            )
                            r.result = out[0]
                            r.batch_size = 1
                        except Exception as e_one:
                            # any per-item failure fails only that item —
                            # a non-AlignmentError here must not unwind the
                            # loop and clobber already-successful retries
                            r.error = e_one
            except Exception as e:  # backend failure: fail the whole batch
                for r in batch:
                    if r.result is None and r.error is None:
                        r.error = e
            busy = time.perf_counter() - t0
            with self.stats_lock:
                s = self.stats
                s["batches"] += 1
                s["busy_seconds"] += busy
                hist = s["batch_size_histogram"]
                hist[str(len(batch))] = hist.get(str(len(batch)), 0) + 1
                for r in batch:
                    if r.error is None:
                        s["utterances_aligned"] += 1
                        s["audio_seconds"] += len(r.audio) / 16000.0
            for r in batch:
                r.done.set()

    def snapshot_stats(self) -> dict:
        with self.stats_lock:
            s = dict(self.stats)
            s["batch_size_histogram"] = dict(s["batch_size_histogram"])
        busy = s.pop("busy_seconds")
        s["realtime_factor"] = (
            round(s["audio_seconds"] / busy, 1) if busy > 0 else None
        )
        s["uptime_seconds"] = round(time.time() - s.pop("started_at"), 1)
        return s


def _decode_audio(payload: dict) -> np.ndarray:
    audio = payload.get("audio")
    if isinstance(audio, dict) and "pcm16" in audio:
        raw = base64.b64decode(audio["pcm16"])
        return (np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0)
    if isinstance(audio, list):
        return np.asarray(audio, dtype=np.float32)
    raise InvalidInputError(
        'body needs "audio": [floats] or {"pcm16": base64-int16-le}'
    )


def _word_to_json(w) -> dict:
    return {
        "word": w.word, "start_ms": w.start_ms, "end_ms": w.end_ms,
        "confidence": w.confidence,
    }


@dataclass
class _StreamSession:
    aligner: object
    last_used: float
    lock: threading.Lock = field(default_factory=threading.Lock)


class StreamRegistry:
    """Live OnlineAligner sessions behind the HTTP daemon.

    The registry lock guards only the session dict (lookup, start, reap,
    removal). Each session carries its OWN lock for the device forward —
    one stream's window forward (or its first window's cold start) must not
    head-of-line block every other stream plus start/flush/delete. The
    shared window forward is safe to call from several threads at once
    (PyTorch enqueues each thread's work on the device's stream); the
    per-session lock only keeps one session's incremental state
    consistent."""

    _EXPIRED_MEMORY = 256  # recently-ended sids remembered for 404 clarity

    def __init__(self, aligner, compute_dtype: str, max_streams: int = 32,
                 idle_timeout_s: float = 600.0, units: str = "word"):
        self._aligner = aligner
        self._compute_dtype = compute_dtype
        self._units = units
        self._max = max_streams
        self._idle_timeout_s = idle_timeout_s
        self._lock = threading.Lock()
        self._sessions: dict[str, _StreamSession] = {}
        # sid → reason; lets clients distinguish "reaped/flushed" from
        # "never existed" instead of an indistinct 404
        self._expired: dict[str, str] = {}

    def _note_expired_locked(self, sid: str, reason: str) -> None:
        self._expired[sid] = reason
        while len(self._expired) > self._EXPIRED_MEMORY:
            self._expired.pop(next(iter(self._expired)))

    def _reap_locked(self) -> None:
        """Drop sessions idle past the timeout — abandoned clients must not
        exhaust the max_streams slots permanently. Sessions with an
        in-flight push (a long first window) are never reaped."""
        now = time.monotonic()
        for sid in [s for s, e in self._sessions.items()
                    if now - e.last_used > self._idle_timeout_s
                    and not e.lock.locked()]:
            del self._sessions[sid]
            self._note_expired_locked(
                sid, f"session expired after {self._idle_timeout_s:.0f}s idle"
            )

    def start(self, transcript: str, chunk_sec: float = 5.0,
              overlap_sec: float = 1.0,
              finalize_margin_sec: float = 2.0) -> str:
        import uuid

        from .align.online import OnlineAligner

        # clamp client-supplied knobs: the window size sets the forward's
        # activation memory — clients must not be able to force
        # hour-long windows or unbounded shapes
        chunk_sec = min(max(float(chunk_sec), 1.0), 30.0)
        overlap_sec = min(max(float(overlap_sec), 0.1), chunk_sec / 2)
        # floor, not just >=0: with a tiny margin the Viterbi path at the
        # adopted frontier can still change as more audio arrives, and
        # already-emitted "finalized" words would disagree with the final
        # alignment — violating OnlineAligner's finalized-words-never-change
        # contract. One overlap of context (min 0.5 s) keeps the frontier
        # behind the region the next window can revise.
        finalize_margin_sec = min(
            max(float(finalize_margin_sec), max(0.5, overlap_sec)), 60.0
        )
        with self._lock:
            self._reap_locked()
            if len(self._sessions) >= self._max:
                raise InvalidInputError(
                    f"too many live streams (max {self._max}); flush or "
                    f"delete one first"
                )
            sid = uuid.uuid4().hex[:16]
            self._sessions[sid] = _StreamSession(OnlineAligner(
                self._aligner.cfg, self._aligner.params, self._aligner.vocab,
                transcript, chunk_sec=chunk_sec, overlap_sec=overlap_sec,
                finalize_margin_sec=finalize_margin_sec,
                compute_dtype=self._compute_dtype, units=self._units,
                device=self._aligner.device,
            ), time.monotonic())
            return sid

    def _get_locked(self, sid: str) -> _StreamSession:
        entry = self._sessions.get(sid)
        if entry is None:
            reason = self._expired.get(sid)
            raise KeyError(f"{sid} ({reason})" if reason else sid)
        entry.last_used = time.monotonic()
        return entry

    def push(self, sid: str, audio: np.ndarray) -> list:
        with self._lock:
            self._reap_locked()
            sess = self._get_locked(sid)
        # the device forward runs OUTSIDE the registry lock: only this
        # session serializes on it
        with sess.lock:
            # a flush/delete may have won the race between the two locks;
            # re-check so the late push 404s cleanly instead of hitting the
            # flushed aligner's "push after flush" as a 500 (lock order is
            # acyclic: only push nests registry inside session)
            with self._lock:
                if self._sessions.get(sid) is not sess:
                    reason = self._expired.get(sid)
                    raise KeyError(f"{sid} ({reason})" if reason else sid)
            try:
                return sess.aligner.push(audio)
            finally:
                # refresh AFTER the work too: a push that takes longer than
                # the idle timeout (a cold first window) must not leave its
                # own session looking abandoned
                sess.last_used = time.monotonic()

    def flush(self, sid: str):
        with self._lock:
            sess = self._get_locked(sid)
            del self._sessions[sid]
            self._note_expired_locked(sid, "session already flushed")
        with sess.lock:  # serialize behind any in-flight push
            return sess.aligner.flush()

    def delete(self, sid: str) -> None:
        with self._lock:
            self._get_locked(sid)
            del self._sessions[sid]
            self._note_expired_locked(sid, "session deleted")


class AlignHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer with a production accept backlog.

    The stdlib default `request_queue_size = 5` RSTs excess connections
    when more than a handful of clients connect in the same instant
    (observed as client-side ConnectionResetError under a 24-client load
    test); alignment requests also arrive in bursts by design — the whole
    point of the micro-batching window."""

    daemon_threads = True
    request_queue_size = 128


def make_handler(service: AlignmentService, device_label: str,
                 streams: StreamRegistry | None = None,
                 max_body_bytes: int = MAX_BODY_BYTES):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # socket timeout: a client that sends fewer bytes than
        # Content-Length must not pin a handler thread forever (slowloris)
        timeout = 60

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _reply(self, code: int, obj: dict) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"status": "ok", "device": device_label})
            elif self.path == "/stats":
                self._reply(200, service.snapshot_stats())
            else:
                self._reply(404, {"error": "not found"})

        def _read_payload(self):
            length = int(self.headers.get("Content-Length", 0))
            if length > max_body_bytes:
                # reject BEFORE reading: the cap exists so one client can't
                # exhaust daemon memory with a giant body
                raise PayloadTooLargeError(
                    f"request body {length} bytes exceeds the "
                    f"{max_body_bytes}-byte cap"
                )
            return json.loads(self.rfile.read(length)) if length else {}

        def _handle_stream(self):
            """POST /stream (start) | /stream/<id> (push) |
            /stream/<id>/flush; DELETE /stream/<id> (abort)."""
            parts = self.path.strip("/").split("/")
            try:
                if self.command == "DELETE" and len(parts) == 2:
                    streams.delete(parts[1])
                    self._reply(200, {"deleted": parts[1]})
                elif self.command == "POST" and len(parts) == 1:
                    payload = self._read_payload()
                    sid = streams.start(
                        str(payload.get("transcript", "")),
                        chunk_sec=float(payload.get("chunk_sec", 5.0)),
                        overlap_sec=float(payload.get("overlap_sec", 1.0)),
                        finalize_margin_sec=float(
                            payload.get("finalize_margin_sec", 2.0)),
                    )
                    self._reply(200, {"stream_id": sid})
                elif self.command == "POST" and len(parts) == 2:
                    payload = self._read_payload()
                    sr = int(payload.get("sample_rate_hz", 16000))
                    if sr != 16000:
                        raise InvalidInputError(
                            f"expected 16000 Hz input, got {sr}"
                        )
                    audio = _decode_audio(payload)
                    words = streams.push(parts[1], audio)
                    self._reply(200, {"words": [_word_to_json(w) for w in words]})
                elif (self.command == "POST" and len(parts) == 3
                      and parts[2] == "flush"):
                    out = streams.flush(parts[1])
                    self._reply(200, {"words": [_word_to_json(w) for w in out.words]})
                else:
                    self._reply(404, {"error": "not found"})
            except KeyError as e:
                self._reply(404, {"error": f"unknown stream {e}"})
            except PayloadTooLargeError as e:
                # the unread body would desync this keep-alive connection
                # (its bytes would parse as the next request) — drop it
                self.close_connection = True
                self._reply(413, {"error": str(e)})
            except (InvalidInputError, ValueError, AssertionError) as e:
                self._reply(400, {"error": str(e)})
            except Exception as e:
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

        def do_DELETE(self):
            if streams is not None and self.path.startswith("/stream/"):
                self._handle_stream()
            else:
                self._reply(404, {"error": "not found"})

        def do_POST(self):
            if streams is not None and (
                self.path == "/stream" or self.path.startswith("/stream/")
            ):
                self._handle_stream()
                return
            if self.path != "/align":
                self._reply(404, {"error": "not found"})
                return
            t0 = time.perf_counter()
            with service.stats_lock:
                service.stats["requests"] += 1
            try:
                payload = self._read_payload()
                sr = int(payload.get("sample_rate_hz", 16000))
                if sr != 16000:
                    raise InvalidInputError(
                        f"expected 16000 Hz input, got {sr}"
                    )
                audio = _decode_audio(payload)
                transcript = str(payload.get("transcript", ""))
                fmt = str(payload.get("format", "words"))
                if fmt not in ("words", "srt", "vtt"):
                    raise InvalidInputError(
                        f"unknown format {fmt!r} (words|srt|vtt)"
                    )
                out, bs = service.submit(audio, transcript)
                body = {
                    "latency_ms": round(
                        (time.perf_counter() - t0) * 1000.0, 2
                    ),
                    "batch_size": bs,
                }
                if fmt == "words":
                    body["words"] = [_word_to_json(w) for w in out.words]
                else:
                    from .data.subtitles import (
                        format_srt,
                        format_vtt,
                        words_to_cues,
                    )

                    cues = words_to_cues(out.words)
                    body["subtitles"] = (
                        format_srt(cues) if fmt == "srt" else format_vtt(cues)
                    )
                self._reply(200, body)
            except PayloadTooLargeError as e:
                with service.stats_lock:
                    service.stats["errors"] += 1
                # unread body bytes must not parse as the next request
                self.close_connection = True
                self._reply(413, {"error": str(e)})
            except (InvalidInputError, ValueError, KeyError) as e:
                with service.stats_lock:
                    service.stats["errors"] += 1
                self._reply(400, {"error": str(e)})
            except Exception as e:
                with service.stats_lock:
                    service.stats["errors"] += 1
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def warmup_aligner(aligner, durations_s, max_batch: int = 64,
                   sample_rate_hz: int = 16000) -> int:
    """Drive the bucket shapes cold traffic would hit, once each.

    Serving cold-start discipline: the first use of a (B, N_pad, S_pad)
    batch shape pays cuDNN's algorithm choice, the allocator's first
    blocks and, once per process, the kernel library's load; without
    warmup the first unlucky request eats them. For each duration this
    drives every pow2 batch size up to max_batch —
    the exact shapes the batch engine's pad_batch emits. Durations should
    sit on the pow2 audio grid (e.g. 4, 8, 16, 32 s); off-grid values warm
    the bucket they round up into. Returns the number of (duration, B)
    shapes driven. Transcripts beyond ~120 tokens occupy a second token
    bucket not covered here.
    """
    rng = np.random.default_rng(0)
    # a transcript guaranteed alignable under this vocab
    chars = sorted(k for k in aligner.vocab
                   if len(k) == 1 and k != "|" and k.isalpha())
    word = "".join(chars[:3]) or "a"
    shapes = 0
    for dur in durations_s:
        audio = rng.normal(size=int(dur * sample_rate_hz)).astype(np.float32)
        b = 1
        while True:
            aligner.align_utterances([audio] * b, [word] * b,
                                     max_batch=max_batch)
            shapes += 1
            if b >= max_batch:
                break
            b = min(b * 2, max_batch)
    return shapes


def build_service_from_model_dir(
    model_dir: str | Path,
    compute_dtype: str = "bfloat16",
    window_ms: float = 25.0,
    max_batch: int = 64,
    quantize_int8: bool = False,
    units: str = "word",
    device: str = "cuda",
):
    """Model dir contract matches the CLI (config.json + vocab.json +
    model.safetensors). Loads with the port's own reader on the host, casts
    the compute weights to bf16 there (unless int8, which quantizes from
    the f32 weights), and builds a `BatchAligner` on `device` (`cuda`
    unless the caller asks for the CPU; no CUDA device raises). Returns
    (service, device label): the card's name, or "cpu"."""
    import torch

    from .config import Wav2Vec2ModelConfig, load_vocab
    from .models.params import load_safetensors_params
    from .parallel.batching import BatchAligner

    dev = select_device(device)
    model_dir = Path(model_dir)
    cfg = Wav2Vec2ModelConfig.load(model_dir / "config.json")
    # phoneme vocabs carry multi-codepoint symbols looked up verbatim
    vocab = load_vocab(model_dir / "vocab.json",
                       single_char_only=(units != "phoneme"))
    params = load_safetensors_params(
        model_dir / "model.safetensors", cfg,
        # cast host-side so the upload ships bf16 (half the transfer and
        # device memory); int8 mode quantizes from the f32 weights instead
        compute_weights_dtype=(
            torch.bfloat16 if compute_dtype == "bfloat16" and not quantize_int8
            else None
        ),
    )
    aligner = BatchAligner(
        cfg, params, vocab, compute_dtype=compute_dtype, device=dev,
        quantize_int8=quantize_int8, units=units,
    )
    service = AlignmentService(aligner, window_ms=window_ms,
                               max_batch=max_batch)
    return service, device_label(dev)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model-dir", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--window-ms", type=float, default=25.0)
    p.add_argument("--max-batch", type=int, default=64)
    p.add_argument("--compute-dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--quantize-int8", action="store_true")
    p.add_argument("--units", default="word", choices=["word", "phoneme"],
                   help="phoneme: per-phone timing units (phoneme-CTC "
                        "vocab symbols looked up verbatim)")
    p.add_argument("--max-streams", type=int, default=32,
                   help="max concurrent live /stream sessions")
    p.add_argument("--stream-idle-timeout", type=float, default=600.0,
                   help="seconds of inactivity before a live stream "
                        "session is reaped")
    p.add_argument("--max-body-mb", type=int, default=256,
                   help="reject request bodies larger than this (HTTP 413)")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default; exits non-zero without "
                        "a CUDA device) or cpu")
    p.add_argument(
        "--warmup-seconds", default="",
        help="comma-separated durations (s) to drive before serving, "
             "e.g. '8,16' — every pow2 batch size up to --max-batch is "
             "driven once per duration, so cold traffic never pays a "
             "shape's first use",
    )
    args = p.parse_args(argv)

    try:
        service, device = build_service_from_model_dir(
            args.model_dir, compute_dtype=args.compute_dtype,
            window_ms=args.window_ms, max_batch=args.max_batch,
            quantize_int8=args.quantize_int8, units=args.units,
            device=args.device,
        )
    except InvalidInputError as e:
        raise SystemExit(f"error: {e}") from None
    if args.warmup_seconds.strip():
        durations = [float(d) for d in args.warmup_seconds.split(",") if d.strip()]
        t0 = time.perf_counter()
        n = warmup_aligner(service.aligner, durations, max_batch=args.max_batch)
        print(f"[serve] warmed {n} batch shapes in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    streams = StreamRegistry(
        service.aligner, args.compute_dtype, max_streams=args.max_streams,
        idle_timeout_s=args.stream_idle_timeout, units=args.units,
    )
    server = AlignHTTPServer(
        (args.host, args.port),
        make_handler(service, device, streams,
                     max_body_bytes=args.max_body_mb * 1024 * 1024),
    )
    print(f"[serve] listening on http://{args.host}:{server.server_port} "
          f"(device={device}, window={args.window_ms} ms, "
          f"max_batch={args.max_batch})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        service.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
