"""PyTorch port vs the JAX package: the serving daemon (`serve.py`).

JAX's `tests/test_serve.py` cases run on the port's service at f32 on the
CPU (`device="cpu"`): healthz, float and pcm16 audio, concurrent batching,
bad requests, error isolation, stats, warmup shapes, subtitles, 413, the
stream lifecycle, reaping and clamps, a push not blocking the registry,
the sample-rate check and phoneme units. The model directory is written
once by the port's own writer; both packages serve it, and the same
requests give the same words with boundaries within one frame (f32
log-probs agree to ~1e-5, which can flip a Viterbi tie by one frame).
`main` without a CUDA device exits non-zero with the `--device cpu` hint.

The thread hazards the daemon exposes: the f32 precision block holds TF32
off while any thread is inside it, and concurrent first launches build
the kernel library once. Every HTTP call has a timeout and every server
binds 127.0.0.1:0.
"""

import base64
import json
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from wav2vec2_tpu import serve as jax_serve
from wav2vec2_tpu.config import Wav2Vec2ModelConfig as JaxCfg
from wav2vec2_tpu.models.params import init_params as jax_init_params
from wav2vec2_tpu_torch import serve
from wav2vec2_tpu_torch.align.online import OnlineAligner
from wav2vec2_tpu_torch.config import Wav2Vec2ModelConfig as TorchCfg
from wav2vec2_tpu_torch.models import layers
from wav2vec2_tpu_torch.models.params import params_from_jax, params_to_hf_flat_dict
from wav2vec2_tpu_torch.ops import cuda_build
from wav2vec2_tpu_torch.serve import (
    AlignHTTPServer,
    StreamRegistry,
    build_service_from_model_dir,
    make_handler,
    warmup_aligner,
)
from wav2vec2_tpu_torch.utils.checkpoint import save_safetensors

CONFIG = dict(
    model_type="wav2vec2",
    hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
    intermediate_size=64, conv_dim=[16, 16], conv_kernel=[10, 3],
    conv_stride=[5, 2], num_conv_pos_embeddings=16,
    num_conv_pos_embedding_groups=4, pad_token_id=0, vocab_size=32,
    do_stable_layer_norm=False, feat_extract_norm="group", conv_bias=False,
)
VOCAB = {"<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3, "|": 4}
for _i, _c in enumerate("ETAONIHSRDLUMWCFGYPBVKXJQZ"):
    VOCAB[_c] = 5 + _i
STRIDE_MS = 20.0


def _write_model(d, config, vocab, seed):
    jcfg = JaxCfg.from_dict(config)
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(seed)))
    (d / "config.json").write_text(json.dumps(config))
    (d / "vocab.json").write_text(json.dumps(vocab))
    save_safetensors(d / "model.safetensors",
                     params_to_hf_flat_dict(params_from_jax(tree), TorchCfg.from_dict(config)))
    return d


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return _write_model(tmp_path_factory.mktemp("port_serve_model"), CONFIG, VOCAB, 0)


def _start(service, device, streams=None):
    httpd = AlignHTTPServer(("127.0.0.1", 0), make_handler(service, device, streams))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_port}"


@pytest.fixture(scope="module")
def server(model_dir):
    service, device = build_service_from_model_dir(
        model_dir, compute_dtype="float32", window_ms=30.0, max_batch=8, device="cpu")
    httpd, url = _start(service, device)
    yield url, service
    httpd.shutdown()
    service.close()


def _req(url, path, method="POST", payload=None, timeout=120):
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(url + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post(url, payload, timeout=120):
    return _req(url, "/align", payload=payload, timeout=timeout)


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=30) as r:
        return r.status, json.loads(r.read())


def test_healthz(server):
    url, _ = server
    status, body = _get(url, "/healthz")
    assert status == 200 and body == {"status": "ok", "device": "cpu"}


def test_align_float_audio(server):
    url, _ = server
    rng = np.random.default_rng(0)
    status, body = _post(url, {"audio": rng.normal(0, 0.1, 8000).astype(float).tolist(),
                               "sample_rate_hz": 16000, "transcript": "HELLO WORLD"})
    assert status == 200, body
    assert [w["word"] for w in body["words"]] == ["HELLO", "WORLD"]
    assert all(w["end_ms"] > w["start_ms"] for w in body["words"])
    assert body["latency_ms"] > 0 and body["batch_size"] >= 1


def test_align_pcm16_base64(server):
    url, _ = server
    pcm = (np.random.default_rng(1).normal(0, 0.05, 8000) * 32767).astype("<i2")
    status, body = _post(url, {"audio": {"pcm16": base64.b64encode(pcm.tobytes()).decode()},
                               "transcript": "THE CAT"})
    assert status == 200, body
    assert [w["word"] for w in body["words"]] == ["THE", "CAT"]


def test_concurrent_requests_batch(server):
    url, _ = server
    rng = np.random.default_rng(2)
    audios = [rng.normal(0, 0.1, 8000).astype(float).tolist() for _ in range(6)]
    results = [None] * 6

    def one(i):
        results[i] = _post(url, {"audio": audios[i], "transcript": "GOOD DAY"})

    threads = [threading.Thread(target=one, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    assert all(r is not None and r[0] == 200 for r in results), results
    assert max(r[1]["batch_size"] for r in results) >= 2


def test_bad_requests(server):
    url, _ = server
    status, body = _post(url, {"audio": [0.0] * 100, "sample_rate_hz": 8000,
                               "transcript": "A"})
    assert status == 400 and "16000" in body["error"]
    status, _ = _post(url, {"transcript": "A"})
    assert status == 400
    status, body = _post(url, {"audio": [0.01] * 200,
                               "transcript": "AN EXTREMELY LONG TRANSCRIPT THAT CANNOT FIT"})
    assert status == 400 and "too short" in body["error"]
    assert _get(url, "/healthz")[0] == 200


def test_error_isolation_in_batch(server):
    url, _ = server
    rng = np.random.default_rng(3)
    audios = [rng.normal(0, 0.1, 8000).astype(float).tolist() for _ in range(4)]
    results = [None] * 4

    def one(i):
        payload = ({"audio": [0.01] * 200,
                    "transcript": "AN EXTREMELY LONG TRANSCRIPT THAT CANNOT FIT"}
                   if i == 1 else {"audio": audios[i], "transcript": "HELLO"})
        results[i] = _post(url, payload)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    codes = [r[0] for r in results]
    assert codes[1] == 400
    assert all(c == 200 for i, c in enumerate(codes) if i != 1), results


def test_stats(server):
    url, service = server
    for _ in range(2):
        _post(url, {"audio": [0.0] * 100, "sample_rate_hz": 8000, "transcript": "A"})
    _post(url, {"audio": np.random.default_rng(4).normal(0, 0.1, 8000).tolist(),
                "transcript": "THE"})
    status, body = _get(url, "/stats")
    assert status == 200
    assert set(body) == {"requests", "errors", "utterances_aligned", "audio_seconds",
                         "batches", "batch_size_histogram", "realtime_factor",
                         "uptime_seconds"}
    assert body["requests"] >= 3 and body["errors"] >= 2
    assert body["utterances_aligned"] >= 1 and body["audio_seconds"] > 0
    assert isinstance(body["batch_size_histogram"], dict)
    assert body["realtime_factor"] is None or body["realtime_factor"] > 0


def test_empty_transcript_yields_no_words(server):
    url, _ = server
    status, body = _post(url, {"audio": [0.01] * 4000, "transcript": "   "})
    assert status == 200 and body["words"] == []


def test_warmup_aligner_drives_pow2_shapes(server):
    _, service = server
    assert warmup_aligner(service.aligner, [0.25], max_batch=4, sample_rate_hz=16000) == 3


def test_align_subtitle_format(server):
    url, _ = server
    audio = np.random.default_rng(3).normal(size=4000).astype(np.float32).tolist()
    code, out = _post(url, {"audio": audio, "transcript": "THE CAT", "format": "vtt"})
    assert code == 200 and out["subtitles"].startswith("WEBVTT") and "words" not in out
    code, out = _post(url, {"audio": audio, "transcript": "THE CAT", "format": "srt"})
    assert code == 200 and out["subtitles"].startswith("1\n")
    code, out = _post(url, {"audio": audio, "transcript": "THE CAT", "format": "nope"})
    assert code == 400 and "unknown format" in out["error"]


def test_unknown_paths_and_backend_failure(server, monkeypatch):
    url, service = server
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(url + "/nope", timeout=30)
    assert e.value.code == 404
    req = urllib.request.Request(url + "/elsewhere", data=b"{}", method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 404

    def boom(*a, **k):
        raise RuntimeError("backend exploded")

    monkeypatch.setattr(service.aligner, "align_utterances", boom)
    code, out = _post(url, {"audio": [0.1] * 2000, "transcript": "THE"})
    assert code == 500 and "RuntimeError" in out["error"]


def test_oversized_body_rejected_413(server):
    url, _ = server
    req = urllib.request.Request(url + "/align", data=b"x", method="POST",
                                 headers={"Content-Type": "application/json",
                                          "Content-Length": str(1 << 40)})
    try:
        urllib.request.urlopen(req, timeout=30)
        raise AssertionError("an oversized body was accepted")
    except urllib.error.HTTPError as e:
        assert e.code == 413 and b"cap" in e.read()
    except urllib.error.URLError:
        pass  # the stack may abort a connection whose body is short of its length
    assert serve.MAX_BODY_BYTES == jax_serve.MAX_BODY_BYTES


@pytest.fixture(scope="module")
def stream_server(model_dir):
    service, device = build_service_from_model_dir(
        model_dir, compute_dtype="float32", window_ms=30.0, max_batch=4, device="cpu")
    httpd, url = _start(service, device, StreamRegistry(service.aligner, "float32",
                                                        max_streams=2))
    yield url
    httpd.shutdown()
    service.close()


def test_stream_session_lifecycle(stream_server):
    url = stream_server
    rng = np.random.default_rng(4)
    code, out = _req(url, "/stream", payload={"transcript": "THE CAT", "chunk_sec": 0.5,
                                             "overlap_sec": 0.1, "finalize_margin_sec": 0.2})
    assert code == 200
    sid = out["stream_id"]
    total_new = 0
    for _ in range(4):
        code, out = _req(url, f"/stream/{sid}",
                         payload={"audio": rng.normal(size=4000).astype(np.float32).tolist()})
        assert code == 200
        total_new += len(out["words"])
    code, out = _req(url, f"/stream/{sid}/flush")
    assert code == 200 and [w["word"] for w in out["words"]] == ["THE", "CAT"]
    assert total_new <= len(out["words"])
    assert _req(url, f"/stream/{sid}", payload={"audio": [0.0] * 100})[0] == 404
    sids = []
    for _ in range(2):
        code, out = _req(url, "/stream", payload={"transcript": "THE"})
        assert code == 200
        sids.append(out["stream_id"])
    code, out = _req(url, "/stream", payload={"transcript": "THE"})
    assert code == 400 and "too many live streams" in out["error"]
    for sid in sids:
        assert _req(url, f"/stream/{sid}", method="DELETE")[0] == 200
    assert _req(url, "/stream/nope/flush")[0] == 404


def test_stream_push_rejects_wrong_sample_rate(stream_server):
    url = stream_server
    _, out = _req(url, "/stream", payload={"transcript": "THE"})
    sid = out["stream_id"]
    code, out = _req(url, f"/stream/{sid}", payload={"audio": [0.0] * 100,
                                                     "sample_rate_hz": 8000})
    assert code == 400 and "16000" in out["error"]
    _req(url, f"/stream/{sid}", method="DELETE")


def test_stream_registry_reaping_and_clamps(model_dir):
    service, _ = build_service_from_model_dir(model_dir, compute_dtype="float32",
                                              max_batch=2, device="cpu")
    try:
        reg = StreamRegistry(service.aligner, "float32", max_streams=1, idle_timeout_s=0.2)
        reg.start("THE")
        time.sleep(0.3)
        sid2 = reg.start("CAT")  # would raise "too many" without reaping
        reg.delete(sid2)
        sid3 = reg.start("THE", chunk_sec=10_000, overlap_sec=0.0, finalize_margin_sec=-5)
        sess = reg._sessions[sid3].aligner
        assert sess.chunk <= 30 * 16000 and sess.device.type == "cpu"
        assert sess.margin_frames >= int(0.5 * 1000 / STRIDE_MS)
        reg.delete(sid3)
        with pytest.raises(KeyError, match="deleted"):
            reg.push(sid3, np.zeros(100, np.float32))
        reg2 = StreamRegistry(service.aligner, "float32", max_streams=2, idle_timeout_s=0.05)
        sid4 = reg2.start("THE")
        time.sleep(0.1)
        with reg2._lock:
            reg2._reap_locked()
        with pytest.raises(KeyError, match="expired"):
            reg2.push(sid4, np.zeros(100, np.float32))
        sid5 = reg2.start("CAT")
        reg2.push(sid5, np.random.default_rng(0).normal(size=4000).astype(np.float32))
        reg2.flush(sid5)
        with pytest.raises(KeyError, match="flushed"):
            reg2.flush(sid5)
        with pytest.raises(KeyError):
            reg2.delete("deadbeef")
    finally:
        service.close()


def test_stream_push_does_not_block_registry(model_dir):
    service, _ = build_service_from_model_dir(model_dir, compute_dtype="float32",
                                              max_batch=2, device="cpu")
    try:
        reg = StreamRegistry(service.aligner, "float32", max_streams=4)
        sid_slow = reg.start("THE")

        class SlowAligner:
            def push(self, audio):
                time.sleep(1.0)
                return []

        reg._sessions[sid_slow].aligner = SlowAligner()
        t = threading.Thread(target=reg.push, args=(sid_slow, np.zeros(100, np.float32)))
        t.start()
        time.sleep(0.1)
        t0 = time.perf_counter()
        reg.delete(reg.start("CAT"))
        elapsed = time.perf_counter() - t0
        t.join(timeout=30)
        assert elapsed < 0.5, f"registry blocked {elapsed:.2f}s behind a push"
    finally:
        service.close()


def test_concurrent_streams_and_align_traffic_match_alone(model_dir):
    """Four /stream sessions pushed from their own threads while /align
    requests run: each flush equals the same stream run alone in process
    (same words, boundaries within one frame), and every /align is 200."""
    service, device = build_service_from_model_dir(model_dir, compute_dtype="float32",
                                                   window_ms=20.0, max_batch=4, device="cpu")
    httpd, url = _start(service, device, StreamRegistry(service.aligner, "float32"))
    rng = np.random.default_rng(11)
    texts = ["THE CAT SAT", "A DOG RAN FAR", "GOOD DAY TO YOU", "HELLO THERE WORLD"]
    audios = [rng.normal(0, 0.1, 40_000).astype(np.float32) for _ in texts]
    knobs = {"chunk_sec": 1.0, "overlap_sec": 0.25, "finalize_margin_sec": 0.5}
    results, aligned = [None] * 4, []
    try:
        def stream(i):
            _, out = _req(url, "/stream", payload={"transcript": texts[i], **knobs})
            sid = out["stream_id"]
            for j in range(0, len(audios[i]), 5120):
                code, _ = _req(url, f"/stream/{sid}",
                               payload={"audio": audios[i][j: j + 5120].tolist()})
                assert code == 200
            results[i] = _req(url, f"/stream/{sid}/flush")

        def align():
            for k in range(4):
                aligned.append(_post(url, {"audio": audios[k][:16000].tolist(),
                                           "transcript": texts[k]})[0])

        threads = [threading.Thread(target=stream, args=(i,)) for i in range(4)]
        threads.append(threading.Thread(target=align))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert aligned == [200] * 4
        for i, res in enumerate(results):
            assert res is not None and res[0] == 200, res
            solo = OnlineAligner(service.aligner.cfg, service.aligner.params, VOCAB, texts[i],
                                 device="cpu", **knobs)
            solo.push(audios[i])
            want = solo.flush().words
            got = res[1]["words"]
            assert [w["word"] for w in got] == [w.word for w in want] == texts[i].split()
            for g, w in zip(got, want):
                assert abs(g["start_ms"] - w.start_ms) <= STRIDE_MS
                assert abs(g["end_ms"] - w.end_ms) <= STRIDE_MS
    finally:
        httpd.shutdown()
        service.close()


def test_same_directory_served_by_both_packages(model_dir):
    port, port_dev = build_service_from_model_dir(model_dir, compute_dtype="float32",
                                                  window_ms=20.0, max_batch=4, device="cpu")
    ref, _ = jax_serve.build_service_from_model_dir(model_dir, compute_dtype="float32",
                                                    window_ms=20.0, max_batch=4)
    port_httpd, port_url = _start(port, port_dev)
    ref_httpd, ref_url = _start(ref, "cpu")
    rng = np.random.default_rng(12)
    try:
        for n, text in ((8000, "HELLO WORLD"), (12000, "THE QUICK BROWN FOX"),
                        (20000, "JUMPS OVER THE LAZY DOG")):
            payload = {"audio": rng.normal(0, 0.1, n).astype(float).tolist(),
                       "transcript": text}
            (c1, got), (c2, want) = _post(port_url, payload), _post(ref_url, payload)
            assert c1 == c2 == 200
            assert [w["word"] for w in got["words"]] == [w["word"] for w in want["words"]] \
                == text.split()
            for g, w in zip(got["words"], want["words"]):
                assert abs(g["start_ms"] - w["start_ms"]) <= STRIDE_MS
                assert abs(g["end_ms"] - w["end_ms"]) <= STRIDE_MS
    finally:
        port_httpd.shutdown()
        ref_httpd.shutdown()
        port.close()
        ref.close()


def test_serve_phoneme_units(tmp_path):
    vocab = {"<pad>": 0, "|": 4, "a": 5, "ɛ̃": 6, "tʃ": 7, "k": 8, "u": 9}
    d = _write_model(tmp_path, {**CONFIG, "vocab_size": 16}, vocab, 2)
    service, device = build_service_from_model_dir(d, compute_dtype="float32", window_ms=20.0,
                                                   max_batch=4, units="phoneme", device="cpu")
    httpd, url = _start(service, device, StreamRegistry(service.aligner, "float32",
                                                        units="phoneme"))
    try:
        audio = (np.random.default_rng(3).normal(size=48000) * 0.1).astype(np.float32)
        status, body = _post(url, {"audio": audio.tolist(), "transcript": "a ɛ̃ tʃ u"})
        assert status == 200, body
        assert [w["word"] for w in body["words"]] == ["a", "ɛ̃", "tʃ", "u"]
        status, body = _req(url, "/stream", payload={
            "transcript": "a ɛ̃ tʃ u", "chunk_sec": 1.0, "overlap_sec": 0.25,
            "finalize_margin_sec": 0.5}, timeout=60)
        assert status == 200, body
        sid = body["stream_id"]
        streamed = []
        for i in range(0, len(audio), 2000):
            status, out = _req(url, f"/stream/{sid}",
                               payload={"audio": audio[i:i + 2000].tolist()}, timeout=60)
            assert status == 200, out
            streamed.extend(out["words"])
        status, out = _req(url, f"/stream/{sid}/flush", timeout=60)
        assert status == 200 and [w["word"] for w in out["words"]] == ["a", "ɛ̃", "tʃ", "u"]
        for s, w in zip(streamed, out["words"]):
            assert (s["word"], s["start_ms"], s["end_ms"]) == \
                (w["word"], w["start_ms"], w["end_ms"])
    finally:
        httpd.shutdown()
        service.close()


def test_int8_service_builds_from_the_f32_weights(model_dir):
    service, _ = build_service_from_model_dir(model_dir, compute_dtype="bfloat16",
                                              quantize_int8=True, max_batch=2, device="cpu")
    try:
        q = service.aligner.params["encoder"]["layers"]["attention"]["q_proj"]
        assert q["kernel_q"].dtype == torch.int8 and q["scale"].dtype == torch.float32
        out, bs = service.submit(np.random.default_rng(5).normal(0, 0.1, 8000)
                                 .astype(np.float32), "HELLO WORLD")
        assert [w.word for w in out.words] == ["HELLO", "WORLD"] and bs == 1
    finally:
        service.close()


def test_main_without_cuda_exits_with_the_cpu_hint(model_dir, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        serve.main(["--model-dir", str(model_dir), "--port", "0"])
    assert exc.value.code not in (0, None) and "--device cpu" in str(exc.value.code)
    with pytest.raises(SystemExit) as exc:
        serve.main(["--model-dir", str(model_dir), "--device", "tpu"])
    assert "unknown --device" in str(exc.value.code)


def test_f32_precision_holds_tf32_off_while_any_thread_is_inside(monkeypatch):
    """Thread A enters, thread B enters, A leaves while B is still inside:
    TF32 must stay off for B, and come back only when B leaves."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    a_in, b_in, a_out = threading.Event(), threading.Event(), threading.Event()
    seen = {}

    def thread_a():
        with layers.full_f32_precision():
            a_in.set()
            b_in.wait(10)
        a_out.set()

    def thread_b():
        a_in.wait(10)
        with layers.full_f32_precision():
            b_in.set()
            a_out.wait(10)
            seen["inside"] = (torch.backends.cuda.matmul.allow_tf32,
                              torch.backends.cudnn.allow_tf32)
        seen["after"] = (torch.backends.cuda.matmul.allow_tf32,
                         torch.backends.cudnn.allow_tf32)

    threads = [threading.Thread(target=thread_a), threading.Thread(target=thread_b)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert seen == {"inside": (False, False), "after": (True, True)}
    with layers.full_f32_precision():
        with layers.full_f32_precision():
            pass
        assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32


def test_kernel_library_builds_once_under_concurrent_first_use(monkeypatch):
    calls = []

    def slow_build(force=False):
        calls.append(threading.get_ident())
        time.sleep(0.2)
        return {"library": "stub", "seconds": 0.2, "compiler_output": ""}

    loaded = object()
    monkeypatch.setattr(cuda_build, "build", slow_build)
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", lambda path: loaded)
    monkeypatch.setattr(cuda_build, "_library", None)
    got = []
    threads = [threading.Thread(target=lambda: got.append(cuda_build.library()))
               for _ in range(16)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(calls) == 1 and got == [loaded] * 16
