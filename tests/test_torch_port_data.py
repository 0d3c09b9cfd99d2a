"""PyTorch port vs the JAX package: the data and report layer on the CPU.

- FLAC: the port's encoder writes the same bytes as JAX's, and the port's
  decoder (its own build of `native/flac_decoder.cpp`) returns the same
  samples as JAX's, sample for sample, for every encoder strategy, stereo
  mode and bit depth; WAV likewise.
- TextGrid, SRT and WebVTT files written from the same words are
  byte-identical, and both parsers read the same tiers back.
- LibriSpeech discovery (transcripts and TextGrid references) finds the
  same cases; sentence reports, aggregates and the JSON report file are
  identical for the same words.
"""

import dataclasses
import json

import numpy as np
import pytest

from wav2vec2_tpu.align import report as jax_report
from wav2vec2_tpu.cli import json_report_formatter as jax_json
from wav2vec2_tpu.data import audio as jax_audio
from wav2vec2_tpu.data import flac as jax_flac
from wav2vec2_tpu.data import flac_encoder as jax_enc
from wav2vec2_tpu.data import librispeech as jax_ls
from wav2vec2_tpu.data import subtitles as jax_subs
from wav2vec2_tpu.data import textgrid as jax_tg
from wav2vec2_tpu.types import WordConfidenceStats as JaxStats
from wav2vec2_tpu.types import WordTiming as JaxWord
from wav2vec2_tpu_torch.align import report as port_report
from wav2vec2_tpu_torch.cli import json_report_formatter as port_json
from wav2vec2_tpu_torch.data import audio as port_audio
from wav2vec2_tpu_torch.data import flac as port_flac
from wav2vec2_tpu_torch.data import flac_encoder as port_enc
from wav2vec2_tpu_torch.data import librispeech as port_ls
from wav2vec2_tpu_torch.data import subtitles as port_subs
from wav2vec2_tpu_torch.data import textgrid as port_tg
from wav2vec2_tpu_torch.types import WordConfidenceStats, WordTiming

# the JAX package's grouping engine and FLAC decoder, built privately for
# this module (test_torch_port_native.py says why)
from test_torch_port_native import private_jax_natives  # noqa: E402,F401


def rand_pcm(n, seed=0, scale=2000, bits=16):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.integers(-scale // 20, scale // 20, size=n)) << (bits - 16)
    lim = 1 << (bits - 1)
    return np.clip(x, -lim, lim - 1).astype(np.int64)


FLAC_CASES = [
    ("verbatim", 1, 16), ("constant", 1, 16), ("fixed0", 1, 16), ("fixed1", 1, 16),
    ("fixed2", 1, 16), ("lpc1", 1, 16), ("fixed1", 2, 16), ("fixed2", 1, 24),
]


@pytest.mark.parametrize("strategy,channels,bits", FLAC_CASES)
def test_flac_encode_and_decode_identical(tmp_path, strategy, channels, bits):
    n = 9_000
    if strategy == "constant":
        x = np.full(n, 123, np.int64)
    elif channels == 2:
        x = np.stack([rand_pcm(n, 1, bits=bits), rand_pcm(n, 2, bits=bits)], axis=1)
    else:
        x = rand_pcm(n, seed=len(strategy), bits=bits)
    kw = dict(strategy=strategy, bits_per_sample=bits)
    if channels == 2:
        kw["stereo_mode"] = "mid-side"
    data = port_enc.encode_flac(x, 16000, **kw)
    assert data == jax_enc.encode_flac(x, 16000, **kw)
    p = tmp_path / "a.flac"
    port_enc.write_flac(p, x, 16000, **kw)
    for port_fn, jax_fn in ((port_flac.read_flac_raw, jax_flac.read_flac_raw),
                            (port_flac.read_flac_mono, jax_flac.read_flac_mono),
                            (port_flac.read_flac_mono_int16, jax_flac.read_flac_mono_int16),
                            (port_audio.read_audio_mono, jax_audio.read_audio_mono)):
        got, want = port_fn(p), jax_fn(p)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            if isinstance(w, np.ndarray):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
            else:
                assert g == w


def test_wav_read_identical(tmp_path):
    x = rand_pcm(4_321, seed=5).astype(np.int16)
    p = tmp_path / "a.wav"
    port_audio.write_wav_mono(p, x, 16000)
    q = tmp_path / "b.wav"
    jax_audio.write_wav_mono(q, x, 16000)
    assert p.read_bytes() == q.read_bytes()
    got, want = port_audio.read_audio_mono(p), jax_audio.read_audio_mono(p)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


def _words(cls_word, cls_stats, seed=0):
    rng = np.random.default_rng(seed)
    words, t = [], 0
    for w in ["THE", "QUICK", "BROWN", "FOX", "JUMPS", "OVER", "THE", "LAZY", "DOG",
              "WHILE", "SINGING"]:
        t += int(rng.integers(0, 400))
        d = int(rng.integers(60, 700))
        conf = float(rng.uniform(0, 1))
        words.append(cls_word(word=w, start_ms=t, end_ms=t + d, confidence=conf,
                              confidence_stats=cls_stats(mean_logp=-float(rng.uniform(0, 3)),
                                                         boundary_confidence=conf / 2,
                                                         mean_margin=float(rng.uniform(0, 2)))))
        t += d
    return words


@pytest.mark.parametrize("fmt", ["TextGrid", "srt", "vtt"])
def test_textgrid_and_subtitles_byte_identical(tmp_path, fmt):
    port_words, jax_words = _words(WordTiming, WordConfidenceStats), _words(JaxWord, JaxStats)
    transcript = " ".join(w.word for w in port_words)
    duration = port_words[-1].end_ms + 500
    audio = tmp_path / "u.flac"
    if fmt == "TextGrid":
        a = port_tg.write_textgrid(audio, transcript, port_words, duration, suffix="_port")
        b = jax_tg.write_textgrid(audio, transcript, jax_words, duration, suffix="_jax")
        got, want = port_tg.parse_textgrid_file(b), jax_tg.parse_textgrid_file(a)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert ([dataclasses.asdict(r) for r in port_tg.reference_words_from_textgrid(a)]
                == [dataclasses.asdict(r) for r in jax_tg.reference_words_from_textgrid(a)])
    else:
        a = port_subs.write_subtitles(audio, port_words, fmt, suffix="_port")
        b = jax_subs.write_subtitles(audio, jax_words, fmt, suffix="_jax")
    assert a.read_bytes() == b.read_bytes()
    assert len(a.read_bytes()) > 100


def _dataset(root):
    base = root / "LibriSpeech" / "test-other" / "7" / "8"
    base.mkdir(parents=True)
    lines = []
    for i in range(3):
        port_enc.write_flac(base / f"7-8-{i:04d}.flac", rand_pcm(4000 + 900 * i, i), 16000)
        lines.append(f"7-8-{i:04d} {'HELLO WORLD ' * (i + 1)}".strip())
    (base / "7-8.trans.txt").write_text("\n".join(lines))
    return root, base


def test_librispeech_cases_and_reports_identical(tmp_path):
    root, base = _dataset(tmp_path / "d")
    (p_root, p_subsets), (j_root, j_subsets) = (
        port_ls.resolve_dataset_base_and_subsets(root),
        jax_ls.resolve_dataset_base_and_subsets(root))
    assert (p_root, p_subsets) == (j_root, j_subsets)
    p_subsets = j_subsets = [s for s in p_subsets if s.exists()]
    assert p_subsets == [root / "LibriSpeech" / "test-other"]
    got = port_ls.load_cases_from_transcripts(p_root, p_subsets)
    want = jax_ls.load_cases_from_transcripts(j_root, j_subsets)
    assert [dataclasses.asdict(c) for c in got] == [dataclasses.asdict(c) for c in want]
    assert len(got) == 3

    # TextGrid references: json mode's case loader
    for c in got:
        port_tg.write_textgrid(p_root / c.audio_path, c.transcript,
                               _words(WordTiming, WordConfidenceStats, len(c.id))[:2], 3000)
    got = port_ls.load_cases_from_textgrids(p_root, p_subsets)
    want = jax_ls.load_cases_from_textgrids(j_root, j_subsets)
    assert [dataclasses.asdict(c) for c in got] == [dataclasses.asdict(c) for c in want]
    assert all(c.has_reference for c in got)
    assert port_ls.filter_cases(got, {"7-8-0001"}, 0, None)[0].id == "7-8-0001"

    sentences, jax_sentences = [], []
    for i, c in enumerate(got):
        pw = _words(WordTiming, WordConfidenceStats, i)[:3]
        jw = _words(JaxWord, JaxStats, i)[:3]
        sentences.append(port_report.compute_sentence_report(
            c.id, port_report.infer_split(c.audio_path), pw, c.reference_words, 3000))
        jax_sentences.append(jax_report.compute_sentence_report(
            c.id, jax_report.infer_split(c.audio_path), jw, want[i].reference_words, 3000))
    assert ([dataclasses.asdict(s) for s in sentences]
            == [dataclasses.asdict(s) for s in jax_sentences])
    meta = dict(generated_at="2026-01-01T00:00:00+00:00", model_path="m", device="cpu",
                frame_stride_ms=20.0, case_count=3)
    reports = [mod.Report(schema_version=1, meta=mod.Meta(**meta), sentences=s,
                          aggregates=mod.aggregate_reports(s))
               for mod, s in ((port_report, sentences), (jax_report, jax_sentences))]
    port_json.write_report(reports[0], tmp_path / "port.json")
    jax_json.write_report(reports[1], tmp_path / "jax.json")
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    assert json.loads((tmp_path / "port.json").read_text())["aggregates"]["counts"]["total"] == 3
