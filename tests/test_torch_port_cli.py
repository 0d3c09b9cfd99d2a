"""PyTorch port vs the JAX package: the `alignment_report` CLI on the CPU.

One tiny model directory (written by the port's safetensors writer from
seeded JAX-layout weights) and one LibriSpeech-layout FLAC dataset whose
utterances fill several buckets go through both CLIs at f32:

- textgrid mode, batch (the port's `align_stream`) and single
  (`--no-batch`): the same words, boundaries within one frame stride;
- json mode over the same TextGrid references: equal reports apart from
  the time of the run, with every word boundary equal and the float
  metrics (confidences from f32 log-probs) within 1e-5 relative;
- perf mode: the same records apart from timings, the device label and
  the memory readings (the port's device readings are null on the CPU);
- srt and vtt modes: the same cues, times within one frame stride;
- phoneme units (`--units phoneme`, a vocab with multi-codepoint
  symbols), batch and single: the same units within one frame stride;
- `compare_textgrids`: the same metrics on the same pairs;
- the port's CLI targets cuda by default and exits non-zero where no CUDA
  device is present, `--runtime onnx` too; on the CPU `--runtime onnx`
  exits non-zero where the directory has no model.onnx (its end-to-end
  run is in tests/test_torch_port_onnx.py).
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from wav2vec2_tpu.cli import compare_textgrids as jax_compare
from wav2vec2_tpu.cli.alignment_report import run as jax_run
from wav2vec2_tpu.data.textgrid import parse_textgrid_file
from wav2vec2_tpu_torch.cli import compare_textgrids as port_compare
from wav2vec2_tpu_torch.cli.alignment_report import run as port_run
from wav2vec2_tpu_torch.config import Wav2Vec2ModelConfig
from wav2vec2_tpu_torch.data.flac_encoder import write_flac
from wav2vec2_tpu_torch.models.params import params_from_jax, params_to_hf_flat_dict
from wav2vec2_tpu_torch.utils.checkpoint import save_safetensors

# the JAX package's grouping engine and FLAC decoder, built privately for
# this module (test_torch_port_native.py says why)
from test_torch_port_native import private_jax_natives  # noqa: E402,F401

REPO = Path(__file__).resolve().parent.parent

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
# a phoneme-CTC vocab: multi-codepoint symbols the word path's single-char
# rule would drop
PHONEME_VOCAB = {"<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3, "|": 4,
                 "a": 5, "b": 6, "k": 7, "u": 8, "ɛ̃": 9, "tʃ": 10, "ʃ": 11,
                 "ɔ̃": 12, "ə": 13, "i": 14, "s": 15}
# (samples, transcript): with 0.5 s buckets these fill four audio buckets
WORD_CASES = [(7000, "THE CAT"), (16000, "HELLO WORLD"), (30000, "GOOD DAY TO YOU"),
              (9000, "A DOG"), (40000, "OVER THE LAZY DOG AGAIN")]
PHONEME_CASES = [(9000, "a tʃ ɛ̃ b"), (20000, "k u | a tʃ | ɛ̃ ə"), (12000, "ʃ ɔ̃ i s")]
STRIDE_MS = 20.0
BUCKET = ["--audio-bucket-seconds", "0.5"]


def _write_model(d: Path, vocab: dict, seed: int) -> Path:
    from wav2vec2_tpu.config import Wav2Vec2ModelConfig as JaxCfg
    from wav2vec2_tpu.models.params import init_params as jax_init_params

    cfg_dict = {**CONFIG, "vocab_size": max(vocab.values()) + 1}
    params = params_from_jax(jax.tree.map(
        np.asarray, jax_init_params(JaxCfg.from_dict(cfg_dict), jax.random.PRNGKey(seed))))
    d.mkdir(parents=True)
    (d / "config.json").write_text(json.dumps(cfg_dict))
    (d / "vocab.json").write_text(json.dumps(vocab, ensure_ascii=False))
    save_safetensors(d / "model.safetensors",
                     params_to_hf_flat_dict(params, Wav2Vec2ModelConfig.from_dict(cfg_dict)))
    return d


def _write_dataset(root: Path, cases, seed: int) -> Path:
    base = root / "LibriSpeech" / "test-clean" / "1" / "2"
    base.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    lines = []
    for i, (n, text) in enumerate(cases):
        uid = f"1-2-{i:04d}"
        x = np.clip(np.cumsum(rng.integers(-80, 80, size=n)), -30000, 30000)
        write_flac(base / f"{uid}.flac", x.astype(np.int64), 16000)
        lines.append(f"{uid} {text}")
    (base / "1-2.trans.txt").write_text("\n".join(lines), encoding="utf-8")
    return root


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return _write_model(tmp_path_factory.mktemp("cli_model") / "m", VOCAB, 3)


@pytest.fixture(scope="module")
def phoneme_model_dir(tmp_path_factory):
    return _write_model(tmp_path_factory.mktemp("cli_model") / "ph", PHONEME_VOCAB, 4)


@pytest.fixture
def dataset(tmp_path):
    return _write_dataset(tmp_path / "data", WORD_CASES, 0)


def _args(model_dir, root, *extra):
    return ["--model-dir", str(model_dir), "--dataset-root", str(root),
            "--compute-dtype", "float32", "--device", "cpu", *BUCKET, *extra]


def _both(model_dir, root, *extra, suffixes=("_port", "_jax")):
    """Run the port's CLI, then the JAX one, on the same arguments; the
    per-case outputs get the two suffixes."""
    assert port_run(_args(model_dir, root, *extra, "--textgrid-suffix", suffixes[0])) == 0
    assert jax_run(_args(model_dir, root, *extra, "--textgrid-suffix", suffixes[1])) == 0


def _tg_words(path):
    tier = parse_textgrid_file(path).tier("words")
    return [(iv.text, iv.xmin * 1000.0, iv.xmax * 1000.0)
            for iv in tier.intervals if iv.text.strip()]


def _assert_pairs_agree(root, ext, read, n_cases):
    ports = sorted(Path(root).rglob(f"*_port.{ext}"))
    assert len(ports) == n_cases
    n_words = 0
    for port in ports:
        got = read(port)
        want = read(port.with_name(port.name.replace("_port", "_jax")))
        assert [w[0] for w in got] == [w[0] for w in want], port.name
        for g, w in zip(got, want):
            assert abs(g[1] - w[1]) <= STRIDE_MS + 1e-6 and abs(g[2] - w[2]) <= STRIDE_MS + 1e-6
        n_words += len(got)
    assert n_words > 0


@pytest.mark.parametrize("batch", ["--batch", "--no-batch"])
def test_cli_textgrid_matches_jax(model_dir, dataset, batch):
    _both(model_dir, dataset, "--output-format", "textgrid", batch)
    _assert_pairs_agree(dataset, "TextGrid", _tg_words, len(WORD_CASES))


def _cues(path):
    """(text, start_ms, end_ms) per cue of an SRT or WebVTT file."""
    out = []
    for block in path.read_text().strip().split("\n\n"):
        lines = [l for l in block.splitlines() if "-->" in l or (l and not l.isdigit()
                                                                 and l != "WEBVTT")]
        if not lines:
            continue
        start, end = lines[0].split(" --> ")

        def ms(t):
            h, m, s = t.replace(",", ".").split(":")
            return (int(h) * 3600 + int(m) * 60 + float(s)) * 1000.0

        out.append((" ".join(lines[1:]), ms(start), ms(end)))
    return out


@pytest.mark.parametrize("fmt", ["srt", "vtt"])
def test_cli_subtitles_match_jax(model_dir, dataset, fmt):
    _both(model_dir, dataset, "--output-format", fmt)
    _assert_pairs_agree(dataset, fmt, _cues, len(WORD_CASES))


def _assert_json_close(got, want, path="report"):
    """Equal structure, strings, ints and nulls; floats (confidences and
    their aggregates, from f32 log-probs that agree to ~1e-6) within 1e-5
    relative."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_json_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_json_close(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert isinstance(got, (int, float)) and got == pytest.approx(want, rel=1e-5, abs=1e-7), path
    else:
        assert got == want and type(got) is type(want), path


def test_cli_json_report_matches_jax(model_dir, dataset, tmp_path):
    # references first (the JAX CLI's TextGrids), so json mode scores them
    assert jax_run(_args(model_dir, dataset, "--output-format", "textgrid")) == 0
    out_port, out_jax = tmp_path / "port.json", tmp_path / "jax.json"
    assert port_run(_args(model_dir, dataset, "--output-format", "json",
                          "--out", str(out_port))) == 0
    assert jax_run(_args(model_dir, dataset, "--output-format", "json",
                         "--out", str(out_jax))) == 0
    got, want = json.loads(out_port.read_text()), json.loads(out_jax.read_text())
    assert got["meta"].pop("generated_at") and want["meta"].pop("generated_at")
    assert got["meta"]["device"] == want["meta"]["device"] == "cpu"
    assert got["meta"]["case_count"] == len(WORD_CASES)
    _assert_json_close(got, want)


def test_cli_perf_mode_matches_jax(model_dir, dataset, tmp_path):
    out_port, out_jax = tmp_path / "port.jsonl", tmp_path / "jax.jsonl"
    perf = ["--output-format", "perf", "--perf-warmup", "1", "--perf-repeats", "2",
            "--limit", "3", "--perf-append", "--perf-scaling-report"]
    assert port_run(_args(model_dir, dataset, *perf, "--perf-out", str(out_port))) == 0
    assert jax_run(_args(model_dir, dataset, *perf, "--perf-out", str(out_jax))) == 0
    got = [json.loads(l) for l in out_port.read_text().splitlines()]
    want = [json.loads(l) for l in out_jax.read_text().splitlines()]
    assert len(got) == len(want) == 3
    same = ("utterance_id", "audio_path", "duration_ms", "num_frames_t", "state_len",
            "ts_product", "vocab_size", "dtype", "frame_stride_ms", "warmup", "repeats",
            "aggregate")
    for g, w in zip(got, want):
        assert {k: g[k] for k in same} == {k: w[k] for k in same}
        assert g["device"] == "cpu"
        assert abs(g["align_ms_repeats"][0] - (g["dp_ms_repeats"][0] + g["conf_ms_repeats"][0]
                                               + g["group_ms_repeats"][0])) < 1e-6
        # repeat 0's memory: host RSS per stage; no device reading on the CPU
        assert set(g["memory"]) == set(w["memory"]) == {"forward", "post", "dp", "group", "conf"}
        for stage in g["memory"].values():
            assert stage["rss_peak"] > 0
            assert stage["gpu_used"] is None and stage["gpu_total"] is None
    summary = json.loads((tmp_path / "port.jsonl.summary.json").read_text())
    assert summary["aggregate"]["utterance_count"] == 3


def test_cli_torch_profile_writes_a_trace(model_dir, dataset, tmp_path):
    prof = tmp_path / "prof"
    assert port_run(_args(model_dir, dataset, "--output-format", "perf", "--perf-warmup", "0",
                          "--perf-repeats", "1", "--limit", "1", "--perf-out",
                          str(tmp_path / "p.jsonl"), "--torch-profile", str(prof))) == 0
    trace = json.loads((prof / "perf_trace.json").read_text())
    assert trace["traceEvents"]


@pytest.mark.parametrize("batch", ["--batch", "--no-batch"])
def test_cli_phoneme_units_match_jax(phoneme_model_dir, tmp_path, batch):
    root = _write_dataset(tmp_path / "ph", PHONEME_CASES, 1)
    _both(phoneme_model_dir, root, "--output-format", "textgrid", "--units", "phoneme", batch)
    _assert_pairs_agree(root, "TextGrid", _tg_words, len(PHONEME_CASES))
    units = [w[0] for p in sorted(root.rglob("*_port.TextGrid")) for w in _tg_words(p)]
    assert {"tʃ", "ɛ̃", "ɔ̃"} <= set(units)


def test_compare_textgrids_matches_jax(model_dir, dataset, capsys):
    assert jax_run(_args(model_dir, dataset, "--output-format", "textgrid")) == 0
    assert port_run(_args(model_dir, dataset, "--output-format", "textgrid",
                          "--textgrid-suffix", "_port")) == 0
    capsys.readouterr()
    results = []
    for mod in (port_compare, jax_compare):
        rc = mod.run([str(dataset), "--suffix", "_port", "--extended"])
        results.append((rc, json.loads(capsys.readouterr().out)))
    assert results[0] == results[1]
    assert results[0][0] == 0 and results[0][1]["pairs_compared"] == len(WORD_CASES)


def test_cli_exits_without_cuda_by_default(model_dir, dataset, monkeypatch):
    args = ["--model-dir", str(model_dir), "--dataset-root", str(dataset),
            "--output-format", "textgrid"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA") as exc:
        port_run(args)
    assert exc.value.code not in (0, None)
    with pytest.raises(SystemExit, match="CUDA"):
        port_run(args + ["--runtime", "onnx"])
    with pytest.raises(SystemExit, match="model.onnx"):
        port_run(args + ["--device", "cpu", "--runtime", "onnx"])
    assert not list(dataset.rglob("*.TextGrid"))
    res = subprocess.run(
        [sys.executable, "-m", "wav2vec2_tpu_torch.cli.alignment_report", *args],
        cwd=str(REPO), capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "", "HOME": str(dataset)},
    )
    assert res.returncode != 0
    assert "CUDA" in res.stderr and "Traceback" not in res.stderr
    assert not list(dataset.rglob("*.TextGrid"))
