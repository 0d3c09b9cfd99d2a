"""PyTorch port vs the JAX package: the slice end to end, on the CPU.

- Batch entry: the port's BatchAligner and the JAX one (both f32, same
  weights, same audio) give equal word sequences with boundaries within
  one frame (f32 log-probs agree to ~1e-5, which can flip a Viterbi tie
  by at most a frame).
- Single-utterance entry: a model dir written by the port's own
  safetensors writer is built by both packages' ForcedAlignerBuilder;
  same words, boundaries within one frame, on both sides of the
  device-dispatch threshold.
- The port's safetensors reader/writer round-trip against the
  `safetensors` package.
- The port imports and runs its CPU slice (batch, single-utterance and
  long-form entries, a tiny conformer through the batch entry with the
  attention kernel switch on and off, forwards of the WavLM, mHuBERT +
  adapter, SEW, SEW-D and w2v-BERT families, the `alignment_report` CLI in
  textgrid, json and perf modes on a FLAC dataset, `OnlineAligner`, int8
  serving, the serving daemon's service and `doctor`) with jax,
  safetensors and transformers made unimportable.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax

from wav2vec2_tpu import AlignmentInput as JaxInput
from wav2vec2_tpu import ForcedAlignerBuilder as JaxBuilder
from wav2vec2_tpu import Wav2Vec2Config as JaxConfig
from wav2vec2_tpu.config import Wav2Vec2ModelConfig as JaxCfg
from wav2vec2_tpu.models.params import init_params as jax_init_params
from wav2vec2_tpu.parallel.batching import BatchAligner as JaxBatchAligner
from wav2vec2_tpu_torch import (
    AlignmentInput,
    BatchAligner,
    ForcedAlignerBuilder,
    InvalidInputError,
    Wav2Vec2Config,
)
from wav2vec2_tpu_torch.config import Wav2Vec2ModelConfig as TorchCfg
from wav2vec2_tpu_torch.models.params import params_from_jax, params_to_hf_flat_dict
from wav2vec2_tpu_torch.utils.checkpoint import load_safetensors, save_safetensors

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


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = JaxCfg.from_dict(CONFIG), TorchCfg.from_dict(CONFIG)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(3))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory, models):
    _, tcfg, _, tp = models
    d = tmp_path_factory.mktemp("torch_port_model")
    (d / "config.json").write_text(json.dumps(CONFIG))
    (d / "vocab.json").write_text(json.dumps(VOCAB))
    save_safetensors(d / "model.safetensors", params_to_hf_flat_dict(tp, tcfg))
    return d


def _assert_same_alignment(got, want, stride_ms):
    assert [w.word for w in got] == [w.word for w in want]
    assert got, "no words aligned"
    for g, w in zip(got, want):
        assert abs(g.start_ms - w.start_ms) <= stride_ms
        assert abs(g.end_ms - w.end_ms) <= stride_ms


def test_batch_aligner_matches_jax(models):
    jcfg, tcfg, jp, tp = models
    rng = np.random.default_rng(0)
    audios = [rng.normal(size=n).astype(np.float32) for n in (3000, 2100, 4000, 900)]
    texts = ["the quick brown fox", "jumps over", "the lazy dog again and", "hi"]
    got = BatchAligner(tcfg, tp, VOCAB, compute_dtype="float32", device="cpu") \
        .align_utterances(audios, texts, audio_multiple=1000, max_batch=2)
    want = JaxBatchAligner(jcfg, jp, VOCAB, compute_dtype="float32") \
        .align_utterances(audios, texts, audio_multiple=1000, max_batch=2)
    stride = tcfg.frame_stride_ms(16000)
    for g, w in zip(got, want):
        _assert_same_alignment(g.words, w.words, stride)
        assert g.frame_stats.blank_frame_ratio == pytest.approx(
            w.frame_stats.blank_frame_ratio, abs=0.05)


def test_submit_padded_batch_host_normalized_f32(models):
    """int16 rows normalized on the host by `normalize_audio` into a padded
    f32 batch, through both packages' default path: same paths' words as
    the JAX engine; device tensors come back unsynchronised."""
    from wav2vec2_tpu_torch.pipeline.runtime import normalize_audio

    jcfg, tcfg, jp, tp = models
    rng = np.random.default_rng(1)
    raw = (rng.normal(size=(2, 3200)) * 3000).astype(np.int16)
    a_l = np.array([3200, 2500], np.int32)
    audio = np.zeros((2, 3200), np.float32)
    for j, n in enumerate(a_l):
        audio[j, :n] = normalize_audio(raw[j, :n])
    seqs = [BatchAligner(tcfg, tp, VOCAB, "float32", device="cpu")._tokenize(t)
            for t in ("brown fox", "over the dog")]
    tokens = np.zeros((2, 128), np.int32)
    for j, s in enumerate(seqs):
        tokens[j, : len(s.tokens)] = s.tokens
    s_l = np.array([len(s.tokens) for s in seqs], np.int32)
    port = BatchAligner(tcfg, tp, VOCAB, "float32", device="cpu")
    handles = port.submit_padded_batch(audio, a_l, tokens, s_l, return_log_probs=True)
    assert len(handles) == 7 and all(isinstance(h, torch.Tensor) for h in handles)
    host = port.align_padded_batch(audio, a_l, tokens, s_l)
    np.testing.assert_array_equal(host[0], handles[0].numpy())
    jax_host = JaxBatchAligner(jcfg, jp, VOCAB, "float32") \
        .align_padded_batch(audio, a_l, tokens, s_l)
    np.testing.assert_array_equal(host[1], jax_host[1])  # t_lens
    stride = tcfg.frame_stride_ms(16000)
    got = port.group_batch(seqs, handles)
    from wav2vec2_tpu.align.grouping import group_into_words
    from wav2vec2_tpu.align.grouping.path_to_words import FrameEvidence
    for j, seq in enumerate(seqs):
        t_i = int(jax_host[1][j])
        ev = FrameEvidence(jax_host[2][j, :t_i], jax_host[3][j, :t_i],
                           jax_host[4][j, :t_i].astype(np.float64))
        want = group_into_words([(int(s), t) for t, s in enumerate(jax_host[0][j, :t_i])],
                                seq.tokens, seq.chars, seq.normalized_words, ev, 0, 4, stride)
        _assert_same_alignment(got[j].words, want, stride)


def test_drain_reads_the_host_copies_and_groups_alike(models):
    """The drain repair: `submit_padded_batch` returns `BatchHandles`, and
    `group_batch` waits on `copied` and reads `host` where the CUDA path
    left pinned copies (simulated here: device tensors replaced by
    garbage, a completed event), or copies the tensors itself; both give
    the words of the plain-tuple drain, and `align_padded_batch` the same
    arrays."""
    from wav2vec2_tpu_torch.parallel.batching import BatchHandles

    _, tcfg, _, tp = models
    port = BatchAligner(tcfg, tp, VOCAB, "float32", device="cpu")
    seqs = [port._tokenize(t) for t in ("brown fox jumps", "over the dog")]
    tokens = np.zeros((2, 128), np.int32)
    for j, s in enumerate(seqs):
        tokens[j, : len(s.tokens)] = s.tokens
    s_l = np.array([len(s.tokens) for s in seqs], np.int32)
    rng = np.random.default_rng(8)
    audio = rng.normal(size=(2, 3000)).astype(np.float32)
    a_l = np.array([3000, 2600], np.int32)
    handles = port.submit_padded_batch(audio, a_l, tokens, s_l)
    assert isinstance(handles, BatchHandles) and len(handles) == 6
    assert handles.host is None and handles.copied is None
    plain = port.group_batch(seqs, tuple(handles))

    class Completed:
        waited = False

        def synchronize(self):
            self.waited = True

    staged = BatchHandles(tuple(torch.full_like(h, -1) for h in handles))
    staged.host, staged.copied = tuple(h.clone() for h in handles), Completed()
    for outs in (port.group_batch(seqs, handles), port.group_batch(seqs, staged)):
        for got, want in zip(outs, plain):
            assert [(w.word, w.start_ms, w.end_ms, w.confidence) for w in got.words] == \
                [(w.word, w.start_ms, w.end_ms, w.confidence) for w in want.words]
            assert got.words
    assert staged.copied.waited
    for got, want in zip(port.align_padded_batch(audio, a_l, tokens, s_l), handles):
        np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("seconds", [0.1, 0.35])
def test_builder_matches_jax_builder(model_dir, seconds):
    """0.1 s (T*S below kernel_dp_threshold: host oracle) and 0.35 s
    (above it: the device DP, the plain version on the CPU)."""
    def paths(cls):
        return cls(model_path=str(model_dir / "model.safetensors"),
                   config_path=str(model_dir / "config.json"),
                   vocab_path=str(model_dir / "vocab.json"))

    cfg = paths(Wav2Vec2Config)
    cfg.device = "cpu"
    port = ForcedAlignerBuilder(cfg).build()
    ref = JaxBuilder(paths(JaxConfig)).build()
    rng = np.random.default_rng(2)
    samples = rng.normal(size=int(seconds * 16000)).astype(np.float32)
    text = "the quick brown fox jumps over the lazy dog near frozen rivers"
    n_states = len(port.tokenizer.tokenize(text, port.vocab, 0, 4).tokens)
    t_len = port.runtime_backend.model_cfg.conv_output_length(len(samples))
    assert (t_len * n_states >= port.hp.kernel_dp_threshold) == (seconds > 0.2)
    got = port.align(AlignmentInput(16000, samples, text))
    want = ref.align(JaxInput(16000, samples, text))
    _assert_same_alignment(got.words, want.words, port.frame_stride_ms())

    prof = port.align_profiled(AlignmentInput(16000, samples, text))
    assert [w.word for w in prof.output.words] == [w.word for w in got.words]
    t = prof.timings
    assert t.dp_ms + t.conf_ms + t.group_ms == pytest.approx(t.align_ms)
    assert prof.device == "cpu" and prof.num_frames_t == t_len


@pytest.mark.parametrize("pad_multiple", [1000, 4000])
def test_builder_injected_aligners_agree(model_dir, pad_multiple):
    """Through the builder's injection points, the host oracle and the
    device DP (forced either way) give bit-identical paths on the same
    log-probs, and the same words, at either padding multiple."""
    from wav2vec2_tpu_torch import normalize_audio
    from wav2vec2_tpu_torch.pipeline.defaults import ViterbiSequenceAligner

    cfg = Wav2Vec2Config(model_path=str(model_dir / "model.safetensors"),
                         config_path=str(model_dir / "config.json"),
                         vocab_path=str(model_dir / "vocab.json"), device="cpu")
    port = {b: ForcedAlignerBuilder(cfg)
            .with_sequence_aligner(ViterbiSequenceAligner(force_backend=b))
            .with_backend_options(pad_multiple=pad_multiple).build()
            for b in ("numpy", "device")}
    samples = np.random.default_rng(6).normal(size=5000).astype(np.float32)
    text = "the quick brown fox"
    fwd = port["numpy"].runtime_backend.infer(normalize_audio(samples))
    assert fwd.log_probs.shape[0] == port["numpy"].runtime_backend.model_cfg \
        .conv_output_length(-(-5000 // pad_multiple) * pad_multiple)
    tokens = port["numpy"].tokenizer.tokenize(text, VOCAB, 0, 4).tokens
    np.testing.assert_array_equal(port["numpy"].sequence_aligner.align_path(fwd, tokens),
                                  port["device"].sequence_aligner.align_path(fwd, tokens))
    host, dev = (port[b].align(AlignmentInput(16000, samples, text)).words
                 for b in ("numpy", "device"))
    _assert_same_alignment(dev, host, port["numpy"].frame_stride_ms())


def test_forced_aligner_input_contract(model_dir):
    cfg = Wav2Vec2Config(model_path=str(model_dir / "model.safetensors"),
                         config_path=str(model_dir / "config.json"),
                         vocab_path=str(model_dir / "vocab.json"), device="cpu")
    aligner = ForcedAlignerBuilder(cfg).build()
    assert aligner.align(AlignmentInput(16000, np.zeros(0, np.float32), "a")).words == []
    assert aligner.align(AlignmentInput(16000, np.ones(800, np.float32), "  ")).words == []
    with pytest.raises(InvalidInputError):
        aligner.align(AlignmentInput(16000, np.ones(100, np.float32), "the quick brown fox"))


def test_safetensors_round_trip_against_the_package(tmp_path):
    from safetensors.numpy import load_file, save_file
    from safetensors.torch import save_file as save_torch

    rng = np.random.default_rng(4)
    tensors = {
        "a.weight": rng.normal(size=(3, 4)).astype(np.float32),
        "b": rng.integers(-5, 5, size=(7,)).astype(np.int64),
        "c": rng.normal(size=(2, 1, 5)).astype(np.float16),
        "d": np.asarray(3, np.int32),
        "e": np.zeros((0, 4), np.float32),
    }
    save_safetensors(tmp_path / "port.safetensors", tensors)
    back = load_file(str(tmp_path / "port.safetensors"))
    save_file(tensors, str(tmp_path / "pkg.safetensors"))
    mine = load_safetensors(tmp_path / "pkg.safetensors")
    for k, v in tensors.items():
        np.testing.assert_array_equal(back[k], v)
        np.testing.assert_array_equal(mine[k], v)
        assert back[k].dtype == mine[k].dtype == v.dtype
    bf = torch.randn(3, 5).to(torch.bfloat16)
    save_torch({"w": bf}, str(tmp_path / "bf16.safetensors"))
    np.testing.assert_array_equal(load_safetensors(tmp_path / "bf16.safetensors")["w"],
                                  bf.float().numpy())


def test_port_runs_without_jax_safetensors_transformers(model_dir):
    script = f"""
import sys
for name in ("jax", "jaxlib", "safetensors", "transformers"):
    sys.modules[name] = None
import numpy as np
import wav2vec2_tpu_torch as w
from wav2vec2_tpu_torch.models.params import init_params, params_from_jax
cfg = w.Wav2Vec2ModelConfig.load({str(model_dir / 'config.json')!r})
vocab = w.load_vocab({str(model_dir / 'vocab.json')!r})
rng = np.random.default_rng(0)
out = w.BatchAligner(cfg, params_from_jax(init_params(cfg, 0)), vocab, "float32",
                     device="cpu").align_utterances(
    [rng.normal(size=2000).astype(np.float32)], ["the quick fox"], audio_multiple=1000)
assert [x.word for x in out[0].words] == ["THE", "QUICK", "FOX"], out
c = w.Wav2Vec2Config({str(model_dir / 'model.safetensors')!r}, {str(model_dir / 'config.json')!r},
                     {str(model_dir / 'vocab.json')!r}, device="cpu")
res = w.ForcedAlignerBuilder(c).build().align(
    w.AlignmentInput(16000, rng.normal(size=5000).astype(np.float32), "over the lazy dog"))
assert len(res.words) == 4
lf = w.align_longform(rng.normal(size=20000).astype(np.float32), "the quick brown fox",
                      params_from_jax(init_params(cfg, 0)), cfg, vocab, chunk_sec=0.5,
                      overlap_sec=0.125, device="cpu")
assert [x.word for x in lf.words] == ["THE", "QUICK", "BROWN", "FOX"], lf
conf = w.Wav2Vec2ModelConfig.from_dict({{**{CONFIG!r}, "model_type": "wav2vec2-conformer",
    "hidden_size": 64, "feat_extract_norm": "layer", "conv_bias": True,
    "position_embeddings_type": "relative", "hidden_act": "swish",
    "conv_depthwise_kernel_size": 7}})
conf_params = params_from_jax(init_params(conf, 1))
for flash in (True, False):
    out = w.BatchAligner(conf, conf_params, vocab, "float32", device="cpu",
                         use_flash_attention=flash).align_utterances(
        [rng.normal(size=3000).astype(np.float32)], ["jumps over the dog"],
        audio_multiple=1000)
    assert [x.word for x in out[0].words] == ["JUMPS", "OVER", "THE", "DOG"], out
import torch
from wav2vec2_tpu_torch.models.ctc_model import wav2vec2_forward
from wav2vec2_tpu_torch.models.presets import PRESETS
assert PRESETS["wavlm-large"]().attention_style == "wavlm"
assert PRESETS["w2v-bert-2.0"]().frontend_style == "mel"
for family in ({{"model_type": "wavlm", "do_stable_layer_norm": True,
                 "feat_extract_norm": "layer", "conv_bias": True}},
               {{"model_type": "hubert", "add_adapter": True, "num_adapter_layers": 2,
                 "conv_pos_batch_norm": True}},
               {{"model_type": "sew"}},
               {{"model_type": "sew-d", "position_buckets": 8, "max_position_embeddings": 32}},
               {{"model_type": "wav2vec2-bert", "position_embeddings_type": "relative_key",
                 "left_max_position_embeddings": 4, "right_max_position_embeddings": 2,
                 "conv_depthwise_kernel_size": 5, "add_adapter": True,
                 "use_intermediate_ffn_before_adapter": True}}):
    fcfg = w.Wav2Vec2ModelConfig.from_dict({{**{CONFIG!r}, **family}})
    logits = wav2vec2_forward(params_from_jax(init_params(fcfg, 2)),
                              torch.from_numpy(rng.normal(size=(2, 4000)).astype(np.float32)),
                              fcfg, audio_lens=torch.tensor([4000, 3000]))
    assert logits.shape == (2, fcfg.conv_output_length(4000), fcfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
import json, pathlib, tempfile
from wav2vec2_tpu_torch.cli.alignment_report import run
from wav2vec2_tpu_torch.data.flac_encoder import write_flac
with tempfile.TemporaryDirectory() as tmp:
    base = pathlib.Path(tmp) / "LibriSpeech" / "test-clean" / "1" / "2"
    base.mkdir(parents=True)
    for i, n in enumerate((12000, 30000)):
        write_flac(base / f"1-2-{{i:04d}}.flac",
                   np.clip(np.cumsum(rng.integers(-80, 80, size=n)), -30000, 30000), 16000)
    (base / "1-2.trans.txt").write_text("1-2-0000 THE QUICK FOX\\n1-2-0001 OVER THE LAZY DOG")
    common = ["--model-dir", {str(model_dir)!r}, "--dataset-root", tmp, "--device", "cpu",
              "--compute-dtype", "float32"]
    assert run(common + ["--output-format", "textgrid"]) == 0
    assert len(list(base.glob("*.TextGrid"))) == 2
    assert run(common + ["--output-format", "json", "--out", tmp + "/r.json"]) == 0
    report = json.loads(pathlib.Path(tmp, "r.json").read_text())
    assert report["meta"]["case_count"] == 2 and report["meta"]["device"] == "cpu"
    assert run(common + ["--output-format", "perf", "--perf-out", tmp + "/p.jsonl",
                         "--perf-warmup", "1", "--perf-repeats", "1"]) == 0
import contextlib, io
from wav2vec2_tpu_torch import OnlineAligner, doctor, serve
ol = OnlineAligner(cfg, params_from_jax(init_params(cfg, 0)), vocab, "the quick fox",
                   chunk_sec=0.5, overlap_sec=0.125, device="cpu")
ol.push(rng.normal(size=12000).astype(np.float32))
assert [x.word for x in ol.flush().words] == ["THE", "QUICK", "FOX"]
out = w.BatchAligner(cfg, params_from_jax(init_params(cfg, 0)), vocab, "bfloat16", device="cpu",
                     quantize_int8=True).align_utterances(
    [rng.normal(size=4000).astype(np.float32)], ["over the dog"], audio_multiple=1000)
assert [x.word for x in out[0].words] == ["OVER", "THE", "DOG"], out
service, label = serve.build_service_from_model_dir({str(model_dir)!r}, "float32", max_batch=2,
                                                    device="cpu")
res, _ = service.submit(rng.normal(size=8000).astype(np.float32), "JUMPS OVER")
service.close()
assert label == "cpu" and [x.word for x in res.words] == ["JUMPS", "OVER"]
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    doctor.main(["--model-dir", {str(model_dir)!r}])
assert "family prefix: wav2vec2" in buf.getvalue() and "accelerator" in buf.getvalue()
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("wav2vec2_tpu", "jax")
             and sys.modules[m] is not None)
assert not bad, bad
print("OK")
"""
    res = subprocess.run([sys.executable, "-c", script], cwd=str(REPO),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("OK")
