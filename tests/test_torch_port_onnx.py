"""PyTorch port vs the JAX package: the ONNX runtime (`onnx/`,
`pipeline/onnx_runtime.py`, `cli/export_onnx_model.py`, the CLI's
`--runtime onnx`), on the CPU, mirroring `tests/test_onnx_subsystem.py` and
`tests/test_onnx_backend.py`.

- The codec (`onnx/proto.py`, a copy of JAX's) round-trips the exported
  model and decodes packed fields.
- On the same f32 weights (`params_from_jax`) the port's exporter writes
  the JAX exporter's exact bytes, for both norm orders and the folded
  batch-norm pos-conv, and declines the same families with the same
  messages.
- The port's session (torch operations on the asked device, here the CPU)
  is within 2e-5 of JAX's numpy session on the same file and of the port's
  f32 forward; the shape ops, `Cast` and every supported op agree with
  JAX's session; unknown ops are refused.
- The backend's helpers (precision labels, f16/f64 extraction, output
  shapes, the f64 log-softmax, the provider chain) and its paths through a
  stub onnxruntime (`fake_ort`), including "CUDA asked, CPU provider
  given → raise", and no card → raise.
- The ONNX pipeline's words and milliseconds equal the torch backend's at
  f32; the CLI's `--runtime onnx` writes the JAX CLI's TextGrid; the
  exporter module's `--verify` passes and its file is the JAX script's.
"""

import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from wav2vec2_tpu.config import Wav2Vec2ModelConfig as JaxCfg
from wav2vec2_tpu.models.params import init_params as jax_init_params
from wav2vec2_tpu.onnx import EmbeddedOnnxSession as JaxSession
from wav2vec2_tpu.onnx import export_ctc_model as jax_export
from wav2vec2_tpu_torch import AlignmentInput, Wav2Vec2Config
from wav2vec2_tpu_torch.config import Wav2Vec2ModelConfig
from wav2vec2_tpu_torch.errors import RuntimeBackendError
from wav2vec2_tpu_torch.models.ctc_model import wav2vec2_forward
from wav2vec2_tpu_torch.models.params import params_from_jax, params_to_hf_flat_dict
from wav2vec2_tpu_torch.onnx import EmbeddedOnnxSession, Model, export_ctc_model, save_model
from wav2vec2_tpu_torch.onnx import proto
from wav2vec2_tpu_torch.pipeline import onnx_runtime as ort_backend
from wav2vec2_tpu_torch.pipeline.builder import ForcedAlignerBuilder
from wav2vec2_tpu_torch.pipeline.onnx_runtime import OnnxRuntimeBackend
from wav2vec2_tpu_torch.utils.checkpoint import save_safetensors

# the JAX package's grouping engine and FLAC decoder, built privately for
# this module (test_torch_port_native.py says why)
from test_torch_port_native import private_jax_natives  # noqa: E402,F401

REPO = Path(__file__).resolve().parent.parent

CFG_KW = dict(
    hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
    intermediate_size=64, conv_dim=[16, 16], conv_kernel=[10, 3],
    conv_stride=[5, 2], num_conv_pos_embeddings=16,
    num_conv_pos_embedding_groups=4, pad_token_id=0, vocab_size=8,
)
VARIANTS = {
    "group_postnorm": dict(feat_extract_norm="group", conv_bias=False),
    "layer_prenorm": dict(feat_extract_norm="layer", conv_bias=True, do_stable_layer_norm=True),
    "batch_norm_pos_conv": dict(conv_pos_batch_norm=True),
}
TOL = 2e-5


def _trees(extra, seed=0):
    """The JAX tree (numpy leaves) and the port's tree of the same
    weights. The batch-norm affine is set off its init (scale 1, shift 0)
    so that a dropped affine cannot pass."""
    tree = jax.tree.map(np.asarray, jax_init_params(JaxCfg(**CFG_KW, **extra),
                                                    jax.random.PRNGKey(seed)))
    bn = tree["encoder"]["pos_conv_embed"].get("batch_norm")
    if bn is not None:
        bn["scale"] = (bn["scale"] * 1.3).astype(np.float32)
        bn["shift"] = (bn["shift"] + 0.21).astype(np.float32)
    return tree, params_from_jax(tree)


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def exported(request):
    extra = VARIANTS[request.param]
    tree, params = _trees(extra)
    cfg = Wav2Vec2ModelConfig(**CFG_KW, **extra)
    return cfg, params, export_ctc_model(cfg, params), jax_export(JaxCfg(**CFG_KW, **extra), tree)


def test_exporter_writes_the_jax_exporters_bytes(exported):
    _cfg, _params, model, jax_model = exported
    assert model.encode() == jax_model.encode()
    assert model.encode() == export_ctc_model(_cfg, _params).encode()  # twice, same bytes


def test_proto_roundtrip(exported):
    """encode → decode is lossless for nodes, attrs, and initializers."""
    _cfg, _params, model, _ = exported
    back = Model.decode(model.encode())
    assert back.opset_version == model.opset_version
    assert back.graph.input_names == ["audio"]
    assert back.graph.output_names == ["logits"]
    assert len(back.graph.nodes) == len(model.graph.nodes)
    for a, b in zip(model.graph.nodes, back.graph.nodes):
        assert (a.op_type, a.inputs, a.outputs) == (b.op_type, b.inputs, b.outputs)
        for name, attr in a.attributes.items():
            got = b.attributes[name].value
            if isinstance(attr.value, float):
                assert got == pytest.approx(attr.value, rel=1e-6)
            else:
                assert got == attr.value, (a.op_type, name)
    assert set(back.graph.initializers) == set(model.graph.initializers)
    for k, arr in model.graph.initializers.items():
        got = back.graph.initializers[k]
        assert got.dtype == arr.dtype and got.shape == arr.shape
        np.testing.assert_array_equal(got, arr, err_msg=k)


def test_proto_negative_scalar_and_packed_fields():
    a = proto.Attribute("ends", type=proto.ATTR_INTS, ints=[-1, 0, 7])
    assert proto.Attribute.decode(a.encode()).ints == [-1, 0, 7]
    name, arr = proto.decode_tensor(proto.encode_tensor("x", np.int64([-5, 3])))
    assert name == "x" and arr.tolist() == [-5, 3]
    # a TensorProto with PACKED dims [2, 3] + raw_data, as proto3 writers emit
    buf, packed = bytearray(), bytearray()
    proto._write_varint(packed, 2)
    proto._write_varint(packed, 3)
    proto.write_len_delimited(buf, 1, bytes(packed))
    proto.write_int(buf, 2, 1)
    proto.write_string(buf, 8, "t")
    want = np.arange(6, dtype=np.float32).reshape(2, 3)
    proto.write_len_delimited(buf, 9, want.tobytes())
    name, got = proto.decode_tensor(bytes(buf))
    assert name == "t" and got.shape == (2, 3)
    np.testing.assert_array_equal(got, want)


def test_session_matches_jax_session_and_the_port_forward(exported):
    cfg, params, model, _ = exported
    data = model.encode()
    sess = EmbeddedOnnxSession(data, device="cpu")
    assert sess.get_inputs()[0].name == "audio"
    assert sess.get_outputs()[0].name == "logits"
    assert sess.get_providers() == ["EmbeddedCPUExecutionProvider"]
    jax_sess = JaxSession(data)
    rng = np.random.default_rng(1)
    for n in (1600, 2000):  # dynamic time axis: one file, any length
        audio = rng.normal(size=(1, n)).astype(np.float32)
        (logits,) = sess.run(None, {"audio": audio})
        (want,) = jax_sess.run(None, {"audio": audio})
        ref = wav2vec2_forward(params, torch.from_numpy(audio), cfg).numpy()
        assert isinstance(logits, np.ndarray) and logits.dtype == np.float32
        assert logits.shape == want.shape == ref.shape
        np.testing.assert_allclose(logits, want, atol=TOL)
        np.testing.assert_allclose(logits, ref, atol=TOL)


@pytest.mark.parametrize("extra, msg", [
    (dict(attention_style="wavlm", num_buckets=16, max_bucket_distance=50), "WavLM"),
    (dict(pos_conv_style="data2vec", feat_extract_norm="layer"), "data2vec"),
    (dict(adapter_attn_dim=4), "MMS"),
    (dict(encoder_style="sew", squeeze_factor=2), "SEW"),
    (dict(add_adapter=True, adapter_kernel_size=3, adapter_stride=2, num_adapter_layers=1),
     "add_adapter"),
    (dict(encoder_style="conformer"), "conformer encoders"),
    (dict(encoder_style="conformer_bert"), "Wav2Vec2-BERT"),
], ids=["wavlm", "data2vec", "mms", "sew", "adapter", "conformer", "w2v-bert"])
def test_export_declines_the_families_jax_declines(extra, msg):
    """The declines come before any weight is read, with JAX's messages."""
    errors = []
    for export, cfg_cls in ((export_ctc_model, Wav2Vec2ModelConfig), (jax_export, JaxCfg)):
        with pytest.raises(Exception, match=msg) as exc:
            export(cfg_cls(**CFG_KW, **extra), {})
        errors.append(exc.value)
    assert isinstance(errors[0], RuntimeBackendError)
    assert str(errors[0]) == str(errors[1])


def test_session_rejects_unknown_ops():
    g = proto.Graph(nodes=[proto.Node(op_type="LSTM", inputs=["x"], outputs=["y"])])
    with pytest.raises(ValueError, match="LSTM"):
        EmbeddedOnnxSession(Model(graph=g).encode(), device="cpu")


def _attr_int(name, v):
    return {name: proto.Attribute(name, type=proto.ATTR_INT, i=v)}


def test_session_cast_op():
    g = proto.Graph()
    g.add_input("x", proto.FLOAT, [2])
    g.add_output("y", proto.INT64, [2])
    g.nodes.append(proto.Node(op_type="Cast", inputs=["x"], outputs=["y"],
                              attributes=_attr_int("to", proto.INT64)))
    (y,) = EmbeddedOnnxSession(Model(graph=g).encode(), device="cpu").run(
        None, {"x": np.asarray([1.9, -2.2], np.float32)})
    assert y.dtype == np.int64 and y.tolist() == [1, -2]


def test_session_eager_shape_ops_keep_ints_on_the_host():
    """The dynamic-shape machinery torch.onnx emits (Shape/Gather/Concat/
    Range/Reshape/Slice/Expand/Where/Gemm/ReduceMean/...) evaluates eagerly,
    as JAX's session evaluates it; integer values stay host tensors."""
    g = proto.Graph()
    g.add_input("x", proto.FLOAT, [2, 3])
    rng = np.random.default_rng(0)
    g.initializers.update({
        "idx": np.asarray(0, np.int64), "neg": np.asarray([-1], np.int64),
        "w": rng.normal(size=(3, 4)).astype(np.float32), "b": np.zeros(4, np.float32),
        "zero": np.asarray(0, np.int64), "one": np.asarray(1, np.int64),
        "st": np.asarray([3], np.int64), "en": np.asarray([-10], np.int64),
        "ax": np.asarray([1], np.int64), "step": np.asarray([-2], np.int64),
        "lo": np.asarray(-0.5, np.float32), "hi": np.asarray(0.5, np.float32),
        "two": np.asarray([2], np.int64), "e": np.asarray(2.0, np.float32),
    })
    nodes = [
        ("Shape", ["x"], "shp", {}), ("Gather", ["shp", "idx"], "b0", _attr_int("axis", 0)),
        ("Gather", ["shp", "neg"], "last", _attr_int("axis", 0)),
        ("Concat", ["last", "two"], "new_shape", _attr_int("axis", 0)),
        ("Gemm", ["x", "w", "b"], "y", {}),
        ("ReduceMean", ["y"], "m", {"axes": proto.Attribute("axes", type=proto.ATTR_INTS,
                                                              ints=[-1]),
                                    **_attr_int("keepdims", 0)}),
        ("Reshape", ["x", "new_shape"], "r", {}), ("Range", ["zero", "b0", "one"], "rg", {}),
        ("Slice", ["y", "st", "en", "ax", "step"], "sl", {}),
        ("Expand", ["m", "two"], "ex", {}), ("Clip", ["y", "lo", "hi"], "cl", {}),
        ("Pow", ["x", "e"], "pw", {}), ("Equal", ["idx", "zero"], "eq", {}),
        ("Where", ["eq", "x", "pw"], "wh", {}), ("Sigmoid", ["wh"], "sg", {}),
        ("LogSoftmax", ["y"], "ls", _attr_int("axis", -1)),
        ("Unsqueeze", ["m", "one"], "us", {}), ("Squeeze", ["us", "one"], "sq", {}),
    ]
    for op, ins, out, attrs in nodes:
        g.nodes.append(proto.Node(op, ins, [out], attributes=attrs))
    outputs = ["b0", "m", "r", "rg", "sl", "ex", "cl", "wh", "sg", "ls", "sq", "new_shape"]
    for name in outputs:
        g.add_output(name, proto.FLOAT, [])
    data = Model(graph=g).encode()
    x = rng.normal(size=(2, 3)).astype(np.float32)
    sess = EmbeddedOnnxSession(data, device="cpu")
    got = sess.run(None, {"x": x})
    want = JaxSession(data).run(None, {"x": x})
    for name, a, b in zip(outputs, got, want):
        assert a.shape == np.shape(b), name
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7, err_msg=name)
    assert got[0].item() == 2
    values = dict(sess._initializers)
    values["x"] = sess._to_torch(x)
    for node in sess._graph.nodes:
        sess._exec(node, values)
    assert values["new_shape"].dtype == torch.int64 and values["new_shape"].device.type == "cpu"


# --- the backend: helpers (copies of JAX's) ------------------------------

def test_parse_output_shape_and_f64_log_softmax():
    assert ort_backend.parse_onnx_output_shape((1, 100, 32)) == (100, 32)
    assert ort_backend.parse_onnx_output_shape((100, 32)) == (100, 32)
    with pytest.raises(RuntimeBackendError, match="batch"):
        ort_backend.parse_onnx_output_shape((2, 100, 32))
    logits = np.random.default_rng(0).normal(size=(7, 32)).astype(np.float32) * 10
    lp = ort_backend.raw_logits_to_log_probs(logits)
    x = logits.astype(np.float64)
    expected = x - x.max(-1, keepdims=True)
    expected = expected - np.log(np.exp(expected).sum(-1, keepdims=True))
    assert lp.dtype == np.float32
    np.testing.assert_allclose(lp, expected.astype(np.float32), atol=1e-6)


def test_precision_labels_and_extraction():
    for raw, want in [("float16", "f16"), ("FP16", "f16"), ("bf-16", "bf16"),
                      ("bfloat16", "bf16"), ("float32", "f32"), ("Float_64", "f64"),
                      ("double", "f64")]:
        assert ort_backend.precision_from_config(raw) == want
    assert ort_backend.precision_from_config(None) is None
    with pytest.raises(RuntimeBackendError, match="unsupported"):
        ort_backend.precision_from_config("int8")
    base = np.random.default_rng(0).normal(size=(1, 5, 8)).astype(np.float32)
    for dtype, label in [(np.float32, "f32"), (np.float16, "f16"), (np.float64, "f64")]:
        out, got = ort_backend.extract_raw_logits_f32(base.astype(dtype))
        assert got == label and out.dtype == np.float32
        np.testing.assert_allclose(out, base.astype(dtype).astype(np.float32))
    with pytest.raises(RuntimeBackendError, match="unsupported"):
        ort_backend.extract_raw_logits_f32(base.astype(np.int32))
    assert ort_backend.execution_providers("CUDA") == ["CUDAExecutionProvider",
                                                       "CPUExecutionProvider"]
    with pytest.raises(RuntimeBackendError, match="unsupported ONNX device"):
        ort_backend.execution_providers("tpu")


# --- the backend through a stub onnxruntime ------------------------------

CFG = Wav2Vec2ModelConfig(
    hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
    intermediate_size=64, conv_dim=[16], conv_kernel=[10], conv_stride=[5],
    num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
    pad_token_id=0, vocab_size=8,
)


class _FakeTensor:
    def __init__(self, name):
        self.name = name


class _FakeSession:
    """Stands in for onnxruntime.InferenceSession: deterministic logits at a
    configurable dtype; `given` replaces the providers it reports (ORT's
    quiet drop to its CPU provider)."""

    out_dtype = np.float32
    given = None

    def __init__(self, path, providers=None):
        self.providers = providers or ["CPUExecutionProvider"]

    def get_inputs(self):
        return [_FakeTensor("input_values")]

    def get_providers(self):
        return self.given or self.providers

    def run(self, _out, feeds):
        audio = feeds["input_values"]
        assert audio.ndim == 2 and audio.shape[0] == 1
        t = CFG.conv_output_length(audio.shape[1])
        rng = np.random.default_rng(abs(int(audio.sum() * 1000)) % (2**32))
        return [rng.normal(size=(1, t, CFG.vocab_size)).astype(self.out_dtype)]


@pytest.fixture
def fake_ort(monkeypatch, tmp_path):
    import types

    mod = types.ModuleType("onnxruntime")
    mod.InferenceSession = _FakeSession
    monkeypatch.setitem(sys.modules, "onnxruntime", mod)
    model = tmp_path / "model.onnx"
    model.write_bytes(b"stub")
    return model


def test_backend_with_stub_session_f16(fake_ort, monkeypatch):
    monkeypatch.setattr(_FakeSession, "out_dtype", np.float16)
    backend = OnnxRuntimeBackend(fake_ort, CFG, device="cpu")
    fo = backend.infer(np.zeros(4000, np.float32))
    assert fo.dtype == "f16" and fo.vocab_size == CFG.vocab_size
    assert fo.t_len == CFG.conv_output_length(4000)
    assert isinstance(fo.log_probs, np.ndarray)
    np.testing.assert_allclose(np.exp(fo.log_probs.astype(np.float64)).sum(-1), 1.0, atol=1e-3)
    assert fo.forward_ms == 0.0 and fo.post_ms == 0.0
    prof = backend.infer_profiled(np.zeros(4000, np.float32))
    assert prof.forward_ms > 0.0 and prof.post_ms > 0.0
    assert backend.device_label() == "onnx:CPUExecutionProvider"


def test_backend_warns_on_precision_mismatch(fake_ort, monkeypatch, caplog):
    import dataclasses

    monkeypatch.setattr(_FakeSession, "out_dtype", np.float16)
    backend = OnnxRuntimeBackend(fake_ort, dataclasses.replace(CFG, dtype="float32"),
                                 device="cpu")
    assert backend.configured_precision == "f32"
    with caplog.at_level("WARNING", logger="wav2vec2_tpu_torch.pipeline.onnx_runtime"):
        backend.infer(np.zeros(4000, np.float32))
    assert any("does not match" in r.message for r in caplog.records)


def test_backend_refuses_a_cuda_run_that_ort_put_on_the_cpu(fake_ort, monkeypatch):
    """Asked for cuda, the session's first provider must be CUDA: ORT's
    quiet drop to its CPU provider raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    backend = OnnxRuntimeBackend(fake_ort, CFG, device="cuda")  # CUDA provider given
    assert backend.device_label() == "onnx:CUDAExecutionProvider"
    monkeypatch.setattr(_FakeSession, "given", ["CPUExecutionProvider"])
    with pytest.raises(RuntimeBackendError, match="CUDA"):
        OnnxRuntimeBackend(fake_ort, CFG, device="cuda")


def test_backend_errors(tmp_path, monkeypatch):
    """Missing file; no card for cuda (never a run on the CPU instead); a
    file the embedded session cannot read; allow_embedded=False."""
    with pytest.raises(RuntimeBackendError, match="not found"):
        OnnxRuntimeBackend(tmp_path / "missing.onnx", CFG)
    bad = tmp_path / "bad.onnx"
    bad.write_bytes(b"not-an-onnx-file")
    monkeypatch.setitem(sys.modules, "onnxruntime", None)  # absent, as on the card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeBackendError, match="CUDA device requested"):
        OnnxRuntimeBackend(bad, CFG)
    with pytest.raises(RuntimeBackendError, match="CUDA device requested"):
        EmbeddedOnnxSession(bad)
    with pytest.raises(RuntimeBackendError, match="embedded"):
        OnnxRuntimeBackend(bad, CFG, device="cpu")
    with pytest.raises(RuntimeBackendError, match="onnxruntime"):
        OnnxRuntimeBackend(bad, CFG, device="cpu", allow_embedded=False)


# --- the pipeline, the CLI and the exporter module ------------------------

VOCAB = {"<pad>": 0, "a": 1, "b": 2, "|": 3, "c": 4}


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A model dir written by the port (safetensors, config, vocab) with the
    port's export of it."""
    d = tmp_path_factory.mktemp("onnx_model_dir")
    cfg_kw = dict(CFG_KW, **VARIANTS["group_postnorm"])
    cfg = Wav2Vec2ModelConfig(**cfg_kw)
    _, params = _trees(VARIANTS["group_postnorm"], seed=3)
    save_safetensors(d / "model.safetensors", params_to_hf_flat_dict(params, cfg))
    (d / "config.json").write_text(json.dumps(cfg_kw))
    (d / "vocab.json").write_text(json.dumps(VOCAB))
    save_model(d / "model.onnx", export_ctc_model(cfg, params))
    return d


def _config(model_dir, weights):
    return Wav2Vec2Config(model_path=str(model_dir / weights),
                          config_path=str(model_dir / "config.json"),
                          vocab_path=str(model_dir / "vocab.json"), device="cpu")


def test_onnx_pipeline_equals_the_torch_backend(model_dir):
    """The second runtime infers through the whole pipeline (session →
    host f64 log-softmax → Viterbi → words) and agrees with the torch
    backend at f32 word for word and millisecond for millisecond."""
    cfg = Wav2Vec2ModelConfig.load(model_dir / "config.json")
    backend = OnnxRuntimeBackend(model_dir / "model.onnx", cfg, device="cpu")
    assert backend.device_label() == "onnx:EmbeddedCPUExecutionProvider"
    onnx_aligner = ForcedAlignerBuilder(_config(model_dir, "model.onnx")) \
        .with_runtime_backend(backend).build()
    torch_aligner = ForcedAlignerBuilder(_config(model_dir, "model.safetensors")) \
        .with_backend_options(compute_dtype="float32").build()
    rng = np.random.default_rng(4)
    for n, text in ((4000, "ab ca"), (9000, "cab ba ac")):
        inp = AlignmentInput(16000, rng.normal(size=n).astype(np.float32), text)
        got, want = onnx_aligner.align(inp), torch_aligner.align(inp)
        assert [w.word for w in got.words] == text.split()
        assert [(w.word, w.start_ms, w.end_ms) for w in got.words] == \
            [(w.word, w.start_ms, w.end_ms) for w in want.words]
    assert onnx_aligner.align_profiled(inp).timings.forward_ms > 0


def _flac_dataset(root: Path, n_samples=4000, text="AB CA") -> Path:
    from wav2vec2_tpu_torch.data.flac_encoder import write_flac

    base = root / "LibriSpeech" / "test-clean" / "9" / "9"
    base.mkdir(parents=True)
    x = np.clip(np.cumsum(np.random.default_rng(5).integers(-100, 100, size=n_samples)),
                -30000, 30000).astype(np.int64)
    write_flac(base / "9-9-0000.flac", x, 16000)
    (base / "9-9.trans.txt").write_text(f"9-9-0000 {text}")
    return base


def test_cli_runtime_onnx_end_to_end(model_dir, tmp_path):
    """--runtime onnx on one FLAC: the port's CLI and the JAX CLI, each on
    the same model.onnx, write the same TextGrid."""
    from wav2vec2_tpu.cli.alignment_report import run as jax_run
    from wav2vec2_tpu.data.textgrid import parse_textgrid_file
    from wav2vec2_tpu_torch.cli.alignment_report import run as port_run

    base = _flac_dataset(tmp_path / "data")
    args = ["--model-dir", str(model_dir), "--dataset-root", str(tmp_path / "data"),
            "--runtime", "onnx", "--device", "cpu", "--output-format", "textgrid"]
    assert port_run(args + ["--textgrid-suffix", "_port"]) == 0
    assert jax_run(args + ["--textgrid-suffix", "_jax"]) == 0
    grids = [parse_textgrid_file(base / f"9-9-0000{s}.TextGrid") for s in ("_port", "_jax")]
    assert grids[0] == grids[1]
    assert "AB" in (base / "9-9-0000_port.TextGrid").read_text()


def test_cli_runtime_onnx_through_stub_ort(fake_ort, tmp_path, monkeypatch):
    """--runtime onnx with onnxruntime present (the stub) and the batch
    engine switched off: forced alignment recovers the transcript words."""
    from wav2vec2_tpu_torch.cli.alignment_report import run as port_run

    monkeypatch.setattr(_FakeSession, "out_dtype", np.float16)
    d = fake_ort.parent
    cfg_dict = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                    intermediate_size=64, conv_dim=[16], conv_kernel=[10], conv_stride=[5],
                    num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
                    pad_token_id=0, vocab_size=8)
    (d / "config.json").write_text(json.dumps(cfg_dict))
    (d / "vocab.json").write_text(json.dumps({"<pad>": 0, "|": 1, "A": 2, "B": 3, "C": 4}))
    base = _flac_dataset(tmp_path / "data", n_samples=8000, text="AB CA")
    rc = port_run(["--model-dir", str(d), "--dataset-root", str(tmp_path / "data"),
                   "--runtime", "onnx", "--device", "cpu", "--output-format", "textgrid"])
    assert rc == 0
    assert '"AB"' in (base / "9-9-0000.TextGrid").read_text()


def test_exporter_module_verify_and_the_jax_scripts_bytes(model_dir, capsys):
    from wav2vec2_tpu_torch.cli import export_onnx_model

    out = model_dir / "exported.onnx"
    rc = export_onnx_model.main(["--model-dir", str(model_dir), "--out", str(out),
                                 "--verify", "--device", "cpu"])
    assert rc == 0
    text = capsys.readouterr().out
    assert "verify: max|onnx - torch|" in text and "EmbeddedCPUExecutionProvider" in text
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        import export_onnx_model as jax_script
    finally:
        sys.path.remove(str(REPO / "scripts"))
    assert jax_script.main(["--model-dir", str(model_dir),
                            "--out", str(model_dir / "jax.onnx")]) == 0
    # both load model.safetensors with their own loader (the pos-conv
    # weight norm folded again), then export: the same bytes
    assert out.read_bytes() == (model_dir / "jax.onnx").read_bytes()
