"""PyTorch port: the environment check (`python -m wav2vec2_tpu_torch.doctor`).

Each check's line for a healthy setup and for a broken one (the CUDA probe
and the kernel library faked where this machine has no card and no nvcc),
a hung CUDA probe reported after its timeout instead of waited on (the
JAX package's `test_doctor_reports_hung_device_init` pattern), and the
model-dir lines equal to the JAX package's for the same directory.
"""

import json
import time

import jax
import numpy as np
import pytest
import torch

from wav2vec2_tpu import doctor as jax_doctor
from wav2vec2_tpu.config import Wav2Vec2ModelConfig as JaxCfg
from wav2vec2_tpu.models.params import init_params as jax_init_params
from wav2vec2_tpu_torch import doctor
from wav2vec2_tpu_torch.config import Wav2Vec2ModelConfig as TorchCfg
from wav2vec2_tpu_torch.models.params import params_from_jax, params_to_hf_flat_dict
from wav2vec2_tpu_torch.ops import cuda_build
from wav2vec2_tpu_torch.utils.checkpoint import save_safetensors

CONFIG = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
              intermediate_size=64, conv_dim=[16, 16], conv_kernel=[10, 3],
              conv_stride=[5, 2], num_conv_pos_embeddings=16,
              num_conv_pos_embedding_groups=4, pad_token_id=0,
              vocab_size=8, feat_extract_norm="group", conv_bias=False)


def _fake_card(monkeypatch, capability=(9, 0)):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "init", lambda: None)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda i=0: capability)
    monkeypatch.setattr(doctor, "_power_limit", lambda: "power limit 700.00 W")


class _Library:
    """Every symbol the wrappers bind, or all but `missing`."""

    def __init__(self, missing=()):
        for name in doctor._kernel_symbols():
            if name not in missing:
                setattr(self, name, object())


def _fake_kernels(monkeypatch, tmp_path, library=None, seconds=0.0):
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: "/usr/local/cuda/bin/nvcc")
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "torch_kernels")
    monkeypatch.setattr(cuda_build, "build", lambda force=False: {
        "library": str(tmp_path / "libkernels.so"), "seconds": seconds,
        "compiler_output": ""})
    monkeypatch.setattr("ctypes.CDLL", lambda path: library or _Library())


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("doctor_model")
    jcfg = JaxCfg.from_dict(CONFIG)
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))
    save_safetensors(d / "model.safetensors",
                     params_to_hf_flat_dict(params_from_jax(tree), TorchCfg.from_dict(CONFIG)))
    (d / "config.json").write_text(json.dumps(CONFIG))
    (d / "vocab.json").write_text(json.dumps({"a": 1, "|": 2}))
    return d


def test_accelerator_lines(monkeypatch, capsys):
    _fake_card(monkeypatch)
    assert doctor.check_cuda(timeout_s=10)
    assert capsys.readouterr().out == (
        "[  ok] accelerator: 1 × cuda (NVIDIA H100 80GB HBM3, sm_90, power limit 700.00 W)\n")
    _fake_card(monkeypatch, capability=(8, 0))
    assert doctor.check_cuda(timeout_s=10)
    out = capsys.readouterr().out
    assert out.startswith("[warn] accelerator: 1 × cuda") and "sm_90a" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert not doctor.check_cuda(timeout_s=10)
    out = capsys.readouterr().out
    assert out.startswith("[FAIL] accelerator: torch sees no CUDA device") and \
        "--device cpu" in out

    def broken():
        raise RuntimeError("CUDA driver version is insufficient")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "init", broken)
    assert not doctor.check_cuda(timeout_s=10)
    assert "[FAIL] accelerator: CUDA initialization failed: CUDA driver version" in \
        capsys.readouterr().out


def test_hung_cuda_probe_is_reported_not_waited_on(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: time.sleep(30))
    t0 = time.monotonic()
    ok = doctor.check_cuda(timeout_s=0.3)
    assert time.monotonic() - t0 < 5
    out = capsys.readouterr().out
    assert not ok and "wedged" in out and "--device cpu" in out


def test_kernel_lines(monkeypatch, tmp_path, capsys):
    _fake_kernels(monkeypatch, tmp_path)
    assert doctor.check_kernels()
    out = capsys.readouterr().out
    assert out.startswith("[  ok] cuda kernels:") and "up to date" in out
    assert f"{len(doctor._kernel_symbols())} symbols resolved" in out
    _fake_kernels(monkeypatch, tmp_path, seconds=17.25)
    assert doctor.check_kernels() and "rebuilt in 17.2 s" in capsys.readouterr().out
    _fake_kernels(monkeypatch, tmp_path, library=_Library(missing={"viterbi_k4_launch"}))
    assert not doctor.check_kernels()
    assert "[FAIL] cuda kernels:" in (out := capsys.readouterr().out) and \
        "viterbi_k4_launch" in out

    def failing(force=False):
        raise RuntimeError("nvcc failed (1)")

    monkeypatch.setattr(cuda_build, "build", failing)
    assert not doctor.check_kernels()
    assert "build or load failed: nvcc failed" in capsys.readouterr().out
    (tmp_path / "a_file").write_text("")
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "a_file" / "torch_kernels")
    assert not doctor.check_kernels()
    assert "not writable" in capsys.readouterr().out


def test_kernel_line_without_nvcc(monkeypatch, capsys):
    def missing():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")

    monkeypatch.setattr(cuda_build, "_nvcc", missing)
    assert not doctor.check_kernels()
    assert capsys.readouterr().out.startswith("[FAIL] cuda kernels: nvcc not found")


def test_native_and_optional_lines(monkeypatch, capsys):
    assert doctor.check_native()
    out = capsys.readouterr().out
    assert "[  ok] native flac decoder: loaded" in out
    assert "native grouping engine" in out
    from wav2vec2_tpu_torch.data import flac

    def broken():
        raise RuntimeError("g++ failed")

    monkeypatch.setattr(flac, "_load_library", broken)
    assert not doctor.check_native()
    assert "[FAIL] native flac decoder: g++ failed" in capsys.readouterr().out

    import importlib.util

    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name: object() if name == "transformers" else None)
    assert doctor.check_optional_deps()
    out = capsys.readouterr().out.splitlines()
    assert out == ["[  ok] optional: transformers: installed",
                   "[warn] optional: onnxruntime: absent — needed only for the JAX "
                   "package's optional ONNX backend"]


def test_model_dir_lines_equal_jax(model_dir, tmp_path, capsys):
    for d in (model_dir, tmp_path):
        assert doctor.check_model_dir(str(d)) == jax_doctor.check_model_dir(str(d)) \
            == (d == model_dir)
        out = capsys.readouterr().out.splitlines()
        half = len(out) // 2
        assert out[:half] == out[half:] and out
    assert "family prefix: wav2vec2" in out[-1] or "missing" in out[-1]


def test_model_dir_broken_files(model_dir, tmp_path, capsys):
    for name in ("model.safetensors", "config.json", "vocab.json"):
        (tmp_path / name).write_bytes((model_dir / name).read_bytes())
    (tmp_path / "model.safetensors").write_bytes(b"\x01")
    assert not doctor.check_model_dir(str(tmp_path))
    assert "[FAIL] model.safetensors:" in capsys.readouterr().out
    (tmp_path / "vocab.json").write_text("{")
    assert not doctor.check_model_dir(str(tmp_path))
    assert "[FAIL] vocab.json:" in capsys.readouterr().out
    (tmp_path / "config.json").write_text("[]")
    assert not doctor.check_model_dir(str(tmp_path))
    assert "[FAIL] config.json:" in capsys.readouterr().out


def test_main_healthy_and_unhealthy(model_dir, monkeypatch, tmp_path, capsys):
    _fake_card(monkeypatch)
    _fake_kernels(monkeypatch, tmp_path)
    assert doctor.main(["--model-dir", str(model_dir)]) == 0
    out = capsys.readouterr().out
    assert out.strip().endswith("healthy") and "accelerator" in out and \
        "cuda kernels" in out and "model.safetensors" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert doctor.main([]) == 1
    assert capsys.readouterr().out.strip().endswith("PROBLEMS FOUND")
