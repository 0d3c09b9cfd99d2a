"""PyTorch port vs the JAX package: the carried-over host modules are copies.

The port never imports the JAX package (importing any of its modules runs
`wav2vec2_tpu/__init__.py`, which imports jax), so it carries its own copy
of every numpy/stdlib host module it needs. Each copy's code must equal its
JAX source, except for the lines named here, each with the reason the port
differs. Code is compared after parsing, with docstrings dropped, so the
copies may word their documentation for the port. Where the port rewrites
part of a module (`align/online.py`, `serve.py`), its carried-over
definitions are compared one by one.

Also: no module of `wav2vec2_tpu_torch/`, and not `chip_smoke.py`, imports
jax, the JAX package, safetensors or transformers (the card's machine has
none of them); and the ONNX runtime, the exporter, the train step and the
parameter checkpoints import and run in a process where jax, safetensors,
transformers, orbax, optax and onnxruntime cannot be imported.
"""

import ast
import difflib
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

# module (path under each package) -> the code lines the port changes:
# "-" lines are the JAX source's, "+" lines the port's
PORT_DIFFERENCES = {
    # a definition of a module the port rewrites around it: "module::name"
    "align/online.py::IncrementalViterbi": [],
    "serve.py::PayloadTooLargeError": [],
    "serve.py::_Request": [],
    "serve.py::AlignmentService": [],
    "serve.py::_decode_audio": [],
    "serve.py::_word_to_json": [],
    "serve.py::_StreamSession": [],
    # each session's window forward runs on the service's torch device
    "serve.py::StreamRegistry": [
        "-            self._sessions[sid] = _StreamSession(OnlineAligner(self._aligner.cfg, "
        "self._aligner.params, self._aligner.vocab, transcript, chunk_sec=chunk_sec, "
        "overlap_sec=overlap_sec, finalize_margin_sec=finalize_margin_sec, "
        "compute_dtype=self._compute_dtype, units=self._units), time.monotonic())",
        "+            self._sessions[sid] = _StreamSession(OnlineAligner(self._aligner.cfg, "
        "self._aligner.params, self._aligner.vocab, transcript, chunk_sec=chunk_sec, "
        "overlap_sec=overlap_sec, finalize_margin_sec=finalize_margin_sec, "
        "compute_dtype=self._compute_dtype, units=self._units, device=self._aligner.device), "
        "time.monotonic())",
    ],
    "serve.py::AlignHTTPServer": [],
    "serve.py::make_handler": [],
    "serve.py::warmup_aligner": [],
    "align/tokenization.py": [],
    "align/grouping/phoneme.py": [],
    "data/audio.py": [],
    "data/flac_encoder.py": [],
    "data/textgrid.py": [],
    "data/subtitles.py": [],
    "align/report.py": [],
    "data/librispeech.py": [],
    "cli/json_report_formatter.py": [],
    "cli/compare_textgrids.py": [],
    "models/presets.py": [],
    "onnx/proto.py": [],
    # the exporter reads the port's tree: every leaf to the host as f32
    # numpy first, then the JAX exporter's graph node by node
    "onnx/export.py": [
        "+import torch",
        "+def _host_f32(tree):",
        "+    if isinstance(tree, dict):",
        "+        return {k: _host_f32(v) for k, v in tree.items()}",
        "+    if isinstance(tree, (list, tuple)):",
        "+        return [_host_f32(v) for v in tree]",
        "+    if isinstance(tree, torch.Tensor):",
        "+        tree = tree.detach().cpu()",
        "+        return tree.float().numpy() if tree.is_floating_point() else tree.numpy()",
        "+    return tree",
        "+",
        "+    params = _host_f32(params)",
    ],
    # the ONNX backend's helpers, carried over as they are
    "pipeline/onnx_runtime.py::_PRECISION_LABELS": [],
    "pipeline/onnx_runtime.py::normalize_precision_label": [],
    "pipeline/onnx_runtime.py::precision_from_config": [],
    "pipeline/onnx_runtime.py::extract_raw_logits_f32": [],
    "pipeline/onnx_runtime.py::execution_providers": [],
    "pipeline/onnx_runtime.py::parse_onnx_output_shape": [],
    "pipeline/onnx_runtime.py::raw_logits_to_log_probs": [],
    # the port's loggers live under wav2vec2_tpu_torch, not a child of
    # the JAX package's logger
    "utils/tracing.py": [
        "-    root = logging.getLogger('wav2vec2_tpu')",
        "+    root = logging.getLogger('wav2vec2_tpu_torch')",
    ],
    # a device reading that could not be taken is null in the JSON, not
    # left out and not 0
    "cli/perf_report_formatter.py": [
        "-    gpu_used: int",
        "-    gpu_total: int",
        "+    gpu_used: Optional[int]",
        "+    gpu_total: Optional[int]",
        "-def _strip_none(obj):",
        "-    if isinstance(obj, dict):",
        "-        return {k: _strip_none(v) for k, v in obj.items() if v is not None}",
        "-    if isinstance(obj, list):",
        "-        return [_strip_none(v) for v in obj]",
        "-    return obj",
        "-",
        "-        d['memory'] = _strip_none(d['memory'])",
        "+        d['memory'] = {k: v for k, v in d['memory'].items() if v is not None}",
    ],
    # counts of the calls each engine served (chip_smoke.py prints them)
    "align/grouping/__init__.py": [
        "+engine_calls = {'native': 0, 'python': 0}",
        "+            engine_calls['native'] += 1",
        "+    engine_calls['python'] += 1",
    ],
    # the port builds its own library into build/torch_native/
    # (utils/native_build.py), never into native/ or the JAX package
    "align/grouping/native.py": [
        "-import subprocess",
        "-from pathlib import Path",
        "-_NATIVE_DIR = Path(__file__).resolve().parents[3] / 'native'",
        "-_LIB_PATH = _NATIVE_DIR / 'libgrouping.so'",
        "-def _needs_build() -> bool:",
        "-    if not _LIB_PATH.exists():",
        "-        return True",
        "-    src = _NATIVE_DIR / 'grouping.cpp'",
        "-    return src.exists() and src.stat().st_mtime > _LIB_PATH.stat().st_mtime",
        "-",
        "-            lib_path = _LIB_PATH",
        "-            if _needs_build():",
        "-                try:",
        "-                    subprocess.run(['make', '-C', str(_NATIVE_DIR), 'libgrouping.so'], "
        "check=True, capture_output=True, text=True)",
        "-                except (subprocess.CalledProcessError, FileNotFoundError):",
        "-                    pkg_dir = Path(__file__).resolve().parents[2]",
        "-                    hits = sorted(pkg_dir.glob('_grouping*.so')) + "
        "sorted(pkg_dir.glob('_grouping*.dylib')) + sorted(pkg_dir.glob('_grouping*.pyd'))",
        "-                    if not hits:",
        "-                        raise",
        "-                    lib_path = hits[0]",
        "-            lib = ctypes.CDLL(str(lib_path))",
        "+            from ...utils import native_build",
        "+            lib = native_build.load('grouping')",
    ],
    "data/flac.py": [
        "-import subprocess",
        "-_NATIVE_DIR = Path(__file__).resolve().parent.parent.parent / 'native'",
        "-_LIB_PATH = _NATIVE_DIR / 'libflacdec.so'",
        "-def _needs_build() -> bool:",
        "-    if not _LIB_PATH.exists():",
        "-        return True",
        "-    src = _NATIVE_DIR / 'flac_decoder.cpp'",
        "-    return src.exists() and src.stat().st_mtime > _LIB_PATH.stat().st_mtime",
        "-",
        "-def _installed_lib() -> Path | None:",
        "-    pkg_dir = Path(__file__).resolve().parent.parent",
        "-    hits = sorted(pkg_dir.glob('_flacdec*.so')) + sorted(pkg_dir.glob('_flacdec*.dylib'))"
        " + sorted(pkg_dir.glob('_flacdec*.pyd'))",
        "-    return hits[0] if hits else None",
        "-",
        "-    lib_path = _LIB_PATH",
        "-    if _needs_build():",
        "-        try:",
        "-            subprocess.run(['make', '-C', str(_NATIVE_DIR)], check=True, "
        "capture_output=True, text=True)",
        "-        except (subprocess.CalledProcessError, FileNotFoundError) as e:",
        "-            installed = _installed_lib()",
        "-            if installed is None:",
        "-                detail = getattr(e, 'stderr', str(e))",
        "-                raise RuntimeBackendError('build flac decoder', f'make failed: {detail}') "
        "from e",
        "-            lib_path = installed",
        "-    lib = ctypes.CDLL(str(lib_path))",
        "+    from ..utils import native_build",
        "+    try:",
        "+        lib = native_build.load('flacdec')",
        "+    except (RuntimeError, OSError) as e:",
        "+        raise RuntimeBackendError('build flac decoder', str(e)) from e",
    ],
    # device readings from torch.cuda (peak allocation per stage, the
    # card's total), None off CUDA, in place of JAX's memory_stats()
    "pipeline/memory_tracker.py": [
        "+import torch",
        "-def device_memory_snapshot() -> Optional[DeviceMemorySnapshot]:",
        "-    try:",
        "-        import jax",
        "-        stats = jax.devices()[0].memory_stats()",
        "-        if not stats:",
        "-            return None",
        "-        used = stats.get('bytes_in_use')",
        "-        total = stats.get('bytes_limit') or stats.get('bytes_reservable_limit')",
        "-        if used is None:",
        "-            return None",
        "-        return DeviceMemorySnapshot(used=int(used), total=int(total or 0))",
        "-    except Exception:",
        "+def _cuda_device(device) -> Optional[torch.device]:",
        "+    device = torch.device(device) if device is not None else None",
        "+    if device is None or device.type != 'cuda' or (not torch.cuda.is_available()):",
        "+    return device",
        "+",
        "+def device_memory_snapshot(device=None) -> Optional[DeviceMemorySnapshot]:",
        "+    device = _cuda_device(device)",
        "+    if device is None:",
        "+        return None",
        "+    _, total = torch.cuda.mem_get_info(device)",
        "+    return DeviceMemorySnapshot(used=int(torch.cuda.max_memory_allocated(device)), "
        "total=int(total))",
        "-    def __init__(self):",
        "+    def __init__(self, device=None):",
        "+        self.device = device",
        "+        cuda = _cuda_device(self.device)",
        "+        if cuda is not None:",
        "+            sync_fn()",
        "+            torch.cuda.reset_peak_memory_stats(cuda)",
        "-        mem = StageMemory(peak_rss_bytes=peak['rss'], device=device_memory_snapshot())",
        "+        mem = StageMemory(peak_rss_bytes=peak['rss'], device=device_memory_snapshot(cuda))",
    ],
}


def _code_lines(path: Path, name: str | None = None) -> list[str]:
    """The module's code (or its top-level definition or assignment
    `name`), parsed and unparsed, without docstrings."""
    tree = ast.parse(path.read_text(encoding="utf-8"))
    if name is not None:
        tree = next(node for node in tree.body if getattr(node, "name", None) == name
                    or name in (getattr(t, "id", None) for t in getattr(node, "targets", ())))
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                node.body = body[1:] or [ast.Pass()]
    return ast.unparse(tree).splitlines()


@pytest.mark.parametrize("module", sorted(PORT_DIFFERENCES))
def test_carried_over_module_equals_its_jax_source(module):
    path, _, name = module.partition("::")
    diff = difflib.unified_diff(_code_lines(REPO / "wav2vec2_tpu" / path, name or None),
                                _code_lines(REPO / "wav2vec2_tpu_torch" / path, name or None),
                                lineterm="", n=0)
    changed = [l for l in diff if l[:1] in "+-" and not l.startswith(("+++", "---"))]
    assert changed == PORT_DIFFERENCES[module]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in [*(REPO / "wav2vec2_tpu_torch").rglob("*.py"),
                                       REPO / "chip_smoke.py"]))
def test_port_imports_no_jax(path):
    assert not _imported_roots(REPO / path) & {"jax", "jaxlib", "wav2vec2_tpu", "safetensors",
                                                "transformers"}


def test_onnx_and_training_run_without_jax_orbax_optax(tmp_path):
    script = textwrap.dedent(f"""
        import sys
        for name in ("jax", "jaxlib", "safetensors", "transformers", "orbax", "optax",
                     "onnxruntime"):
            sys.modules[name] = None
        import json
        import numpy as np
        import torch
        from wav2vec2_tpu_torch import AlignmentInput, ForcedAlignerBuilder, Wav2Vec2Config
        from wav2vec2_tpu_torch.config import Wav2Vec2ModelConfig
        from wav2vec2_tpu_torch.models.params import init_params, params_from_jax
        from wav2vec2_tpu_torch.models.params import params_to_hf_flat_dict
        from wav2vec2_tpu_torch.onnx import export_ctc_model, save_model
        from wav2vec2_tpu_torch.parallel import train
        from wav2vec2_tpu_torch.pipeline.onnx_runtime import OnnxRuntimeBackend
        from wav2vec2_tpu_torch.utils.checkpoint import (restore_params, save_params,
                                                          save_safetensors)
        from wav2vec2_tpu_torch.cli import export_onnx_model

        d = {str(tmp_path)!r}
        cfg_kw = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                      intermediate_size=64, conv_dim=[16, 16], conv_kernel=[10, 3],
                      conv_stride=[5, 2], num_conv_pos_embeddings=16,
                      num_conv_pos_embedding_groups=4, pad_token_id=0, vocab_size=8,
                      feat_extract_norm="group", conv_bias=False)
        cfg = Wav2Vec2ModelConfig(**cfg_kw)
        params = params_from_jax(init_params(cfg, 0))
        save_safetensors(d + "/model.safetensors", params_to_hf_flat_dict(params, cfg))
        open(d + "/config.json", "w").write(json.dumps(cfg_kw))
        open(d + "/vocab.json", "w").write(json.dumps({{"<pad>": 0, "a": 1, "b": 2, "|": 3}}))
        assert export_onnx_model.main(["--model-dir", d, "--verify", "--device", "cpu"]) == 0
        backend = OnnxRuntimeBackend(d + "/model.onnx", cfg, device="cpu")
        c = Wav2Vec2Config(d + "/model.onnx", d + "/config.json", d + "/vocab.json",
                           device="cpu")
        rng = np.random.default_rng(0)
        out = ForcedAlignerBuilder(c).with_runtime_backend(backend).build().align(
            AlignmentInput(16000, rng.normal(size=4000).astype(np.float32), "ab ba"))
        assert [w.word for w in out.words] == ["ab", "ba"], out

        state = train.init_train_state(params, train.make_optimizer(learning_rate=3e-3))
        step = train.make_train_step(cfg, None, compute_dtype=torch.float32)
        batch = (rng.normal(size=(2, 800)).astype(np.float32), np.full(2, 800, np.int32),
                 rng.integers(1, 8, size=(2, 4)).astype(np.int32), np.full(2, 4, np.int32))
        losses = [float(step(state, *batch)[1]) for _ in range(3)]
        assert losses[-1] < losses[0], losses
        save_params(d + "/ckpt", state.params)
        back = restore_params(d + "/ckpt", like=state.params)
        assert torch.equal(back["lm_head"]["kernel"], state.params["lm_head"]["kernel"])

        import torch.distributed as dist
        from wav2vec2_tpu_torch.parallel import mesh
        from wav2vec2_tpu_torch.parallel.batching import BatchAligner
        dist.init_process_group("gloo", init_method="file://" + d + "/store", rank=0,
                                world_size=1)
        m = mesh.make_mesh(device="cpu")
        assert m.mesh_dim_names == ("data", "model") and m.size() == 1
        aligner = BatchAligner(cfg, mesh.shard_params(params, m), {{"a": 1, "b": 2, "|": 3}},
                               compute_dtype="float32", device="cpu", mesh=m)
        words = aligner.align_utterances([rng.normal(size=4000).astype(np.float32)],
                                         ["ab ba"])[0].words
        assert [w.word for w in words] == ["ab", "ba"], words
        dist.destroy_process_group()
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", script], cwd=str(REPO), capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
