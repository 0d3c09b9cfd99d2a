"""PyTorch port vs the JAX package: the carried-over host modules are copies.

The port never imports the JAX package (importing any of its modules runs
`wav2vec2_tpu/__init__.py`, which imports jax), so it carries its own copy
of every numpy/stdlib host module it needs. Each copy's code must equal its
JAX source, except for the lines named here, each with the reason the port
differs. Code is compared after parsing, with docstrings dropped, so the
copies may word their documentation for the port.

Also: no module of `wav2vec2_tpu_torch/`, and not `chip_smoke.py`, imports
jax or the JAX package.
"""

import ast
import difflib
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

# module (path under each package) -> the code lines the port changes:
# "-" lines are the JAX source's, "+" lines the port's
PORT_DIFFERENCES = {
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


def _code_lines(path: Path) -> list[str]:
    """The module's code, parsed and unparsed, without docstrings."""
    tree = ast.parse(path.read_text(encoding="utf-8"))
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
    diff = difflib.unified_diff(_code_lines(REPO / "wav2vec2_tpu" / module),
                                _code_lines(REPO / "wav2vec2_tpu_torch" / module),
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
    assert not _imported_roots(REPO / path) & {"jax", "jaxlib", "wav2vec2_tpu"}
