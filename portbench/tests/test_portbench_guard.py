"""What the benchmark must not load or import: JAX, the JAX package (its
top-level name compared whole), `bench.py` and `chip_smoke.py`; and the
reference imports nothing of the port."""

from __future__ import annotations

import ast
import sys
import types

from portbench import manifest, run


def _imports(path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "wav2vec2_tpu_torch_fake", types.ModuleType("x"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "wav2vec2_tpu.models", types.ModuleType("y"))
    assert run.forbidden_modules() == ["wav2vec2_tpu"]
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("z"))
    assert run.forbidden_modules() == ["jaxlib", "wav2vec2_tpu"]


def test_no_source_imports_jax_or_the_jax_package():
    banned = {"jax", "jaxlib", "flax", "wav2vec2_tpu", "bench", "chip_smoke"}
    for path in manifest.HERE.rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not _imports(path) & banned, path


def test_reference_imports_nothing_of_the_port():
    for path in (manifest.HERE / "reference").rglob("*.py"):
        found = _imports(path)
        assert "wav2vec2_tpu_torch" not in found and "portbench" not in found, path
        assert found <= {"__future__", "contextlib", "dataclasses", "importlib", "logging",
                         "math", "numpy", "torch", "typing"}, path
