"""Shared fixtures of the benchmark's own tests: tiny stand-ins for the
configurations and mixes, so that a whole run fits on the CPU."""

from __future__ import annotations

import json

import pytest

from portbench import manifest

TINY = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=64,
            conv_dim=[16] * 7, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)


def tiny_config(name: str) -> dict:
    cfg = json.loads((manifest.HERE / "configs" / f"{name}.json").read_text())
    cfg.update(TINY)
    if cfg["model_type"] == "wav2vec2-conformer":
        cfg["conv_depthwise_kernel_size"] = 7
    return cfg


def tiny_mix(name: str) -> dict:
    mix = json.loads((manifest.HERE / "traffic" / f"{name}.json").read_text())
    mix.update(pool=12, check_items=3,
               seconds={"dist": "lognormal", "mean": 3.0, "sigma": 0.5, "min": 1.0, "max": 6.0})
    mix["stream"].update(max_batch=4, max_pending=6)
    return mix


@pytest.fixture
def tiny(monkeypatch):
    """Every configuration and mix at a size a CPU run holds, on two
    threads (test workers beside each other would oversubscribe the cores
    and leave a window with nothing done)."""
    import torch

    monkeypatch.setattr(manifest, "config", tiny_config_by_entry)
    monkeypatch.setattr(manifest, "traffic", tiny_mix)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def tiny_config_by_entry(name: str) -> dict:
    for c in manifest.benchmark()["configs"]:
        if c["name"] == name:
            return tiny_config(c["file"].rsplit("/", 1)[1][: -len(".json")])
    raise KeyError(name)


@pytest.fixture
def card():
    """Skips unless a CUDA device is present (decided inside the test)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
