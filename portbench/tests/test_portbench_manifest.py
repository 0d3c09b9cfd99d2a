"""BENCHMARK.json against the contract's rules that a test can check, and
every file it names found by name."""

from __future__ import annotations

import json
import re

import pytest

from portbench import check, manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = manifest.benchmark()


def test_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word


ENTRY_KEYS = {
    "configs": ({"name", "source", "file", "reduced", "why"}, set()),
    "workloads": ({"name", "config", "traffic", "chips", "why"}, set()),
    "end_to_end": ({"name", "unit", "better", "bound", "source"}, {"workloads"}),
    "per_layer": ({"name", "unit", "better", "source", "layer", "moves"}, {"workloads"}),
}


@pytest.mark.parametrize("kind", sorted(ENTRY_KEYS))
def test_entries_have_exactly_their_keys(kind):
    required, optional = ENTRY_KEYS[kind]
    assert 1 <= len(BENCH[kind])
    for e in BENCH[kind]:
        assert required <= set(e) <= required | optional, (kind, e.get("name"))
        for key in ("why", "layer", "source"):
            if isinstance(e.get(key), str):
                text = e[key]
                assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text, (kind, key)


def test_names_and_units():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names += [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_each_cell_reports_what_its_layers_move():
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in manifest.metrics_of(w["name"], "end_to_end")}
        layers = manifest.metrics_of(w["name"], "per_layer")
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert layers, w["name"]
        for m in layers:
            assert m["moves"] in e2e, (w["name"], m["name"])


def test_four_chip_cells_at_most_a_quarter():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_file_found_by_name(w):
    assert manifest.config(w["config"])["compute_dtype"] == "bfloat16"
    from portbench import drivers

    assert issubclass(drivers.load(manifest.traffic(w["traffic"])["entry"]), drivers.Driver)
    limits = manifest.limits(w["name"])
    assert set(limits) <= set(check.NUMBERS)
    assert {"emit_err", "dp_diff", "words_diff", "missing"} <= set(limits)
    assert limits["dp_diff"] == limits["words_diff"] == limits["missing"] == 0
    for m in manifest.metrics_of(w["name"], "per_layer"):
        assert callable(manifest.reader(m["name"]))


def test_config_files_keep_their_widths():
    for c in BENCH["configs"]:
        cfg = manifest.config(c["name"])
        assert c["reduced"] == cfg["reduced"] == []
        assert c["file"].startswith("portbench/configs/")
        assert cfg["source"].startswith(c["source"])
