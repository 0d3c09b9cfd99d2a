"""`BENCHMARK.json` and the files it names, found by name.

- a cell: an entry of `workloads` (its `config` and `traffic`);
- a configuration: the `file` of its entry in `configs` (config.json keys,
  the vocab, the compute dtype);
- a traffic mix: `traffic/<traffic>.json`, whose `entry` names its driver
  (`drivers/<entry>.py`);
- the limits of the check: `limits/<cell>.json`;
- a per-layer metric: `metrics/<name>.py`, a module with `read(run)` that
  returns the metric's value or None when the run has nothing to read.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def root() -> Path:
    """The checkout's root: the directory holding BENCHMARK.json above us."""
    return HERE.parent


def benchmark() -> dict:
    return json.loads((root() / "BENCHMARK.json").read_text())


def cell(name: str) -> dict:
    bench = benchmark()
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    for c in benchmark()["configs"]:
        if c["name"] == name:
            return json.loads((root() / c["file"]).read_text())
    raise SystemExit(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def limits(cell_name: str) -> dict:
    return json.loads((HERE / "limits" / f"{cell_name}.json").read_text())


def metrics_of(cell_name: str, kind: str) -> list[dict]:
    """The `end_to_end` or `per_layer` entries this cell reports."""
    out = []
    for m in benchmark()[kind]:
        cells = m.get("workloads")
        if cells is None or cell_name in cells:
            out.append(m)
    return out


def reader(metric: str):
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location("portbench_metric_" + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
