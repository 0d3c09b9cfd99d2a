"""Run one cell of the benchmark once, on the machine it starts on.

    python3 -m portbench.run --workload base.batch --seed 7 --seconds 40 --trace 0

from the root of a checkout. It builds the port's kernels and native
libraries where they are missing (inside the checkout, under `build/`),
makes the weights and the traffic's audio from the seed, warms up the cell's
shapes, measures for `--seconds`, then judges a seeded sample of what the
window produced against the plain reference (`check.py`). The last line
of standard output is one JSON object: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics with `--trace 0`, its per-layer
ones with `--trace 1`), `device` and, traced, `breakdown`; its last key,
`checks`, gives each number compared beside its limit, as do the last
lines of standard error. Earlier lines give the launches of each kernel
tier, the peak device memory and the card's power limit.

Without a CUDA device, or with fewer than the cell asks for, it exits 2
and prints no result; so it does when JAX or the JAX package is loaded
once the window has closed (exit 3).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import warnings  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "wav2vec2_tpu")
CACHE = Path(__file__).resolve().parent / "out" / "cache"


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that the benchmark must not load,
    each compared whole (`wav2vec2_tpu_torch` is not `wav2vec2_tpu`)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


class Context:
    """What the drivers, the check and the readers share."""

    def __init__(self, workload: str, seed: int, device: str):
        from . import manifest

        self.cell = manifest.cell(workload)
        self.cfg = manifest.config(self.cell["config"])
        self.mix = manifest.traffic(self.cell["traffic"])
        self.seed = seed
        self.device = device
        self.dtype = self.cfg["compute_dtype"]
        self.vocab = {k: int(v) for k, v in self.cfg["vocab"].items()}
        self.blank_id = int(self.cfg["pad_token_id"])
        self.word_sep_id = self.vocab.get("|", 0)
        self.model_cfg = None
        self.params = None

    def sync(self):
        import torch

        if self.device == "cuda":
            torch.cuda.synchronize()


def model_config(cfg: dict):
    from wav2vec2_tpu_torch.config import Wav2Vec2ModelConfig

    return Wav2Vec2ModelConfig.from_dict({k: v for k, v in cfg.items()
                                          if k not in ("vocab", "compute_dtype")})


def build_program(device: str) -> None:
    """The kernel library (nvcc on a checkout's first run) and the native
    grouping engine (g++), both under the checkout's `build/`."""
    from wav2vec2_tpu_torch.align.grouping import native

    if device == "cuda":
        from wav2vec2_tpu_torch.ops import cuda_build

        cuda_build.library()
    native.native_available()


def reset_counters() -> None:
    from wav2vec2_tpu_torch.align import grouping
    from wav2vec2_tpu_torch.ops import flash_attention, viterbi_cuda

    for counts in (viterbi_cuda.launches, viterbi_cuda.k1_launches, viterbi_cuda.k4_clusters,
                   flash_attention.launches, flash_attention.kernel_launches,
                   grouping.engine_calls):
        for name in counts:
            counts[name] = 0


def read_counters() -> dict:
    from wav2vec2_tpu_torch.align import grouping
    from wav2vec2_tpu_torch.ops import flash_attention, viterbi_cuda

    return {**viterbi_cuda.launches, **flash_attention.launches,
            **{f"k1_{m}": n for m, n in viterbi_cuda.k1_launches.items()},
            **{f"k4_cluster_{c}": n for c, n in sorted(viterbi_cuda.k4_clusters.items())},
            **{f"k5_{k}": n for k, n in flash_attention.kernel_launches.items()},
            **{f"grouping_{e}": n for e, n in grouping.engine_calls.items()}}


class RunView:
    """What a per-layer reader sees of a traced run."""

    def __init__(self, ctx, driver, trace, recorder, counters, seconds):
        self.ctx, self.driver, self.trace = ctx, driver, trace
        self.recorder, self.counters, self.seconds = recorder, counters, seconds


def run(workload: str, seed: int, seconds: float, traced: bool,
        device: str = "cuda") -> tuple[dict, dict]:
    """One run of a cell: (the result object, what the earlier lines print:
    launches, forbidden modules, the driver's counts)."""
    import gc

    import torch

    from . import check, drivers, manifest, probes, weights
    from . import trace as tracing

    ctx = Context(workload, seed, device)
    build_program(device)
    ctx.model_cfg = model_config(ctx.cfg)
    ctx.params = weights.make(ctx.cfg, seed, device)
    driver = drivers.load(ctx.mix["entry"])(ctx)
    driver.setup()
    capture = probes.Capture()
    recorder = probes.Recorder() if traced else None
    trace = tracing.Trace() if traced else None
    with probes.installed(capture, *([recorder] if recorder else [])):
        capture.install(driver.aligner)
        if recorder is not None:
            recorder.install(driver.aligner)
        ctx.sync()
        reset_counters()
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - T_START
        capture.active = True
        if recorder is not None:
            recorder.active = True
        with tracing.window(trace, recorder.spans if recorder else None):
            out = driver.window(seconds)
        capture.active = False
        if recorder is not None:
            recorder.active = False
    counters = read_counters()
    stats = dict(driver.stats)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    found = forbidden_modules()
    view = RunView(ctx, driver, trace, recorder, counters, seconds)
    metrics = {}
    if traced:
        for m in manifest.metrics_of(workload, "per_layer"):
            value = manifest.reader(m["name"])(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        units = {m["name"]: m["unit"] for m in manifest.metrics_of(workload, "end_to_end")}
        values = {"setup_s": setup_s, **out["metrics"]}
        metrics = {name: {"value": values[name], "unit": unit} for name, unit in units.items()}
    judged = driver.sample(capture.got)
    answers = driver.answers(judged)
    driver.close()
    del driver, view
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = check.judge(ctx, judged, capture.got, answers, capture.outputs)
    if not out["attempted"]:
        numbers["missing"] = max(numbers["missing"], 1)  # the window completed nothing
    check_s = time.perf_counter() - t_check
    limits = manifest.limits(workload)
    result = {
        "correct": check.verdict(numbers, limits),
        "attempted": out["attempted"],
        "failed": out["failed"],
        "metrics": metrics,
        "device": device_info(ctx, peak, trace),
    }
    if trace is not None:
        result["breakdown"] = {"device_ops": trace.device_ops(), "idle_gaps": trace.idle_gaps()}
    result["checks"] = {name: {"value": numbers[name], "limit": limit}
                        for name, limit in limits.items()}
    return result, dict(launches=counters, forbidden=found, stats=stats, check_s=check_s)


def device_info(ctx, peak: int, trace) -> dict:
    import torch

    info = {"platform": "gpu" if ctx.device == "cuda" else ctx.device,
            "kind": torch.cuda.get_device_name(0) if ctx.device == "cuda" else "cpu",
            "count": int(ctx.cell["chips"]), "memory_peak_bytes": int(peak)}
    if trace is not None:
        info["busy_s"] = trace.busy_s
        info["window_s"] = trace.window_s
    return info


def power_limit() -> str:
    import subprocess

    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return res.stdout.strip() or res.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in (("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    # the profiler's note that it keeps one cycle: the traced window is one
    warnings.filterwarnings("ignore", message="Warning: Profiler clears events")
    import torch

    from . import manifest

    chips = int(manifest.cell(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    print(f"portbench: card {power_limit()}", flush=True)
    result, extras = run(args.workload, args.seed, args.seconds, bool(args.trace))
    print(f"portbench: launches {json.dumps(extras['launches'])}", flush=True)
    print(f"portbench: window {json.dumps(extras['stats'])}", flush=True)
    print(f"portbench: memory_peak_bytes {result['device']['memory_peak_bytes']}", flush=True)
    print(f"portbench: check_s {extras['check_s']}", flush=True)
    if extras["forbidden"]:
        print(f"portbench: loaded after the window: {extras['forbidden']}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
