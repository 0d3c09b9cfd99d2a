"""Environment diagnostics: `python -m wav2vec2_tpu_torch.doctor [--model-dir D]`
(counterpart of `wav2vec2_tpu.doctor`).

Operational triage for deployments of the port — answers "why is
alignment slow / failing here" in one command: the CUDA device, the CUDA
kernel library, the native components, optional dependencies, and
(optionally) a model dir's integrity. Prints one line per check and exits
non-zero if any required check fails. The port runs on a GPU unless asked
for the CPU, so no CUDA device is a failure here, with the `--device cpu`
hint.
"""

from __future__ import annotations

import argparse
import importlib.util
import subprocess
import sys
from pathlib import Path

OK, WARN, FAIL = "ok", "warn", "FAIL"
HOPPER = (9, 0)  # the kernels are built for sm_90a


def _line(status: str, name: str, detail: str) -> None:
    print(f"[{status:>4s}] {name}: {detail}")


def _power_limit() -> str:
    """The card's power limit as nvidia-smi prints it, or why it was not
    read."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"power limit not read ({type(e).__name__})"
    if res.returncode != 0 or not res.stdout.strip():
        return "power limit not read (nvidia-smi failed)"
    return f"power limit {res.stdout.strip().splitlines()[0]}"


def check_cuda(timeout_s: float = 90.0) -> bool:
    # a wedged driver or card can make CUDA initialisation hang rather than
    # error — probe in a daemon thread so doctor itself stays responsive
    # and can report the hang (the situation doctor exists to diagnose)
    import threading

    result: dict = {}

    def probe():
        try:
            import torch

            if not torch.cuda.is_available():
                result["none"] = True
                return
            torch.cuda.init()
            result["devs"] = (torch.cuda.device_count(), torch.cuda.get_device_name(0),
                              torch.cuda.get_device_capability(0))
        except Exception as e:  # report any init failure verbatim
            result["err"] = e

    th = threading.Thread(target=probe, daemon=True)
    th.start()
    th.join(timeout_s)
    if th.is_alive():
        _line(FAIL, "accelerator",
              f"CUDA initialization still blocked after {timeout_s:.0f}s "
              "— the GPU driver or card is likely wedged (it hangs instead "
              "of erroring). Run with --device cpu, or retry once the "
              "device is reset")
        return False
    if "err" in result:
        _line(FAIL, "accelerator", f"CUDA initialization failed: {result['err']}")
        return False
    if "none" in result:
        _line(FAIL, "accelerator",
              "torch sees no CUDA device — the port runs on a GPU by default; "
              "pass --device cpu to run on the CPU")
        return False
    n, name, cap = result["devs"]
    status = OK if tuple(cap) == HOPPER else WARN
    _line(status, "accelerator",
          f"{n} × cuda ({name}, sm_{cap[0]}{cap[1]}, {_power_limit()})"
          + ("" if status == OK else " — the kernels are built for sm_90a (Hopper) "
             "and will not load on this card"))
    return True


def _kernel_symbols() -> list[str]:
    from .ops import flash_attention, viterbi_cuda

    names = [f"viterbi_{n}_launch" for n in ("k1_device", "k1_resident", "k2", "k3", "k4")]
    names += [f"viterbi_{tier}_smem_bytes" for tier in viterbi_cuda.TIERS]
    names += ["viterbi_k1_resident", "viterbi_blocked_strip", "viterbi_k1_strip",
              "viterbi_k4_cluster"]
    names += [f"flash_attention_{kernel}_launch" for kernel in flash_attention._KERNELS.values()]
    names += ["flash_attention_smem_bytes"]
    return names


def check_kernels() -> bool:
    """nvcc found, the build directory writable, the kernel library up to
    date (or rebuilt now), and every kernel symbol resolved."""
    import ctypes

    from .ops import cuda_build

    try:
        nvcc = cuda_build._nvcc()
    except RuntimeError as e:
        _line(FAIL, "cuda kernels", f"{e} — the kernels build at first use")
        return False
    build_dir = cuda_build.BUILD_DIR
    try:
        build_dir.mkdir(parents=True, exist_ok=True)
        probe = build_dir / ".doctor_probe"
        probe.write_text("x")
        probe.unlink()
    except OSError as e:
        _line(FAIL, "cuda kernels", f"{build_dir} not writable ({e})")
        return False
    try:
        info = cuda_build.build()
        lib = ctypes.CDLL(info["library"])
    except (RuntimeError, OSError) as e:
        _line(FAIL, "cuda kernels", f"build or load failed: {e}")
        return False
    missing = [s for s in _kernel_symbols() if not hasattr(lib, s)]
    if missing:
        _line(FAIL, "cuda kernels", f"{info['library']} lacks {', '.join(missing)}")
        return False
    built = (f"rebuilt in {info['seconds']:.1f} s" if info["seconds"] else "up to date")
    _line(OK, "cuda kernels",
          f"{info['library']} {built} ({nvcc}); {len(_kernel_symbols())} symbols resolved")
    return True


def check_native() -> bool:
    ok = True
    try:
        from .data import flac

        flac._load_library()
        _line(OK, "native flac decoder", "loaded")
    except Exception as e:
        _line(FAIL, "native flac decoder", f"{e} (g++ builds it into build/torch_native/)")
        ok = False
    try:
        from .align.grouping.native import native_available

        if native_available():
            _line(OK, "native grouping engine", "loaded")
        else:
            _line(WARN, "native grouping engine",
                  "unavailable — the Python grouping is slower per utterance")
    except Exception as e:
        _line(WARN, "native grouping engine", f"{e}")
    return ok


def check_optional_deps() -> bool:
    # find_spec locates a package without importing it
    for mod, why in [("transformers", "loading-parity tests against HF models"),
                     ("onnxruntime", "the JAX package's optional ONNX backend")]:
        if importlib.util.find_spec(mod) is not None:
            _line(OK, f"optional: {mod}", "installed")
        else:
            _line(WARN, f"optional: {mod}", f"absent — needed only for {why}")
    return True


def check_model_dir(model_dir: str) -> bool:
    from .config import Wav2Vec2ModelConfig, load_vocab

    d = Path(model_dir)
    ok = True
    for name in ("model.safetensors", "config.json", "vocab.json"):
        if not (d / name).exists():
            _line(FAIL, "model dir", f"missing {d / name}")
            ok = False
    if not ok:
        return False
    try:
        cfg = Wav2Vec2ModelConfig.load(d / "config.json")
        _line(OK, "config.json",
              f"hidden={cfg.hidden_size} layers={cfg.num_hidden_layers} "
              f"vocab={cfg.vocab_size} stride="
              f"{cfg.frame_stride_ms(16000):.0f}ms "
              f"pos_conv={cfg.pos_conv_style} attn={cfg.attention_style}")
    except Exception as e:
        _line(FAIL, "config.json", str(e))
        return False
    try:
        vocab = load_vocab(d / "vocab.json")
        sep = "|" in vocab
        _line(OK if sep else WARN, "vocab.json",
              f"{len(vocab)} single-char entries"
              + ("" if sep else " — no '|' separator: word_sep falls back to 0"))
    except Exception as e:
        _line(FAIL, "vocab.json", str(e))
        return False
    try:
        from .utils.checkpoint import safetensors_names

        keys = safetensors_names(d / "model.safetensors")
        prefixes = {k.split(".", 1)[0] for k in keys}
        fam = (prefixes & {"wav2vec2", "hubert", "data2vec_audio", "wavlm"})
        _line(OK, "model.safetensors",
              f"{len(keys)} tensors, family prefix: "
              f"{', '.join(sorted(fam)) or 'custom'}")
    except Exception as e:
        _line(FAIL, "model.safetensors", str(e))
        return False
    return True


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model-dir", default=None)
    args = p.parse_args(argv)

    checks = [check_cuda(), check_kernels(), check_native(), check_optional_deps()]
    if args.model_dir:
        checks.append(check_model_dir(args.model_dir))
    healthy = all(checks)
    print("healthy" if healthy else "PROBLEMS FOUND")
    return 0 if healthy else 1


if __name__ == "__main__":
    sys.exit(main())
