"""K1, the banded CTC Viterbi kernel, in CUDA C++ for Hopper.

`viterbi_batch` is the wrapper of `csrc/viterbi.cu`, the port of
`wav2vec2_tpu/ops/viterbi_pallas.py::_viterbi_kernel_resident`. For tensors
on the CPU it runs the plain PyTorch version (`ops.viterbi_ref.
viterbi_batch`); for CUDA tensors it launches the kernel or raises — there
is no fallback.

The source is compiled at first use with `nvcc` into a shared library with
a plain C interface under `build/torch_kernels/` at the repository root
(rebuilt when the source is newer), and loaded with `ctypes`. Pointers and
the stream go in as `ctypes.c_void_p`.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from . import viterbi_ref

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "viterbi.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
LIBRARY = BUILD_DIR / "libviterbi_k1.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
MAX_SMEM_BYTES = 232_448  # per block on H100, opt-in dynamic shared memory


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    nvcc = os.path.join(home, "bin", "nvcc")
    if os.path.exists(nvcc):
        return nvcc
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def build(force: bool = False) -> dict:
    """Compile the kernel library if it is missing or older than its source.
    Returns {"library", "seconds", "compiler_output"} (seconds is 0.0 when
    the library was up to date)."""
    if (not force and LIBRARY.exists()
            and LIBRARY.stat().st_mtime >= SOURCE.stat().st_mtime):
        return {"library": str(LIBRARY), "seconds": 0.0, "compiler_output": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n{res.stdout}{res.stderr}"
        )
    os.replace(tmp, LIBRARY)
    return {"library": str(LIBRARY), "seconds": seconds,
            "compiler_output": res.stdout + res.stderr}


@functools.cache
def _library() -> ctypes.CDLL:
    build()
    lib = ctypes.CDLL(str(LIBRARY))
    lib.viterbi_k1_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p
    ]
    lib.viterbi_k1_launch.restype = ctypes.c_int
    lib.viterbi_k1_smem_bytes.argtypes = [ctypes.c_int]
    lib.viterbi_k1_smem_bytes.restype = ctypes.c_size_t
    return lib


def _check_inputs(log_probs, tokens, t_lens, s_lens) -> None:
    dev = log_probs.device
    named = {"log_probs": log_probs, "tokens": tokens, "t_lens": t_lens,
             "s_lens": s_lens}
    for name, x in named.items():
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, log_probs on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if log_probs.dtype != torch.float32:
        raise TypeError(f"log_probs must be float32, got {log_probs.dtype}")
    for name in ("tokens", "t_lens", "s_lens"):
        if named[name].dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {named[name].dtype}")
    if log_probs.dim() != 3 or tokens.dim() != 2:
        raise ValueError(
            f"want log_probs [B, T, V] and tokens [B, S], got "
            f"{tuple(log_probs.shape)} and {tuple(tokens.shape)}"
        )
    b = log_probs.shape[0]
    if tokens.shape[0] != b or t_lens.shape != (b,) or s_lens.shape != (b,):
        raise ValueError(
            f"batch sizes disagree: log_probs {b}, tokens {tokens.shape[0]}, "
            f"t_lens {tuple(t_lens.shape)}, s_lens {tuple(s_lens.shape)}"
        )


def viterbi_batch(
    log_probs: torch.Tensor,
    tokens: torch.Tensor,
    t_lens: torch.Tensor,
    s_lens: torch.Tensor,
) -> torch.Tensor:
    """Banded CTC Viterbi over a padded batch: log_probs [B, T_pad, V] f32,
    tokens [B, S_pad] i32, t_lens/s_lens [B] i32 → paths [B, T_pad] i32
    (frames >= t_len hold the final state). On CUDA tensors: one launch on
    the current stream, no synchronisation; `viterbi_batch.launches` counts
    the launches."""
    if log_probs.device.type == "cpu":
        return viterbi_ref.viterbi_batch(log_probs, tokens, t_lens, s_lens)
    if log_probs.device.type != "cuda":
        raise ValueError(f"no Viterbi kernel for device {log_probs.device}")
    _check_inputs(log_probs, tokens, t_lens, s_lens)
    b, t_pad, vocab = log_probs.shape
    s_pad = tokens.shape[1]
    lib = _library()
    smem = lib.viterbi_k1_smem_bytes(s_pad)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"S_pad={s_pad} needs {smem} B of shared memory per block, more "
            f"than {MAX_SMEM_BYTES}; longer transcripts need the blocked tiers"
        )
    dev = log_probs.device
    bp = torch.empty((b, t_pad, s_pad), dtype=torch.uint8, device=dev)
    paths = torch.empty((b, t_pad), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.viterbi_k1_launch(
            log_probs.data_ptr(), tokens.data_ptr(), t_lens.data_ptr(),
            s_lens.data_ptr(), bp.data_ptr(), paths.data_ptr(),
            b, t_pad, vocab, s_pad, stream,
        )
    if err != 0:
        raise RuntimeError(f"viterbi_k1 launch failed: cudaError {err}")
    viterbi_batch.launches += 1
    return paths


viterbi_batch.launches = 0


def viterbi_single(
    log_probs: torch.Tensor, tokens: torch.Tensor, t_len: int, s_len: int
) -> torch.Tensor:
    """One utterance through the batch wrapper: log_probs [T_pad, V],
    tokens [S_pad] → path [T_pad]."""
    lens = torch.tensor([[t_len], [s_len]], dtype=torch.int32,
                        device=log_probs.device)
    return viterbi_batch(log_probs[None], tokens[None], lens[0], lens[1])[0]
