"""Build and load the port's CUDA kernels.

Every source under `csrc/` (the Viterbi kernels K1–K4 and the fused
attention kernel K5) is compiled at first use with one `nvcc` call for
`sm_90a` into one shared library with a plain C interface under
`build/torch_kernels/` at the repository root (rebuilt when a source is
newer), and loaded with `ctypes`. Each wrapper module (`viterbi_cuda`,
`flash_attention`) declares the argument types of its own C functions on
the loaded library. Pointers and the stream go in as `ctypes.c_void_p`.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = (CSRC / "viterbi.cu", CSRC / "viterbi_blocked.cu",
           CSRC / "flash_attention.cu")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
LIBRARY = BUILD_DIR / "libkernels.so"
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
    """Compile the kernel library if it is missing or older than a source.
    Returns {"library", "seconds", "compiler_output"} (seconds is 0.0 when
    the library was up to date)."""
    newest = max(src.stat().st_mtime for src in SOURCES)
    if not force and LIBRARY.exists() and LIBRARY.stat().st_mtime >= newest:
        return {"library": str(LIBRARY), "seconds": 0.0, "compiler_output": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
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
def library() -> ctypes.CDLL:
    """The kernel library, built if needed and loaded once per process."""
    build()
    return ctypes.CDLL(str(LIBRARY))
