"""Build and load the port's CUDA kernels.

Every source under `csrc/` (the Viterbi kernels K1–K4 and the fused
attention kernel K5) is compiled at first use for `sm_90a`, one `nvcc`
process a source, all started together, into objects that one more
`nvcc` links into one shared library with a plain C interface under
`build/torch_kernels/` at the repository root (rebuilt when a source is
newer), and loaded with `ctypes`. Each wrapper module (`viterbi_cuda`,
`flash_attention`) declares the argument types of its own C functions on
the loaded library. Pointers and the stream go in as `ctypes.c_void_p`.

Building and loading hold one lock per process: threads that reach their
first launch together (the serving daemon's batch worker and its stream
sessions) run one `nvcc` between them.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = (CSRC / "viterbi.cu", CSRC / "viterbi_blocked.cu",
           CSRC / "flash_attention.cu")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
LIBRARY = BUILD_DIR / "libkernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# the same, for one source's object
COMPILE_FLAGS = [flag for flag in NVCC_FLAGS if flag != "-shared"] + ["-c"]
MAX_SMEM_BYTES = 232_448  # per block on H100, opt-in dynamic shared memory
_lock = threading.RLock()
_library: ctypes.CDLL | None = None


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
    with _lock:
        newest = max(src.stat().st_mtime for src in SOURCES)
        if not force and LIBRARY.exists() and LIBRARY.stat().st_mtime >= newest:
            return {"library": str(LIBRARY), "seconds": 0.0, "compiler_output": ""}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = LIBRARY.with_suffix(f".{os.getpid()}.tmp.so")
        nvcc = _nvcc()
        objects = [BUILD_DIR / f"{src.stem}.{os.getpid()}.o" for src in SOURCES]
        t0 = time.perf_counter()
        procs = [subprocess.Popen([nvcc, *COMPILE_FLAGS, "-o", str(obj), str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(SOURCES, objects)]
        outputs = [proc.communicate()[0] for proc in procs]
        link = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, objects)]
        failed = [(src, out) for src, proc, out in zip(SOURCES, procs, outputs)
                  if proc.returncode != 0]
        res = None if failed else subprocess.run(link, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        for obj in objects:
            obj.unlink(missing_ok=True)
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(f"{src.name}:\n{out}"
                                                          for src, out in failed))
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}): {' '.join(link)}\n{res.stdout}{res.stderr}"
            )
        os.replace(tmp, LIBRARY)
        return {"library": str(LIBRARY), "seconds": seconds,
                "compiler_output": "".join(outputs) + res.stdout + res.stderr}


def library() -> ctypes.CDLL:
    """The kernel library, built if needed and loaded once per process."""
    global _library
    with _lock:
        if _library is None:
            build()
            _library = ctypes.CDLL(str(LIBRARY))
        return _library
