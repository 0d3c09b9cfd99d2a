"""Build and load the port's host C++ libraries.

The native grouping engine (`native/grouping.cpp`) and the FLAC decoder
(`native/flac_decoder.cpp`) at the repository root are compiled at first use
with `g++` and the flags of `native/Makefile` into
`build/torch_native/lib<name>.so`, rebuilt when the source is newer. The
build holds a file lock, so processes that start together (a parallel test
run) compile each library once, and the library is renamed into place, so
no process ever loads a half-written file. The JAX package builds its own
copies inside `native/`; the port never writes there.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
NATIVE_DIR = ROOT / "native"
BUILD_DIR = ROOT / "build" / "torch_native"
SOURCES = {"grouping": NATIVE_DIR / "grouping.cpp",
           "flacdec": NATIVE_DIR / "flac_decoder.cpp"}
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared"]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _up_to_date(lib: Path, src: Path) -> bool:
    return lib.exists() and lib.stat().st_mtime >= src.stat().st_mtime


def build(name: str, force: bool = False) -> Path:
    """Compile `lib<name>.so` if it is missing or older than its source
    (always with `force`); returns its path. Raises RuntimeError when the
    compiler fails or is missing."""
    import fcntl

    src, lib = SOURCES[name], library_path(name)
    if not force and _up_to_date(lib, src):
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"lib{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not force and _up_to_date(lib, src):  # built while we waited
            return lib
        tmp = lib.with_suffix(f".{os.getpid()}.tmp.so")
        cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp), str(src)]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True)
        except FileNotFoundError as e:
            raise RuntimeError(f"no C++ compiler: {cmd[0]}") from e
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{' '.join(cmd)} failed ({res.returncode}):\n{res.stderr}")
        os.replace(tmp, lib)
    return lib


def load(name: str) -> ctypes.CDLL:
    """`lib<name>.so`, built if needed."""
    return ctypes.CDLL(str(build(name)))
