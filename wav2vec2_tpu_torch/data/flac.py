"""FLAC decoding via the native C++ decoder (native/flac_decoder.cpp).

Carried over from `wav2vec2_tpu.data.flac`. ctypes bindings; the shared
library is built on first use by `utils.native_build` into
`build/torch_native/` (the port never writes into `native/` or the JAX
package). Output semantics match the reference's read_flac_mono
(alignment_report.rs:1405-1445): scale by 2^(bits-1), average channels,
float32.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from ..errors import RuntimeBackendError

_lib = None


class _FlacDecoded(ctypes.Structure):
    _fields_ = [
        ("samples", ctypes.POINTER(ctypes.c_int32)),
        ("n_frames", ctypes.c_uint64),
        ("sample_rate", ctypes.c_uint32),
        ("channels", ctypes.c_uint32),
        ("bits_per_sample", ctypes.c_uint32),
    ]


def _load_library() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    from ..utils import native_build

    try:
        lib = native_build.load("flacdec")
    except (RuntimeError, OSError) as e:
        raise RuntimeBackendError("build flac decoder", str(e)) from e
    lib.flac_decode_file.argtypes = [ctypes.c_char_p, ctypes.POINTER(_FlacDecoded)]
    lib.flac_decode_file.restype = ctypes.c_int
    lib.flac_decode_buffer.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(_FlacDecoded)
    ]
    lib.flac_decode_buffer.restype = ctypes.c_int
    lib.flac_free.argtypes = [ctypes.POINTER(_FlacDecoded)]
    lib.flac_free.restype = None
    _lib = lib
    return lib


def _decoded_to_arrays(res: _FlacDecoded) -> tuple[np.ndarray, int, int]:
    n = int(res.n_frames) * int(res.channels)
    if n == 0:
        interleaved = np.zeros(0, np.int32)
    else:
        interleaved = np.ctypeslib.as_array(res.samples, shape=(n,)).copy()
    return interleaved, int(res.sample_rate), int(res.channels)


def read_flac_raw(path: str | Path) -> tuple[np.ndarray, int, int, int]:
    """Decode → (interleaved int32 samples, sample_rate, channels, bits)."""
    lib = _load_library()
    res = _FlacDecoded()
    rc = lib.flac_decode_file(str(path).encode(), ctypes.byref(res))
    if rc != 0:
        raise RuntimeBackendError("decode flac", f"{path}: decoder error {rc}")
    try:
        interleaved, rate, channels = _decoded_to_arrays(res)
        bits = int(res.bits_per_sample)
    finally:
        lib.flac_free(ctypes.byref(res))
    return interleaved, rate, channels, bits


def read_flac_mono(path: str | Path) -> tuple[np.ndarray, int]:
    """Decode → (float32 mono in [-1, 1], sample_rate), reference
    read_flac_mono semantics."""
    interleaved, rate, channels, bits = read_flac_raw(path)
    scale = float(1 << (bits - 1))
    x = interleaved.astype(np.float32) / scale
    if channels > 1:
        x = x.reshape(-1, channels).mean(axis=1)
    return x.astype(np.float32), rate


def read_flac_mono_int16(path: str | Path) -> tuple[np.ndarray, int]:
    """Decode → (int16 mono PCM, sample_rate) — the zero-copy-to-device
    input for the batch aligner's on-device normalization path."""
    interleaved, rate, channels, bits = read_flac_raw(path)
    if channels > 1:
        interleaved = (
            interleaved.reshape(-1, channels).mean(axis=1).round().astype(np.int64)
        )
    shift = bits - 16
    if shift > 0:
        x = (interleaved >> shift).astype(np.int16)
    elif shift < 0:
        x = (interleaved.astype(np.int64) << -shift).astype(np.int16)
    else:
        x = interleaved.astype(np.int16)
    return x, rate
