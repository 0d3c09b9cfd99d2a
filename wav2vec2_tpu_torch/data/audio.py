"""Audio decoding: WAV (pure numpy) and FLAC (native C++ decoder).

Semantics match the reference's `read_flac_mono`
(src/bin/alignment_report.rs:1405-1445 in the Rust reference): integer samples are
scaled by 2^(bits-1), multi-channel audio is averaged to mono, output is
float32.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from ..errors import InvalidInputError, IoError


def read_audio_mono(path: str | Path) -> tuple[np.ndarray, int]:
    """Decode an audio file → (float32 mono samples in [-1, 1], sample_rate)."""
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix == ".wav":
        return read_wav_mono(path)
    if suffix == ".flac":
        from .flac import read_flac_mono

        return read_flac_mono(path)
    raise InvalidInputError(f"unsupported audio format: {path}")


def read_wav_mono(path: str | Path) -> tuple[np.ndarray, int]:
    """Minimal RIFF/WAVE reader: PCM 16/24/32-bit and IEEE float32."""
    try:
        data = Path(path).read_bytes()
    except OSError as e:
        raise IoError(f"read wav {path}", e) from e
    if len(data) < 44 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise InvalidInputError(f"not a RIFF/WAVE file: {path}")

    pos = 12
    fmt = None
    samples = None
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        (chunk_size,) = struct.unpack_from("<I", data, pos + 4)
        body = data[pos + 8 : pos + 8 + chunk_size]
        if chunk_id == b"fmt ":
            audio_format, channels, sample_rate, _, _, bits = struct.unpack_from(
                "<HHIIHH", body, 0
            )
            fmt = (audio_format, channels, sample_rate, bits)
        elif chunk_id == b"data":
            samples = body
        pos += 8 + chunk_size + (chunk_size & 1)

    if fmt is None or samples is None:
        raise InvalidInputError(f"wav missing fmt/data chunk: {path}")
    audio_format, channels, sample_rate, bits = fmt
    if bits % 8 == 0 and bits > 0:
        # tolerate a truncated final sample (np.frombuffer would raise a
        # bare ValueError on a partial element)
        samples = samples[: len(samples) - len(samples) % (bits // 8)]

    if audio_format == 3 and bits == 32:  # IEEE float
        x = np.frombuffer(samples, dtype="<f4").astype(np.float32)
    elif audio_format == 1 and bits == 16:
        x = np.frombuffer(samples, dtype="<i2").astype(np.float32) / 32768.0
    elif audio_format == 1 and bits == 32:
        x = np.frombuffer(samples, dtype="<i4").astype(np.float32) / 2147483648.0
    elif audio_format == 1 and bits == 24:
        raw = np.frombuffer(samples, dtype=np.uint8).reshape(-1, 3)
        as_i32 = (
            raw[:, 0].astype(np.int32)
            | (raw[:, 1].astype(np.int32) << 8)
            | (raw[:, 2].astype(np.int32) << 16)
        )
        as_i32 = np.where(as_i32 >= 1 << 23, as_i32 - (1 << 24), as_i32)
        x = as_i32.astype(np.float32) / float(1 << 23)
    else:
        raise InvalidInputError(
            f"unsupported wav encoding (format={audio_format}, bits={bits}): {path}"
        )

    if channels > 1:
        x = x[: len(x) - len(x) % channels].reshape(-1, channels).mean(axis=1)
    return x.astype(np.float32), sample_rate


def write_wav_mono(
    path: str | Path, samples: np.ndarray, sample_rate: int = 16000
) -> None:
    """Write 16-bit PCM mono WAV (used by tests and dataset converters)."""
    x = np.asarray(samples)
    if x.dtype != np.int16:
        x = np.clip(np.asarray(x, np.float64) * 32768.0, -32768, 32767).astype(np.int16)
    body = x.tobytes()
    header = struct.pack(
        "<4sI4s4sIHHIIHH4sI",
        b"RIFF", 36 + len(body), b"WAVE", b"fmt ", 16, 1, 1,
        sample_rate, sample_rate * 2, 2, 16, b"data", len(body),
    )
    Path(path).write_bytes(header + body)
