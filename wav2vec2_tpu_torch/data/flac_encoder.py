"""Minimal FLAC encoder (pure Python).

Exists for two purposes: (1) round-trip tests of the native C++ decoder in
an environment with no FLAC tooling, and (2) the dataset-converter scripts
(HF/VoxPopuli → LibriSpeech layout) which need to EMIT .flac files like the
reference's converters do (scripts/export_hf_to_librispeech_layout.py).

Emits spec-valid streams: STREAMINFO, fixed-blocksize frames with proper
CRC-8/CRC-16, UTF-8 frame numbers, and a choice of subframe strategies —
CONSTANT, VERBATIM, FIXED(0-2) with single-partition Rice residuals, LPC
order 1, and independent or mid/side stereo.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


class _BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, value: int, bits: int) -> None:
        if bits == 0:
            return
        value &= (1 << bits) - 1
        self.acc = (self.acc << bits) | value
        self.nbits += bits
        while self.nbits >= 8:
            self.nbits -= 8
            self.buf.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def write_signed(self, value: int, bits: int) -> None:
        self.write(value & ((1 << bits) - 1), bits)

    def write_unary(self, q: int) -> None:
        while q >= 32:
            self.write(0, 32)
            q -= 32
        self.write(1, q + 1)

    def align(self) -> None:
        if self.nbits:
            self.write(0, 8 - self.nbits)

    def bytes(self) -> bytes:
        assert self.nbits == 0
        return bytes(self.buf)


def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
    return crc


def _crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x8005) & 0xFFFF if crc & 0x8000 else (crc << 1) & 0xFFFF
    return crc


def _utf8_number(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    out = []
    bits = n.bit_length()
    n_bytes = 2
    while bits > 1 + 5 * (n_bytes - 1) + (7 - n_bytes):
        n_bytes += 1
    shift = 6 * (n_bytes - 1)
    lead_mask = (0xFF << (8 - n_bytes)) & 0xFF
    out.append(lead_mask | (n >> shift))
    for i in range(n_bytes - 1):
        shift -= 6
        out.append(0x80 | ((n >> shift) & 0x3F))
    return bytes(out)


def _zigzag(v: np.ndarray) -> np.ndarray:
    return np.where(v >= 0, v.astype(np.int64) * 2, -2 * v.astype(np.int64) - 1)


def _rice_param(residuals: np.ndarray) -> int:
    if len(residuals) == 0:
        return 0
    mean = float(np.abs(residuals).mean())
    k = 0
    while (1 << k) < mean + 1 and k < 14:
        k += 1
    return k


def _write_rice_residual(bw: _BitWriter, residuals: np.ndarray, order: int) -> None:
    bw.write(0, 2)  # method: 4-bit rice
    bw.write(0, 4)  # partition order 0 (single partition)
    k = _rice_param(residuals)
    bw.write(k, 4)
    for u in _zigzag(residuals):
        q = int(u) >> k
        bw.write_unary(q)
        if k:
            bw.write(int(u) & ((1 << k) - 1), k)


def _write_subframe(bw: _BitWriter, x: np.ndarray, bps: int, strategy: str) -> None:
    x = x.astype(np.int64)
    if strategy == "constant" and np.all(x == x[0]):
        bw.write(0, 1)
        bw.write(0, 6)
        bw.write(0, 1)
        bw.write_signed(int(x[0]), bps)
        return
    if strategy in ("fixed0", "fixed1", "fixed2") and len(x) > 2:
        order = int(strategy[-1])
        bw.write(0, 1)
        bw.write(8 + order, 6)
        bw.write(0, 1)
        for i in range(order):
            bw.write_signed(int(x[i]), bps)
        res = x.copy()
        for _ in range(order):
            res = np.diff(res)
        _write_rice_residual(bw, res, order)
        return
    if strategy == "lpc1" and len(x) > 1:
        # order-1 LPC with coefficient 1 (shift 0): residual = x[i] - x[i-1]
        bw.write(0, 1)
        bw.write(32 + 0, 6)  # LPC order 1
        bw.write(0, 1)
        bw.write_signed(int(x[0]), bps)
        bw.write(4 - 1, 4)  # precision 4 bits
        bw.write_signed(0, 5)  # shift 0
        bw.write_signed(1, 4)  # coefficient 1
        _write_rice_residual(bw, np.diff(x), 1)
        return
    # verbatim fallback
    bw.write(0, 1)
    bw.write(1, 6)
    bw.write(0, 1)
    for v in x:
        bw.write_signed(int(v), bps)


def encode_flac(
    samples: np.ndarray,
    sample_rate: int = 16000,
    bits_per_sample: int = 16,
    block_size: int = 4096,
    strategy: str = "fixed1",
    stereo_mode: str = "independent",
) -> bytes:
    """samples: int array [N] (mono) or [N, 2] (stereo)."""
    x = np.asarray(samples, dtype=np.int64)
    channels = 1 if x.ndim == 1 else x.shape[1]
    n = x.shape[0]

    out = bytearray(b"fLaC")
    # STREAMINFO (last metadata block)
    si = _BitWriter()
    si.write(block_size, 16)
    si.write(block_size, 16)
    si.write(0, 24)  # min frame size unknown
    si.write(0, 24)
    si.write(sample_rate, 20)
    si.write(channels - 1, 3)
    si.write(bits_per_sample - 1, 5)
    si.write(n, 36)
    for _ in range(16):
        si.write(0, 8)  # md5 unset
    body = si.bytes()
    out += bytes([0x80]) + len(body).to_bytes(3, "big") + body

    frame_idx = 0
    for start in range(0, max(n, 1), block_size):
        block = x[start : start + block_size]
        if block.shape[0] == 0:
            break
        bs = block.shape[0]

        hw = _BitWriter()
        hw.write(0x3FFE, 14)
        hw.write(0, 1)  # reserved
        hw.write(0, 1)  # fixed blocksize strategy
        hw.write(7, 4)  # block size: 16-bit at end of header
        sr_codes = {88200: 1, 176400: 2, 192000: 3, 8000: 4, 16000: 5, 22050: 6,
                    24000: 7, 32000: 8, 44100: 9, 48000: 10, 96000: 11}
        hw.write(sr_codes.get(sample_rate, 0), 4)
        use_midside = channels == 2 and stereo_mode == "mid-side"
        if channels == 2:
            hw.write(10 if use_midside else 1, 4)
        else:
            hw.write(0, 4)
        hw.write({8: 1, 12: 2, 16: 4, 20: 5, 24: 6, 32: 7}[bits_per_sample], 3)
        hw.write(0, 1)
        header = hw.bytes() + _utf8_number(frame_idx)
        header += (bs - 1).to_bytes(2, "big")
        header += bytes([_crc8(header)])

        bw = _BitWriter()
        if channels == 1:
            _write_subframe(bw, block, bits_per_sample, strategy)
        elif use_midside:
            left = block[:, 0]
            right = block[:, 1]
            mid = (left + right) >> 1
            side = left - right
            _write_subframe(bw, mid, bits_per_sample, strategy)
            _write_subframe(bw, side, bits_per_sample + 1, strategy)
        else:
            for c in range(channels):
                _write_subframe(bw, block[:, c], bits_per_sample, strategy)
        bw.align()
        frame = header + bw.bytes()
        frame += _crc16(frame).to_bytes(2, "big")
        out += frame
        frame_idx += 1

    return bytes(out)


def write_flac(path: str | Path, samples: np.ndarray, sample_rate: int = 16000,
               **kwargs) -> None:
    Path(path).write_bytes(encode_flac(samples, sample_rate, **kwargs))
