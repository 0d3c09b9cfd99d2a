"""A small safetensors reader and writer.

The port reads HF checkpoints without the `safetensors` package. The
format: an 8-byte little-endian header length N, N bytes of JSON mapping
each tensor name to {"dtype", "shape", "data_offsets": [begin, end]}
(offsets relative to the end of the header, plus an optional
"__metadata__" entry), then the raw little-endian buffers.

`save_safetensors` is the counterpart of `wav2vec2_tpu.utils.checkpoint.
save_safetensors`: it writes a flat {name: array} dict, for example the HF
names that `models.params.params_to_hf_flat_dict` produces.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np

from ..errors import IoError, RuntimeBackendError

_DTYPES = {
    "F64": np.dtype("<f8"), "F32": np.dtype("<f4"), "F16": np.dtype("<f2"),
    "I64": np.dtype("<i8"), "I32": np.dtype("<i4"), "I16": np.dtype("<i2"),
    "I8": np.dtype("i1"), "U8": np.dtype("u1"), "BOOL": np.dtype("?"),
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def safetensors_names(path: str | Path) -> list[str]:
    """The tensor names of a safetensors file, read from its header alone."""
    try:
        with open(path, "rb") as f:
            head = f.read(8)
            if len(head) < 8:
                raise RuntimeBackendError("load weights", f"{path}: truncated header")
            (n,) = struct.unpack("<Q", head)
            raw = f.read(n)
    except OSError as e:
        raise IoError("read safetensors", e) from e
    if len(raw) < n:
        raise RuntimeBackendError("load weights", f"{path}: header runs past the file")
    return [name for name in json.loads(raw) if name != "__metadata__"]


def load_safetensors(path: str | Path) -> dict[str, np.ndarray]:
    """Read every tensor of a safetensors file into numpy arrays. BF16
    tensors come back as float32 (exact: bf16 is the top half of f32)."""
    try:
        data = Path(path).read_bytes()
    except OSError as e:
        raise IoError("read safetensors", e) from e
    if len(data) < 8:
        raise RuntimeBackendError("load weights", f"{path}: truncated header")
    (n,) = struct.unpack("<Q", data[:8])
    if 8 + n > len(data):
        raise RuntimeBackendError("load weights", f"{path}: header runs past the file")
    header = json.loads(data[8 : 8 + n])
    body = memoryview(data)[8 + n :]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        shape = tuple(int(d) for d in info["shape"])
        begin, end = (int(o) for o in info["data_offsets"])
        count = int(np.prod(shape, dtype=np.int64))
        dt = info["dtype"]
        if dt == "BF16":
            itemsize = 2
        elif dt in _DTYPES:
            itemsize = _DTYPES[dt].itemsize
        else:
            raise RuntimeBackendError("load weights", f"{name}: unsupported dtype {dt}")
        if not 0 <= begin <= end <= len(body) or end - begin != count * itemsize:
            raise RuntimeBackendError(
                "load weights", f"{name}: data_offsets {begin}..{end} do not hold "
                f"{count} {dt} values"
            )
        if dt == "BF16":
            raw = np.frombuffer(body, np.dtype("<u2"), count, begin)
            arr = (raw.astype(np.uint32) << 16).view(np.float32)
        else:
            arr = np.frombuffer(body, _DTYPES[dt], count, begin).copy()
        out[name] = arr.reshape(shape)
    return out


def save_safetensors(path: str | Path, tensors: dict[str, np.ndarray]) -> None:
    """Write a flat {name: array} dict as a safetensors file."""
    header = {}
    buffers = []
    offset = 0
    for name in sorted(tensors):
        arr = np.ascontiguousarray(tensors[name])
        dt = arr.dtype.newbyteorder("<") if arr.dtype.byteorder == ">" else arr.dtype
        if dt not in _NAMES:
            raise ValueError(f"{name}: dtype {arr.dtype} has no safetensors name")
        buf = arr.astype(dt, copy=False).tobytes()
        header[name] = {
            "dtype": _NAMES[dt],
            "shape": list(arr.shape),
            "data_offsets": [offset, offset + len(buf)],
        }
        buffers.append(buf)
        offset += len(buf)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)  # keep the buffers 8-byte aligned
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for buf in buffers:
            f.write(buf)
