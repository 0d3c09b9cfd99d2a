"""Audio normalization (K7): a batch's rows go to the device raw, packed back
to back, and come out normalized and padded there (`csrc/normalize.cu`).

- `pack_rows(rows, n_pad, fill, pin)` packs the rows' samples as f32 into
  one host tensor (pinned with `pin`, for a copy that does not synchronise),
  each row at a multiple of 4 samples so that the kernel reads it as 16-byte
  vectors, and returns a `PackedRows`. The `fill` rows that pad a batch to
  its size are not copied: their offset and length are the last row's.
- `normalize_rows(samples, offsets, lens, n_pad)` is `[rows, n_pad]` f32:
  row r's lens[r] samples from samples[offsets[r]:], normalized as
  `pipeline.runtime.normalize_audio` does (f64 mean, the f64 mean of the
  centred squares, σ floor 1e-7, an f64 division rounded to f32 once), then
  zeros. A CUDA tensor launches K7 (or raises: nothing falls back); a CPU
  tensor runs `reference`, the plain version in f64 torch.
- `upload(packed, device)` copies a `PackedRows` to the device on the
  current stream (no sync from pinned memory) and runs `normalize_rows`
  there: the batch path's one call.

Only the summation order differs from numpy's, so K7 and `reference` each
agree with `normalize_audio` to 1 f32 ulp (see the kernel's notes).
`launches` counts K7's launches. The kernel is built with the port's other
kernels by `ops.cuda_build`.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from .cuda_build import library

ALIGN = 4  # samples: a row starts 16 bytes into f32 storage
STD_FLOOR = 1e-7  # normalize_audio's
launches = {"normalize": 0}


@dataclass(frozen=True)
class PackedRows:
    """A batch's raw rows: `samples` f32 [total], `offsets` int64 [rows] and
    `lens` int32 [rows] (row r is samples[offsets[r]:][:lens[r]]), to be
    laid out as [rows, n_pad]; `real` counts the samples copied (the fill
    rows' not among them)."""

    samples: torch.Tensor
    offsets: torch.Tensor
    lens: torch.Tensor
    n_pad: int
    real: int

    @property
    def shape(self) -> tuple[int, int]:
        """(rows, n_pad): the shape of the padded audio it becomes."""
        return self.offsets.shape[0], self.n_pad


def pack_rows(rows: Sequence[np.ndarray], n_pad: int, fill: int = 0,
              pin: bool = False) -> PackedRows:
    """`rows` (1-D arrays of at most n_pad samples, any real dtype, cast to
    f32 as `normalize_audio` casts) back to back in one host tensor, each at a
    multiple of `ALIGN` samples; `fill` more rows repeat the last one's offset
    and length. With `pin`, every tensor is in pinned memory."""
    if not rows:
        raise ValueError("pack_rows takes at least one row")
    lens = np.array([len(r) for r in rows], np.int64)
    if int(lens.max()) > n_pad:
        raise ValueError(f"a row of {int(lens.max())} samples past n_pad={n_pad}")
    steps = -(-lens // ALIGN) * ALIGN
    starts = np.concatenate([[0], np.cumsum(steps)[:-1]])
    samples = torch.empty(max(int(steps.sum()), 1), dtype=torch.float32, pin_memory=pin)
    offsets = torch.empty(len(rows) + fill, dtype=torch.int64, pin_memory=pin)
    row_lens = torch.empty(len(rows) + fill, dtype=torch.int32, pin_memory=pin)
    flat = samples.numpy()
    for at, n, r in zip(starts, lens, rows):
        flat[at:at + n] = r
    offsets.numpy()[:len(rows)] = starts
    offsets.numpy()[len(rows):] = starts[-1]
    row_lens.numpy()[:len(rows)] = lens
    row_lens.numpy()[len(rows):] = lens[-1]
    return PackedRows(samples, offsets, row_lens, int(n_pad), int(lens.sum()))


@functools.cache
def _library() -> ctypes.CDLL:
    lib = library()
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.normalize_rows_launch.argtypes = [p, p, p, p, i, i, p]
    lib.normalize_rows_launch.restype = i
    lib.normalize_cluster_blocks.argtypes = [i]
    lib.normalize_cluster_blocks.restype = i
    return lib


def cluster_blocks(n_pad: int) -> int:
    """Blocks of the cluster K7 gives each row at this padded length."""
    return _library().normalize_cluster_blocks(n_pad)


def reference(samples: torch.Tensor, offsets: torch.Tensor, lens: torch.Tensor,
              n_pad: int) -> torch.Tensor:
    """The plain version of `normalize_rows`: `normalize_audio`'s passes in
    f64 torch over the [rows, n_pad] gather, on the card as on the CPU."""
    pos = torch.arange(n_pad, device=samples.device)
    valid = pos[None, :] < lens.to(torch.int64)[:, None]
    at = torch.where(valid, offsets[:, None] + pos[None, :], 0)
    x = torch.where(valid, samples[at].double(), 0.0)
    count = lens.clamp(min=1).double()[:, None]
    mean = x.sum(dim=1, keepdim=True) / count
    d = torch.where(valid, x - mean, 0.0)
    var = (d * d).sum(dim=1, keepdim=True) / count
    std = var.sqrt().clamp(min=STD_FLOOR)
    return (d / std).float()


def check_args(samples: torch.Tensor, offsets: torch.Tensor, lens: torch.Tensor,
               n_pad: int) -> None:
    """Raise ValueError on what K7 does not take: samples not a contiguous
    f32 vector, offsets not int64 [rows] or lens not int32 [rows] on its
    device, n_pad past 2^31 / 4 − 1 samples."""
    if samples.dtype != torch.float32 or samples.dim() != 1 or not samples.is_contiguous():
        raise ValueError("samples must be a contiguous f32 vector")
    rows = offsets.shape[0] if offsets.dim() == 1 else -1
    for name, t, dtype in (("offsets", offsets, torch.int64), ("lens", lens, torch.int32)):
        if t.dtype != dtype or tuple(t.shape) != (rows,) or t.device != samples.device:
            raise ValueError(f"{name} must be a [rows] {dtype} tensor on {samples.device}")
    if not 0 < n_pad < 2**31 // ALIGN:
        raise ValueError(f"n_pad must be in [1, {2**31 // ALIGN}), got {n_pad}")


def _launch(samples, offsets, lens, n_pad) -> torch.Tensor:
    """One launch on the current stream, after `check_args`."""
    offsets, lens = offsets.contiguous(), lens.contiguous()
    out = torch.empty((offsets.shape[0], n_pad), dtype=torch.float32, device=samples.device)
    lib = _library()
    with torch.cuda.device(samples.device):
        stream = torch.cuda.current_stream(samples.device).cuda_stream
        err = lib.normalize_rows_launch(samples.data_ptr(), offsets.data_ptr(), lens.data_ptr(),
                                        out.data_ptr(), out.shape[0], n_pad, stream)
    if err != 0:
        raise RuntimeError(f"normalize launch failed: cudaError {err}")
    launches["normalize"] += 1
    return out


def normalize_rows(samples: torch.Tensor, offsets: torch.Tensor, lens: torch.Tensor,
                   n_pad: int) -> torch.Tensor:
    """[rows, n_pad] f32, each row normalized as `normalize_audio` and padded
    with zeros: K7 for CUDA tensors, `reference` for CPU ones (see the
    module's docstring)."""
    check_args(samples, offsets, lens, n_pad)
    if samples.device.type == "cpu":
        return reference(samples, offsets, lens, n_pad)
    if samples.device.type != "cuda":
        raise ValueError(f"no K7 kernel for device {samples.device}")
    return _launch(samples, offsets, lens, n_pad)


def upload(packed: PackedRows, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """`packed` copied to `device` on the current stream, without a sync
    when its tensors are pinned, and normalized there: (audio [rows, n_pad]
    f32, lens [rows] int32 on the device)."""
    samples, offsets, lens = (t.to(device, non_blocking=True)
                              for t in (packed.samples, packed.offsets, packed.lens))
    return normalize_rows(samples, offsets, lens, packed.n_pad), lens
