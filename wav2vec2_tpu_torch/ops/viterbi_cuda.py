"""The banded CTC Viterbi kernels K1–K4, in CUDA C++ for Hopper.

- K1 (`csrc/viterbi.cu`), the port of `wav2vec2_tpu/ops/viterbi_pallas.py::
  _viterbi_kernel_resident`, in one of two modes chosen by shape
  (`k1_mode`): "resident", where the utterance's log-prob rows (a ring of
  16-frame chunks, copied by the Tensor Memory Accelerator) and its 2-bit
  backpointers fit in shared memory, with each thread's strip of states in
  registers and the backtrace from shared memory; "device" otherwise, with
  the DP rows in shared memory, one-byte backpointers in device memory and
  a one-thread backtrace.
- K2, K3, K4 (`csrc/viterbi_blocked.cu`), the ports of
  `_make_blocked_kernel`'s three instances: 8-frame blocks streamed
  through a double-buffered shared-memory window, each thread holding a
  strip of states in registers. All three keep 2-bit backpointers
  ([T_pad, W/4] bytes, W = S_pad rounded up to 4): K2 in shared memory
  over pre-gathered emissions; K3 in device memory over pre-gathered
  emissions; K4 in device memory over the raw log-probs. K3 and K4
  backtrace by 8-frame blocks.

`viterbi_batch` and `viterbi_single` pick a tier with `select_tier` (or take
`tier=`). For tensors on the CPU they run the plain PyTorch version of that
tier (`ops.viterbi_ref`); for CUDA tensors they launch the kernel or raise —
no fallback to another tier, another K1 mode or a plain version.
`launches` counts the launches per kernel, and `k1_launches` K1's
launches per mode. The kernels write through raw pointers, so every
wrapper refuses a DTensor: under a device mesh they run on each rank's
rows inside `local_map` (`parallel.mesh.batch_local`).

Both sources are built with the port's other kernels into one library by
`ops.cuda_build` (one `nvcc` call at first use) and loaded with `ctypes`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..parallel.mesh import is_dtensor
from . import viterbi_ref
from .cuda_build import MAX_SMEM_BYTES, library

TIERS = ("k1", "k2", "k3", "k4")
# Longest padded T that stays on K1. K4 measured faster than K1 from
# T = 599 up (chip_smoke.py's tier-crossover phase, NVIDIA H100 80GB HBM3 at
# 700 W; times in PERF.md), so this is the floor of 512 frames that keeps
# the 10 s serving shape (T = 499) on K1.
K1_MAX_FRAMES = 512
# Most states a K2–K4 block takes: 512 threads of 32-state strips
MAX_STRIP_STATES = 512 * 32
launches = {tier: 0 for tier in TIERS}
K1_MODES = ("resident", "device")
k1_launches = {mode: 0 for mode in K1_MODES}
# K1's resident mode (`resident_layout` in csrc/viterbi.cu): a ring of at
# most 4 chunks of 16 frames, strips of at most 8 states on 512 threads
K1_CHUNK_FRAMES = 16
K1_MAX_SLOTS = 4
K1_MAX_RESIDENT_STATES = 512 * 8
K1_STRIPS = (1, 2, 4, 8)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = library()
    for name in ("k1_device", "k2", "k3", "k4"):
        launch = getattr(lib, f"viterbi_{name}_launch")
        launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        launch.restype = ctypes.c_int
    lib.viterbi_k1_resident_launch.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                                               + [ctypes.c_void_p])
    lib.viterbi_k1_resident_launch.restype = ctypes.c_int
    for tier in TIERS:
        size = getattr(lib, f"viterbi_{tier}_smem_bytes")
        size.argtypes = [ctypes.c_int] * 3
        size.restype = ctypes.c_size_t
    lib.viterbi_k1_resident.argtypes = [ctypes.c_int] * 3
    lib.viterbi_k1_resident.restype = ctypes.c_int
    for name in ("blocked", "k1"):
        strip = getattr(lib, f"viterbi_{name}_strip")
        strip.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        strip.restype = ctypes.c_int
    return lib


def library_strip(s_pad: int, tier: str = "k4") -> tuple[int, int]:
    """(R, threads) of a launch of `tier` at `s_pad`, as the compiled
    launcher chooses them: R states a thread, R = 0 if no strip serves.
    K2–K4 share one rule; K1's is that of its resident mode."""
    threads = ctypes.c_int(0)
    name = "k1" if tier == "k1" else "blocked"
    r = getattr(_library(), f"viterbi_{name}_strip")(s_pad, ctypes.byref(threads))
    return r, threads.value


def library_smem_bytes(tier: str, t_pad: int, s_pad: int, v: int) -> int:
    """`smem_bytes` as the compiled kernels compute it."""
    return getattr(_library(), f"viterbi_{tier}_smem_bytes")(t_pad, s_pad, v)


def library_k1_mode(t_pad: int, s_pad: int, v: int) -> str:
    """`k1_mode` as the compiled kernel computes it."""
    return "resident" if _library().viterbi_k1_resident(t_pad, s_pad, v) else "device"


def _round_up4(x: int) -> int:
    return -(-x // 4) * 4


def _round_up16(x: int) -> int:
    return -(-x // 16) * 16


def _k1_resident_layout(t_pad: int, s_pad: int, v: int) -> tuple[int, int]:
    """(ring slots, bytes) of K1's resident mode, `resident_layout` in
    csrc/viterbi.cu: the ring's 4 mbarriers, the ring, a 512 B halo, 16 B
    of final scores, the [T_pad] int32 path row and the 2-bit planes, T_pad
    rows of W/4 bytes at a stride rounded up to 8. Slots = 0 when fewer
    than two chunks (one where T_pad is one chunk) fit beside the rest, or
    W exceeds K1_MAX_RESIDENT_STATES."""
    w = _round_up4(s_pad)
    stride = -(-(w // 4) // 8) * 8
    fixed = 8 * K1_MAX_SLOTS + 512 + 16 + _round_up16(4 * t_pad) + _round_up16(t_pad * stride)
    chunk = _round_up16(K1_CHUNK_FRAMES * max(v, 1) * 4)
    n_chunks = -(-t_pad // K1_CHUNK_FRAMES)
    slots = 0
    if t_pad > 0 and w <= K1_MAX_RESIDENT_STATES and fixed < MAX_SMEM_BYTES:
        slots = min(n_chunks, K1_MAX_SLOTS, (MAX_SMEM_BYTES - fixed) // chunk)
        if slots < min(n_chunks, 2):
            slots = 0
    return slots, fixed + slots * chunk


def k1_mode(t_pad: int, s_pad: int, v: int) -> str:
    """K1's mode at this shape: "resident" where the log-prob ring and the
    2-bit backpointers fit in shared memory beside the path row (and S_pad
    is within K1_MAX_RESIDENT_STATES), else "device". A shape rule: a
    launch of either mode that fails raises."""
    return "resident" if _k1_resident_layout(t_pad, s_pad, v)[0] else "device"


def smem_bytes(tier: str, t_pad: int, s_pad: int, v: int) -> int:
    """Shared memory one block of `tier` needs: the sums of the
    `viterbi_*_smem_bytes` functions of the CUDA sources (`library_smem_bytes`
    reads those; chip_smoke.py holds the two equal). K1 in its resident
    mode: `_k1_resident_layout`; in its device mode two f32 DP rows and the
    int32 tokens. K2–K4 keep their DP rows in registers: the [2, 8, ·] f32
    window, a 512 B halo, 16 B for the final scores, and the packed bp (K2)
    or an [8, 16] B backtrace window (K3, K4)."""
    w = _round_up4(s_pad)
    if tier == "k1":
        slots, resident = _k1_resident_layout(t_pad, s_pad, v)
        return resident if slots else 12 * s_pad
    window = 64 * (_round_up4(v) if tier == "k4" else w)
    return window + 512 + 16 + (t_pad * (w // 4) if tier == "k2" else 128)


def bp_scratch_shape(tier: str, b: int, t_pad: int, s_pad: int, v: int) -> tuple[int, ...]:
    """The uint8 backpointer scratch the wrapper allocates for `tier`: K1's
    device mode one byte a cell, K3/K4 2 bits a cell ([B, T_pad, W/4]), K2
    and K1's resident mode none (their bp stay in shared memory)."""
    if tier == "k1":
        return (b, t_pad, s_pad) if k1_mode(t_pad, s_pad, v) == "device" else (0,)
    if tier == "k2":
        return (0,)
    return (b, t_pad, _round_up4(s_pad) // 4)


def use_raw_gather(v: int, s_pad: int) -> bool:
    """K4 over K3: the traffic half of the JAX `_use_onehot_gather`. K4
    reads [T, V_pad] raw log-probs; K3 needs a gathered [T, S_pad] emission
    array written and read again. (The TPU's one-hot VMEM budget has no
    counterpart here: K4 gathers by indexed loads.)"""
    return _round_up4(v) < 2 * s_pad


def select_tier(t_pad: int, s_pad: int, v: int) -> str:
    """The Hopper tier rule, the counterpart of the dispatch in the JAX
    `viterbi_pallas_single`/`viterbi_pallas_batch`, with shared-memory
    budgets in place of the TPU's VMEM: K1 up to K1_MAX_FRAMES; else K2
    when its on-chip bp fits; else K4 or K3 by `use_raw_gather`, the other
    one if the preferred window does not fit, and K1 (no window) if neither
    does. Raises ValueError when no tier fits: above S_pad = 16 384
    (MAX_STRIP_STATES, K2–K4's strips) only K1 can serve, and its DP rows
    and tokens exceed shared memory above S_pad ≈ 19 000."""
    fits = {t: _fits(t, t_pad, s_pad, v) for t in TIERS}
    if t_pad <= K1_MAX_FRAMES and fits["k1"]:
        return "k1"
    if fits["k2"]:
        return "k2"
    order = ("k4", "k3") if use_raw_gather(v, s_pad) else ("k3", "k4")
    for tier in (*order, "k1"):
        if fits[tier]:
            return tier
    raise ValueError(
        f"S_pad={s_pad} (V={v}) is more than the {MAX_STRIP_STATES} states of "
        f"K2–K4's strips, and K1 needs {smem_bytes('k1', t_pad, s_pad, v)} B of "
        f"shared memory per block for its DP rows and tokens, more than "
        f"{MAX_SMEM_BYTES}"
    )


def _fits(tier: str, t_pad: int, s_pad: int, v: int) -> bool:
    if tier != "k1" and _round_up4(s_pad) > MAX_STRIP_STATES:
        return False
    return smem_bytes(tier, t_pad, s_pad, v) <= MAX_SMEM_BYTES


def check_fits(tier: str, t_pad: int, s_pad: int, v: int) -> None:
    """Raise ValueError if `tier` cannot take this shape: more states than
    K2–K4's strips hold, or more shared memory than a block can have. Such
    a launch would be refused."""
    if tier != "k1" and _round_up4(s_pad) > MAX_STRIP_STATES:
        raise ValueError(f"{tier} takes at most {MAX_STRIP_STATES} states (S_pad rounded "
                         f"up to 4), got S_pad={s_pad}")
    need = smem_bytes(tier, t_pad, s_pad, v)
    if need > MAX_SMEM_BYTES:
        raise ValueError(
            f"{tier} at T_pad={t_pad}, S_pad={s_pad}, V={v} needs {need} B of "
            f"shared memory per block, more than {MAX_SMEM_BYTES}"
        )


def refuse_dtensor(*tensors) -> None:
    """Raise TypeError on a DTensor: the kernels would read and write its
    local shard through raw pointers as if it were the whole tensor."""
    if any(is_dtensor(x) for x in tensors):
        raise TypeError("the Viterbi kernels take plain tensors, not DTensors: under a "
                        "device mesh call them on each rank's rows "
                        "(parallel.mesh.batch_local)")


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


def _launch(tier: str, src, tokens, t_lens, s_lens, v: int, mode: str | None = None,
            strip: int = 0) -> torch.Tensor:
    """One launch of `tier` on the current stream: src is the log-probs
    (K1, K4) or the gathered emissions (K2, K3), checked by the caller.
    K1 launches `mode` (None: the mode `k1_mode` gives), with R = `strip`
    in the resident mode (0: the launcher's rule)."""
    b, t_pad = src.shape[:2]
    s_pad = tokens.shape[1]
    check_fits(tier, t_pad, s_pad, v)
    lib = _library()
    dev = src.device
    if tier == "k1":
        mode = mode or k1_mode(t_pad, s_pad, v)
    scratch = ((b, t_pad, s_pad) if mode == "device"
               else bp_scratch_shape(tier, b, t_pad, s_pad, v))
    bp = torch.empty(scratch, dtype=torch.uint8, device=dev)
    paths = torch.empty((b, t_pad), dtype=torch.int32, device=dev)
    ptrs = (src.data_ptr(), tokens.data_ptr(), t_lens.data_ptr(), s_lens.data_ptr(),
            bp.data_ptr(), paths.data_ptr(), b, t_pad, v, s_pad)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if mode == "resident":
            err = lib.viterbi_k1_resident_launch(*ptrs, strip, stream)
        else:
            err = getattr(lib, f"viterbi_{'k1_device' if mode else tier}_launch")(*ptrs, stream)
    if err != 0:
        name = f"k1 ({mode} mode)" if mode else tier
        raise RuntimeError(f"viterbi_{name} launch failed: cudaError {err}")
    launches[tier] += 1
    if mode:
        k1_launches[mode] += 1
    return paths


def viterbi_emissions_batch(
    emit: torch.Tensor,
    tokens: torch.Tensor,
    t_lens: torch.Tensor,
    s_lens: torch.Tensor,
    tier: str = "k3",
) -> torch.Tensor:
    """K2 or K3 alone, over pre-gathered emissions [B, T_pad, S_pad] f32
    (`viterbi_ref.gather_emissions`); CPU tensors take their plain version
    `viterbi_ref.viterbi_emissions_batch`."""
    if tier not in ("k2", "k3"):
        raise ValueError(f"{tier!r} does not read pre-gathered emissions")
    refuse_dtensor(emit, tokens, t_lens, s_lens)
    if emit.device.type == "cpu":
        return viterbi_ref.viterbi_emissions_batch(emit, tokens, t_lens, s_lens)
    if emit.device.type != "cuda":
        raise ValueError(f"no Viterbi kernel for device {emit.device}")
    _check_inputs(emit, tokens, t_lens, s_lens)
    if emit.shape[2] != tokens.shape[1]:
        raise ValueError(f"emissions {tuple(emit.shape)} do not match tokens "
                         f"{tuple(tokens.shape)}")
    return _launch(tier, emit, tokens, t_lens, s_lens, 0)


def viterbi_batch(
    log_probs: torch.Tensor,
    tokens: torch.Tensor,
    t_lens: torch.Tensor,
    s_lens: torch.Tensor,
    tier: str | None = None,
) -> torch.Tensor:
    """Banded CTC Viterbi over a padded batch: log_probs [B, T_pad, V] f32,
    tokens [B, S_pad] i32, t_lens/s_lens [B] i32 → paths [B, T_pad] i32
    (frames >= t_len hold the final state). `tier` is one of TIERS, or None
    for `select_tier`. On CUDA tensors: one launch on the current stream
    (K2 and K3 after a `torch.gather` of the emissions), no
    synchronisation."""
    if tier is not None and tier not in TIERS:
        raise ValueError(f"unknown Viterbi tier {tier!r}; want one of {TIERS}")
    refuse_dtensor(log_probs, tokens, t_lens, s_lens)
    if log_probs.device.type == "cuda":
        _check_inputs(log_probs, tokens, t_lens, s_lens)
        tier = tier or select_tier(log_probs.shape[1], tokens.shape[1], log_probs.shape[2])
    if tier in ("k2", "k3"):
        emit = viterbi_ref.gather_emissions(log_probs, tokens)
        return viterbi_emissions_batch(emit, tokens, t_lens, s_lens, tier)
    if log_probs.device.type == "cpu":
        return viterbi_ref.viterbi_batch(log_probs, tokens, t_lens, s_lens)
    if log_probs.device.type != "cuda":
        raise ValueError(f"no Viterbi kernel for device {log_probs.device}")
    return _launch(tier, log_probs, tokens, t_lens, s_lens, log_probs.shape[2])


def k1_batch(
    log_probs: torch.Tensor,
    tokens: torch.Tensor,
    t_lens: torch.Tensor,
    s_lens: torch.Tensor,
    mode: str,
    strip: int = 0,
) -> torch.Tensor:
    """K1 in the given mode (one of K1_MODES) and, in the resident mode,
    with R = `strip` states a thread (one of K1_STRIPS; 0: the launcher's
    rule), in place of the shape's rule: for timing one mode or strip width
    against another on the same inputs. CUDA tensors only; counted like any
    K1 launch. Raises ValueError where the resident mode does not fit the
    shape or R does not fit in 512 threads."""
    if mode not in K1_MODES:
        raise ValueError(f"unknown K1 mode {mode!r}; want one of {K1_MODES}")
    refuse_dtensor(log_probs, tokens, t_lens, s_lens)
    if strip and (mode != "resident" or strip not in K1_STRIPS):
        raise ValueError(f"strip {strip}: want one of {K1_STRIPS}, in the resident mode")
    if log_probs.device.type != "cuda":
        raise ValueError(f"K1's kernels run on a CUDA device, not {log_probs.device}")
    _check_inputs(log_probs, tokens, t_lens, s_lens)
    t_pad, s_pad, v = log_probs.shape[1], tokens.shape[1], log_probs.shape[2]
    if mode == "resident" and k1_mode(t_pad, s_pad, v) != "resident":
        raise ValueError(f"T_pad={t_pad}, S_pad={s_pad}, V={v} does not fit K1's resident "
                         "mode")
    if strip and -(-_round_up4(s_pad) // strip) > 512:
        raise ValueError(f"{strip}-state strips of S_pad={s_pad} need more than 512 threads")
    return _launch("k1", log_probs, tokens, t_lens, s_lens, v, mode, strip)


def viterbi_single(
    log_probs: torch.Tensor, tokens: torch.Tensor, t_len: int, s_len: int,
    tier: str | None = None,
) -> torch.Tensor:
    """One utterance through the batch wrapper: log_probs [T_pad, V],
    tokens [S_pad] → path [T_pad]."""
    lens = torch.tensor([[t_len], [s_len]], dtype=torch.int32,
                        device=log_probs.device)
    return viterbi_batch(log_probs[None], tokens[None], lens[0], lens[1], tier)[0]
