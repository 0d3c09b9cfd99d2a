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
  backtrace by 8-frame blocks. K2–K4 take 16 384 states on one block;
  K4 runs past that on a thread-block cluster of up to 8 blocks (131 072
  states), each block a slice of the states (`cluster_shape`), the DP's
  boundary scores handed from block to block through distributed shared
  memory.

`viterbi_batch` and `viterbi_single` pick a tier with `select_tier` (or take
`tier=`). For tensors on the CPU they run the plain PyTorch version of that
tier (`ops.viterbi_ref`); for CUDA tensors they launch the kernel or raise —
no fallback to another tier, another K1 mode or a plain version.
`launches` counts the launches per kernel, `k1_launches` K1's launches
per mode and `k4_clusters` K4's per cluster size. The kernels write
through raw pointers, so every wrapper refuses a DTensor: under a device
mesh they run on each rank's rows inside `local_map`
(`parallel.mesh.batch_local`).

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
# K4 past one block: a thread-block cluster of at most 8 blocks (the
# portable cluster size), each a slice of the states
MAX_CLUSTER = 8
MAX_CLUSTER_STATES = MAX_CLUSTER * MAX_STRIP_STATES
# on a cluster of n > 1, each block also holds a 16-frame ring of boundary
# scores ([16, 2] f32), an mbarrier a slot and 2 credit mbarriers
CLUSTER_RING_FRAMES = 16
CLUSTER_SMEM_BYTES = CLUSTER_RING_FRAMES * 8 + (CLUSTER_RING_FRAMES + 2) * 8
STRIPS = (4, 8, 16, 32)
launches = {tier: 0 for tier in TIERS}
k4_clusters: dict[int, int] = {}  # K4 launches by cluster size
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
    for name in ("k1_device", "k2", "k3"):
        launch = getattr(lib, f"viterbi_{name}_launch")
        launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        launch.restype = ctypes.c_int
    lib.viterbi_k4_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.viterbi_k4_launch.restype = ctypes.c_int
    lib.viterbi_k4_cluster.argtypes = ([ctypes.c_int] * 3
                                       + [ctypes.POINTER(ctypes.c_int)] * 4)
    lib.viterbi_k4_cluster.restype = ctypes.c_int
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


def library_cluster(s_pad: int, cluster: int = 0) -> tuple[int, int, int, list]:
    """(n, R, threads, slices) of a K4 launch at `s_pad` asked for `cluster`
    blocks (0: the least), as the compiled launcher chooses them: n = 0 if
    no launch serves; slices, each block's states [first, end)."""
    lib = _library()
    r, threads, first, end = (ctypes.c_int(0) for _ in range(4))
    n = lib.viterbi_k4_cluster(s_pad, cluster, 0, ctypes.byref(r), ctypes.byref(threads),
                               ctypes.byref(first), ctypes.byref(end))
    slices = []
    for rank in range(n):
        lib.viterbi_k4_cluster(s_pad, cluster, rank, ctypes.byref(r), ctypes.byref(threads),
                               ctypes.byref(first), ctypes.byref(end))
        slices.append((first.value, end.value))
    return n, r.value, threads.value, slices


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


def cluster_shape(s_pad: int, cluster: int = 0) -> tuple[int, int, int]:
    """(n, R, threads) of a K4 launch at `s_pad` on a cluster of `cluster`
    blocks (0: the least that holds W = S_pad rounded up to 4, ceil(W /
    16 384); 1 is the one-block launch of K2–K4), `cluster_shape` in
    csrc/viterbi_blocked.cu (`library_cluster` reads it; chip_smoke.py holds
    the two equal): R the least in STRIPS for which the N = ceil(W / R)
    strips over n blocks give none more than 512, threads = round32 of the
    most strips a block takes. (0, 0, 0) where no launch serves: n above
    MAX_CLUSTER, or fewer strips than blocks."""
    w = _round_up4(s_pad)
    n = cluster or max(-(-w // MAX_STRIP_STATES), 1)
    if not 0 < n <= MAX_CLUSTER:
        return 0, 0, 0
    for r in STRIPS:
        strips = -(-w // r)
        most = -(-strips // n)
        if most <= 512:
            if strips < n:
                return 0, 0, 0
            return n, r, max(-(-most // 32) * 32, 32)
    return 0, 0, 0


def cluster_size(s_pad: int) -> int:
    """Blocks of the cluster K4 runs at `s_pad`: 1 up to MAX_STRIP_STATES,
    ceil(W / 16 384) beyond, 0 past MAX_CLUSTER_STATES."""
    return cluster_shape(s_pad)[0]


def cluster_slices(s_pad: int, cluster: int = 0) -> list[tuple[int, int]]:
    """Each block's states [first, end) on K4's cluster at `s_pad` (`slice`
    in csrc/viterbi_blocked.cu): block k takes strips [k N / n, (k + 1) N /
    n) of the N R-state strips, so every slice but the last is whole
    strips; the last ends at W."""
    n, r, _ = cluster_shape(s_pad, cluster)
    w = _round_up4(s_pad)
    strips = -(-w // r) if n else 0
    return [(k * strips // n * r, min((k + 1) * strips // n * r, w)) for k in range(n)]


def smem_bytes(tier: str, t_pad: int, s_pad: int, v: int, cluster: int = 0) -> int:
    """Shared memory one block of `tier` needs: the sums of the
    `viterbi_*_smem_bytes` functions of the CUDA sources (`library_smem_bytes`
    reads those; chip_smoke.py holds the two equal). K1 in its resident
    mode: `_k1_resident_layout`; in its device mode two f32 DP rows and the
    int32 tokens. K2–K4 keep their DP rows in registers: the [2, 8, ·] f32
    window, a 512 B halo, 16 B for the final scores, and the packed bp (K2)
    or an [8, 16] B backtrace window (K3, K4); K4 on a cluster of more than
    one block (`cluster`, 0: the least) adds CLUSTER_SMEM_BYTES."""
    w = _round_up4(s_pad)
    if tier == "k1":
        slots, resident = _k1_resident_layout(t_pad, s_pad, v)
        return resident if slots else 12 * s_pad
    window = 64 * (_round_up4(v) if tier == "k4" else w)
    ring = CLUSTER_SMEM_BYTES if tier == "k4" and cluster_shape(s_pad, cluster)[0] > 1 else 0
    return window + 512 + 16 + (t_pad * (w // 4) if tier == "k2" else 128) + ring


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
    does and S_pad is within one block's strips. Past MAX_STRIP_STATES
    (16 384) K2 and K3 do not fit and K4 runs on a cluster
    (`cluster_shape`): K1 serves there only up to K1_MAX_FRAMES. Raises
    ValueError when no tier fits: past MAX_CLUSTER_STATES (131 072), or
    where K4's [2, 8, V] window does not fit and neither does K1."""
    fits = {t: _fits(t, t_pad, s_pad, v) for t in TIERS}
    if t_pad <= K1_MAX_FRAMES and fits["k1"]:
        return "k1"
    if fits["k2"]:
        return "k2"
    order = ("k4", "k3") if use_raw_gather(v, s_pad) else ("k3", "k4")
    for tier in order:
        if fits[tier]:
            return tier
    if fits["k1"] and _round_up4(s_pad) <= MAX_STRIP_STATES:
        return "k1"
    if _round_up4(s_pad) > MAX_CLUSTER_STATES:
        raise ValueError(
            f"S_pad={s_pad} is more than the {MAX_CLUSTER_STATES} states of K4 on a "
            f"thread-block cluster of {MAX_CLUSTER} blocks of {MAX_STRIP_STATES}, the "
            f"widest tier"
        )
    raise ValueError(
        f"no Viterbi tier takes T_pad={t_pad}, S_pad={s_pad}, V={v}: K4 needs "
        f"{smem_bytes('k4', t_pad, s_pad, v)} B of shared memory per block for its "
        f"[2, 8, V] window, K1 {smem_bytes('k1', t_pad, s_pad, v)} B for its DP rows "
        f"and tokens, more than {MAX_SMEM_BYTES}"
    )


def _max_states(tier: str) -> int | None:
    return {"k1": None, "k4": MAX_CLUSTER_STATES}.get(tier, MAX_STRIP_STATES)


def _fits(tier: str, t_pad: int, s_pad: int, v: int) -> bool:
    limit = _max_states(tier)
    if limit is not None and _round_up4(s_pad) > limit:
        return False
    return smem_bytes(tier, t_pad, s_pad, v) <= MAX_SMEM_BYTES


def check_fits(tier: str, t_pad: int, s_pad: int, v: int, cluster: int = 0) -> None:
    """Raise ValueError if `tier` cannot take this shape: more states than
    K2–K3's one block or K4's largest cluster holds, a K4 `cluster` (0: the
    least) that cannot hold S_pad or gives a block no strip, or more shared
    memory than a block can have. Such a launch would be refused."""
    limit = _max_states(tier)
    if limit is not None and _round_up4(s_pad) > limit:
        where = (f"a cluster of {MAX_CLUSTER} blocks" if tier == "k4" else "one block")
        raise ValueError(f"{tier} takes at most {limit} states ({where}; S_pad rounded "
                         f"up to 4), got S_pad={s_pad}")
    if cluster and tier != "k4":
        raise ValueError(f"only k4 runs on a cluster, not {tier}")
    if tier == "k4" and not cluster_shape(s_pad, cluster)[0]:
        raise ValueError(f"k4 on a cluster of {cluster} blocks cannot take S_pad={s_pad}: "
                         f"want {cluster_size(s_pad)}–{MAX_CLUSTER} blocks, each at least "
                         f"one strip")
    need = smem_bytes(tier, t_pad, s_pad, v, cluster)
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
            strip: int = 0, cluster: int = 0) -> torch.Tensor:
    """One launch of `tier` on the current stream: src is the log-probs
    (K1, K4) or the gathered emissions (K2, K3), checked by the caller.
    K1 launches `mode` (None: the mode `k1_mode` gives), with R = `strip`
    in the resident mode (0: the launcher's rule); K4 on `cluster` blocks
    an utterance (0: `cluster_size`)."""
    b, t_pad = src.shape[:2]
    s_pad = tokens.shape[1]
    check_fits(tier, t_pad, s_pad, v, cluster)
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
        elif tier == "k4":
            err = lib.viterbi_k4_launch(*ptrs, cluster, stream)
        else:
            err = getattr(lib, f"viterbi_{'k1_device' if mode else tier}_launch")(*ptrs, stream)
    if err != 0:
        name = f"k1 ({mode} mode)" if mode else tier
        raise RuntimeError(f"viterbi_{name} launch failed: cudaError {err}")
    launches[tier] += 1
    if mode:
        k1_launches[mode] += 1
    if tier == "k4":
        n = cluster_shape(s_pad, cluster)[0]
        k4_clusters[n] = k4_clusters.get(n, 0) + 1
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
    cluster: int = 0,
) -> torch.Tensor:
    """Banded CTC Viterbi over a padded batch: log_probs [B, T_pad, V] f32,
    tokens [B, S_pad] i32, t_lens/s_lens [B] i32 → paths [B, T_pad] i32
    (frames >= t_len hold the final state). `tier` is one of TIERS, or None
    for `select_tier`. `cluster` forces K4's cluster size (blocks an
    utterance, from `cluster_size` up to MAX_CLUSTER; 0: `cluster_size`),
    for holding one partition of the states against another: it changes no
    path. On CUDA tensors: one launch on the current stream (K2 and K3
    after a `torch.gather` of the emissions), no synchronisation."""
    if tier is not None and tier not in TIERS:
        raise ValueError(f"unknown Viterbi tier {tier!r}; want one of {TIERS}")
    refuse_dtensor(log_probs, tokens, t_lens, s_lens)
    if log_probs.device.type == "cuda":
        _check_inputs(log_probs, tokens, t_lens, s_lens)
        tier = tier or select_tier(log_probs.shape[1], tokens.shape[1], log_probs.shape[2])
    if cluster:
        check_fits(tier or "k4", log_probs.shape[1], tokens.shape[1], log_probs.shape[2],
                   cluster)
    if tier in ("k2", "k3"):
        emit = viterbi_ref.gather_emissions(log_probs, tokens)
        return viterbi_emissions_batch(emit, tokens, t_lens, s_lens, tier)
    if log_probs.device.type == "cpu":
        return viterbi_ref.viterbi_batch(log_probs, tokens, t_lens, s_lens)
    if log_probs.device.type != "cuda":
        raise ValueError(f"no Viterbi kernel for device {log_probs.device}")
    return _launch(tier, log_probs, tokens, t_lens, s_lens, log_probs.shape[2],
                   cluster=cluster)


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
