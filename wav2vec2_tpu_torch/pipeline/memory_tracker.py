"""Per-stage peak memory tracking (counterpart of
`wav2vec2_tpu.pipeline.memory_tracker`).

As in the Rust reference's src/pipeline/memory_tracker.rs:16-249: a
background sampler thread polls process RSS every 5 ms keeping a max, and
the device is synchronized BEFORE reading accelerator memory (the
async-compute caveat of memory_tracker.rs:1-5). On a CUDA device each stage
resets PyTorch's peak-allocation counter before it runs; after the sync,
`used` is the stage's peak of `torch.cuda.max_memory_allocated` and `total`
the card's memory from `torch.cuda.mem_get_info`. Where no reading can be
taken (a CPU device) the snapshot is None, never zeros.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional

import torch

SAMPLE_INTERVAL_S = 0.005  # 5 ms, memory_tracker.rs:26


@dataclass
class DeviceMemorySnapshot:
    used: int
    total: int


@dataclass
class StageMemory:
    peak_rss_bytes: int = 0
    device: Optional[DeviceMemorySnapshot] = None


@dataclass
class StageMemoryMap:
    forward: Optional[StageMemory] = None
    post: Optional[StageMemory] = None
    dp: Optional[StageMemory] = None
    group: Optional[StageMemory] = None
    conf: Optional[StageMemory] = None
    extras: dict = field(default_factory=dict)


def _read_rss_linux() -> int:
    try:
        fields = Path("/proc/self/statm").read_text().split()
        return int(fields[1]) * 4096  # resident pages × page size
    except (OSError, IndexError, ValueError):
        return 0


def _read_rss_windows() -> int:
    """GetProcessMemoryInfo → WorkingSetSize (memory_tracker.rs:196-218)."""
    try:
        import ctypes
        import ctypes.wintypes as wt

        class PMC(ctypes.Structure):
            _fields_ = [
                ("cb", wt.DWORD),
                ("PageFaultCount", wt.DWORD),
                ("PeakWorkingSetSize", ctypes.c_size_t),
                ("WorkingSetSize", ctypes.c_size_t),
                ("QuotaPeakPagedPoolUsage", ctypes.c_size_t),
                ("QuotaPagedPoolUsage", ctypes.c_size_t),
                ("QuotaPeakNonPagedPoolUsage", ctypes.c_size_t),
                ("QuotaNonPagedPoolUsage", ctypes.c_size_t),
                ("PagefileUsage", ctypes.c_size_t),
                ("PeakPagefileUsage", ctypes.c_size_t),
            ]

        pmc = PMC()
        pmc.cb = ctypes.sizeof(PMC)
        h = ctypes.windll.kernel32.GetCurrentProcess()
        if ctypes.windll.psapi.GetProcessMemoryInfo(
            h, ctypes.byref(pmc), pmc.cb
        ):
            return int(pmc.WorkingSetSize)
    except Exception:
        pass
    return 0


def _read_rss_macos() -> int:
    """libproc proc_pidinfo(PROC_PIDTASKINFO) → pti_resident_size
    (memory_tracker.rs:220-249)."""
    try:
        import ctypes
        import os

        libproc = ctypes.CDLL("libproc.dylib")
        PROC_PIDTASKINFO = 4

        class ProcTaskInfo(ctypes.Structure):
            _fields_ = [
                ("pti_virtual_size", ctypes.c_uint64),
                ("pti_resident_size", ctypes.c_uint64),
                ("pti_total_user", ctypes.c_uint64),
                ("pti_total_system", ctypes.c_uint64),
                ("pti_threads_user", ctypes.c_uint64),
                ("pti_threads_system", ctypes.c_uint64),
                ("pti_policy", ctypes.c_int32),
                ("pti_faults", ctypes.c_int32),
                ("pti_pageins", ctypes.c_int32),
                ("pti_cow_faults", ctypes.c_int32),
                ("pti_messages_sent", ctypes.c_int32),
                ("pti_messages_received", ctypes.c_int32),
                ("pti_syscalls_mach", ctypes.c_int32),
                ("pti_syscalls_unix", ctypes.c_int32),
                ("pti_csw", ctypes.c_int32),
                ("pti_threadnum", ctypes.c_int32),
                ("pti_numrunning", ctypes.c_int32),
                ("pti_priority", ctypes.c_int32),
            ]

        info = ProcTaskInfo()
        n = libproc.proc_pidinfo(
            os.getpid(), PROC_PIDTASKINFO, 0,
            ctypes.byref(info), ctypes.sizeof(info),
        )
        if n >= ctypes.sizeof(info):
            return int(info.pti_resident_size)
    except Exception:
        pass
    return 0


def _pick_rss_reader():
    import sys

    if sys.platform.startswith("linux"):
        return _read_rss_linux
    if sys.platform == "win32":
        return _read_rss_windows
    if sys.platform == "darwin":
        return _read_rss_macos
    return lambda: 0


_rss_reader = _pick_rss_reader()


def read_process_rss_bytes() -> int:
    """Current process resident set size. Per-OS readers mirror the
    reference's (memory_tracker.rs:170-249): Linux /proc/self/statm,
    Windows GetProcessMemoryInfo, macOS proc_pidinfo."""
    return _rss_reader()


def _cuda_device(device) -> Optional[torch.device]:
    device = torch.device(device) if device is not None else None
    if device is None or device.type != "cuda" or not torch.cuda.is_available():
        return None
    return device


def device_memory_snapshot(device=None) -> Optional[DeviceMemorySnapshot]:
    """Device memory after the caller has synchronized: the peak bytes
    PyTorch allocated on `device` since its last peak reset, and the card's
    total. None unless `device` is a CUDA device."""
    device = _cuda_device(device)
    if device is None:
        return None
    _, total = torch.cuda.mem_get_info(device)
    return DeviceMemorySnapshot(
        used=int(torch.cuda.max_memory_allocated(device)), total=int(total)
    )


class MemoryTracker:
    """measure(stage, sync_fn, f): runs f while a sampler thread tracks peak
    RSS; syncs the device before reading device memory
    (memory_tracker.rs:109-168). `device` is the torch device the stages
    run on."""

    def __init__(self, device=None):
        self.stages = StageMemoryMap()
        self.device = device

    def measure(self, stage: str, sync_fn: Callable[[], None], f: Callable):
        cuda = _cuda_device(self.device)
        if cuda is not None:
            sync_fn()
            torch.cuda.reset_peak_memory_stats(cuda)
        peak = {"rss": read_process_rss_bytes()}
        stop = threading.Event()

        def sampler():
            while not stop.is_set():
                rss = read_process_rss_bytes()
                if rss > peak["rss"]:
                    peak["rss"] = rss
                stop.wait(SAMPLE_INTERVAL_S)

        thread = threading.Thread(target=sampler, daemon=True)
        thread.start()
        try:
            result = f()
        finally:
            # device must be idle before reading accelerator memory
            sync_fn()
            stop.set()
            thread.join(timeout=1.0)

        mem = StageMemory(
            peak_rss_bytes=peak["rss"], device=device_memory_snapshot(cuda)
        )
        if hasattr(self.stages, stage):
            setattr(self.stages, stage, mem)
        else:
            self.stages.extras[stage] = mem
        return result
