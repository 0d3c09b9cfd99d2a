"""Where K1's resident kernel spends its time, on an NVIDIA GPU.

Run from the repository root on a machine with the card:

    python3 tools/k1_probe.py

It compiles patched copies of `wav2vec2_tpu_torch/csrc/viterbi.cu` with the
port's nvcc flags (one nvcc process each, started together), launches each
through ctypes on the serving shape of `chip_smoke.kernel_cases` (B=128,
T=499, S_pad=256, V=32) for every strip width R, and prints:

- from a copy with clock64/%globaltimer stamps on block 0's thread 0: the
  cycles of the prologue (layout, mbarriers, the first copies, tokens, the
  init row), the frame loop (and per frame), the final-state rule with the
  backtrace, and the path store, and the SM clock those imply;
- the device time (`chip_smoke.kernel_ms`) of the unpatched kernel beside
  copies with one piece of the frame taken out: the cells' arithmetic, the
  bit-plane stores, the block barrier, the next frame's emission reads, or
  the backtrace. Those copies give wrong paths; only the stamped copy and
  the unpatched one are checked against the plain version.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from wav2vec2_tpu_torch.ops import cuda_build, viterbi_ref  # noqa: E402

SOURCE = ROOT / "wav2vec2_tpu_torch" / "csrc" / "viterbi.cu"
OUT = ROOT / "build" / "k1_probe"
STAMP = ('{ long long c_ = clock64(); unsigned long long g_; '
         'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g_)); '
         'if (blockIdx.x == 0 && threadIdx.x == 0) { probe_stamps[2 * ID] = c_; '
         'probe_stamps[2 * ID + 1] = (long long)g_; } }')
READER = ('\nextern "C" int probe_read(long long* out) { return (int)cudaMemcpyFromSymbol('
          'out, probe_stamps, sizeof(long long) * 10); }\n')

# (anchor in the kernel, text put before it) for the five stamps
STAMPS = [
    "  const ResidentLayout lay = resident_layout(t_pad, s_pad, vocab);\n  const uint64_t* bars",
    "  for (int t = 1; t < t_end; ++t) {\n    const uint32_t parity_off",
    "  // final-state rule on the last computed row (or the init row)\n",
    "  int32_t* path = paths + static_cast<size_t>(b) * t_pad;\n  for (int t = tid; t < t_pad",
    None,  # after the path store: the kernel's last statement
]
LAST = "  for (int t = tid; t < t_pad; t += blockDim.x) path[t] = path_s[t];\n}"
# variant name -> (text taken out, text put in)
WITHOUT = {
    "cells": ("    if (below_s_len && s0 - 1 <= 2 * t && 2 * t <= hi2) {",
              "    if (t < 0 && below_s_len && s0 - 1 <= 2 * t && 2 * t <= hi2) {"),
    "plane stores": ("    store_planes(t);\n", ""),
    "barrier": ("    if (!no_barrier) __syncthreads();\n", ""),
    "next frame's reads": ("      next_frame(t + 1);\n      load_row(en);\n",
                           "      next_frame(t + 1);\n"),
    "backtrace": ("  if (tid == 0 && t_end > 0) {", "  if (tid == 0 && t_pad < 0) {"),
}


def replace_once(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise SystemExit(f"k1_probe: the source no longer has one {old[:60]!r}")
    return text.replace(old, new)


def sources() -> dict[str, str]:
    base = SOURCE.read_text()
    stamped = replace_once(base, "namespace {\n", "__device__ long long probe_stamps[10];\nnamespace {\n")
    for i, anchor in enumerate(STAMPS[:-1]):
        stamped = replace_once(stamped, anchor, "  " + STAMP.replace("ID", str(i)) + "\n" + anchor)
    stamped = replace_once(stamped, LAST, LAST[:-1] + "  " + STAMP.replace("ID", "4") + "\n}")
    out = {"unpatched": base, "stamped": stamped + READER}
    for name, (old, new) in WITHOUT.items():
        out[name] = replace_once(base, old, new)
    return out


def build(texts: dict[str, str]) -> dict[str, ctypes.CDLL]:
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(texts.items()):
        src = OUT / f"v{i}.cu"
        src.write_text(text)
        procs[name] = (subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(OUT / f"v{i}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), OUT / f"v{i}.so")
    libs = {}
    for name, (proc, lib_path) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"k1_probe: nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(lib_path))
        lib.viterbi_k1_resident_launch.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                                                   + [ctypes.c_void_p])
        lib.viterbi_k1_resident_launch.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_probe: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    libs = build(sources())
    libs["stamped"].probe_read.argtypes = [ctypes.c_void_p]
    libs["stamped"].probe_read.restype = ctypes.c_int
    device = torch.device("cuda", 0)
    _, lp, tok, t_lens, s_lens = chip_smoke.kernel_cases(np.random.default_rng(0))[0]
    args = [torch.from_numpy(a).to(device) for a in (lp, tok, t_lens, s_lens)]
    want = viterbi_ref.viterbi_batch(*args)
    b, t_pad, v = lp.shape
    s_pad = tok.shape[1]
    out = torch.empty((b, t_pad), dtype=torch.int32, device=device)

    def launcher(lib, strip):
        def launch():
            err = lib.viterbi_k1_resident_launch(
                *(a.data_ptr() for a in args), None, out.data_ptr(), b, t_pad, v, s_pad, strip,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed: cudaError {err}")
        return launch

    frames = int(t_lens.max()) - 1
    for strip in (1, 2, 4, 8):
        for name in ("unpatched", "stamped"):
            launcher(libs[name], strip)()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"the {name} kernel at R={strip} differs from the plain version")
        stamps = (ctypes.c_longlong * 10)()
        libs["stamped"].probe_read(stamps)
        c = [stamps[2 * i] for i in range(5)]
        g = [stamps[2 * i + 1] for i in range(5)]
        print(f"R={strip}: block 0, cycles: prologue {c[1] - c[0]}, frame loop {c[2] - c[1]} "
              f"({(c[2] - c[1]) / frames:.0f} a frame), final state + backtrace {c[3] - c[2]}, "
              f"path store {c[4] - c[3]}; {g[4] - g[0]} ns in all, so "
              f"{(c[4] - c[0]) / (g[4] - g[0]):.3f} GHz [{card}]")
        names = ["unpatched", *WITHOUT]
        ms = chip_smoke.turns_ms({n: launcher(libs[n], strip) for n in names}, 30)
        print(f"R={strip}: device time (chip_smoke.kernel_ms, medians, in turns): "
              f"unpatched {ms['unpatched']:.4f} ms; without "
              + ", ".join(f"the {n} {ms[n]:.4f} ms" for n in WITHOUT) + f" [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
