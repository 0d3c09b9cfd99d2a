"""K4 on a thread-block cluster against other forms of csrc/viterbi_blocked.cu,
on an NVIDIA GPU.

Run from the repository root on a machine with the card, each other form
saved as a source in a git-ignored directory (an earlier commit's
`git archive`, or a variant of the current source):

    python3 tools/k4_compare.py build/k4var/a.cu [build/k4var/b.cu ...]

It compiles each source given with the port's nvcc flags into
`build/k4_compare/` while the port's own library builds (one nvcc process
each, all started together), prints each build's ptxas registers and
spills for the K4 instantiations, and at the shapes below times, on the
same inputs, each source's `viterbi_k4_launch` and the port's in turns (in
order, then reversed; `chip_smoke.kernel_ms`, the median of each one's
two), every path held equal to the port's. A source whose launcher takes
no cluster (before K4 had one) runs the one-block shapes only. It prints
each time with its µs a frame and the card's name and power limit, and
writes the rows to `build/k4_compare/rows.json`.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from wav2vec2_tpu_torch.ops import cuda_build, viterbi_cuda  # noqa: E402

OUT = ROOT / "build" / "k4_compare"
# (name, T, S_pad, s_len, V, clusters): the 10 min long-form (one block),
# (w3)'s 20 min long-form and the hour at 150 words a minute ((w2))
SHAPES = (("10 min, one block", 30_000, 12_032, 11_999, 32, (1,)),
          ("20 min (w3)", 60_000, 24_064, 23_999, 32, (2, 3, 8)),
          ("60 min at 150 words a minute (w2)", 180_000, 99_072, 99_000, 32, (7,)))


def build_source(source: Path, i: int) -> tuple[Path, subprocess.Popen]:
    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / f"libk4_{i}.so"
    cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(lib), str(source)]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                 text=True)


def ptxas_k4(output: str) -> str:
    """Registers and spills of each K4 instantiation (<false, true, R, ...>)."""
    lines = output.splitlines()
    out = []
    for i, line in enumerate(lines):
        if "Compiling entry" in line and "viterbi_blocked_kernelILb0ELb1E" in line:
            name = line.split("viterbi_blocked_kernel")[1].split("EEvPKf")[0]
            regs = next((x.split("Used")[1].split(",")[0].strip() for x in lines[i:i + 4]
                         if "Used" in x), "?")
            spill = next((x.strip().split(",")[1].strip() for x in lines[i:i + 4]
                          if "spill stores" in x), "?")
            out.append(f"{name}: {regs}, {spill}")
    return "; ".join(out)


def launcher(lib: ctypes.CDLL):
    """(launch(ptrs, cluster, stream), takes_cluster) for a source's K4."""
    fn = lib.viterbi_k4_launch
    takes_cluster = hasattr(lib, "viterbi_k4_cluster")
    ints = 5 if takes_cluster else 4
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    if takes_cluster:
        return (lambda ptrs, cluster, stream: fn(*ptrs, cluster, stream)), True
    return (lambda ptrs, cluster, stream: fn(*ptrs, stream)), False


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("k4_compare: no CUDA device", file=sys.stderr)
        return 2
    sources = [Path(a).resolve() for a in argv]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    builds = [build_source(src, i) for i, src in enumerate(sources)]
    info = cuda_build.build(force=True)
    print(f"port: {ptxas_k4(info['compiler_output'])}")
    libs = []
    for src, (lib, proc) in zip(sources, builds):
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{out}")
        print(f"{src}: {ptxas_k4(out)}")
        libs.append(launcher(ctypes.CDLL(str(lib))))
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    device = torch.device("cuda", 0)
    rng = np.random.default_rng(4)
    rows = []
    for name, t, s_pad, s_len, v, clusters in SHAPES:
        lp = torch.from_numpy(chip_smoke.random_log_probs(rng, 1, t, v)).to(device)
        tok = torch.from_numpy(rng.integers(0, v, size=(1, s_pad)).astype(np.int32)).to(device)
        lens = [torch.tensor([x], dtype=torch.int32, device=device) for x in (t, s_len)]
        bp = torch.empty(viterbi_cuda.bp_scratch_shape("k4", 1, t, s_pad, v), dtype=torch.uint8,
                         device=device)
        for cluster in clusters:
            want = viterbi_cuda.viterbi_batch(lp, tok, *lens, tier="k4", cluster=cluster)
            fns = {"port": lambda c=cluster: viterbi_cuda.viterbi_batch(lp, tok, *lens,
                                                                        tier="k4", cluster=c)}
            for i, (launch, takes_cluster) in enumerate(libs):
                if cluster > 1 and not takes_cluster:
                    continue
                paths = torch.empty((1, t), dtype=torch.int32, device=device)
                ptrs = (lp.data_ptr(), tok.data_ptr(), lens[0].data_ptr(), lens[1].data_ptr(),
                        bp.data_ptr(), paths.data_ptr(), 1, t, v, s_pad)

                def run(launch=launch, ptrs=ptrs, cluster=cluster, paths=paths):
                    err = launch(ptrs, cluster, torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"launch failed: cudaError {err}")
                    return paths

                if not torch.equal(run(), want):
                    raise AssertionError(f"{sources[i].name} at {name}, a cluster of {cluster}: "
                                         "the path differs from the port's")
                fns[sources[i].name if sources[i].name not in fns else str(sources[i])] = run
            times = {k: [] for k in fns}
            for order in (list(fns), list(fns)[::-1]):
                for k in order:
                    times[k].append(chip_smoke.kernel_ms(fns[k], 2 if t > 100_000 else 5))
            ms = {k: statistics.median(x) for k, x in times.items()}
            print(f"{name} (T={t}, S_pad={s_pad}, V={v}) on {cluster} block(s): "
                  + ", ".join(f"{k} {m:.3f} ms ({1e3 * m / t:.3f} us a frame)"
                              for k, m in ms.items())
                  + f" (device time, medians; in turns) [{card}]")
            rows.append(dict(shape=name, t=t, s_pad=s_pad, v=v, cluster=cluster, ms=ms,
                             card=card))
        del lp, bp
    (OUT / "rows.json").write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
