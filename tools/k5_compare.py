"""K5 against earlier forms of it, on an NVIDIA GPU, in bf16 or f32.

Run from the repository root on a machine with the card, with the earlier
form's source unpacked from its commit into a git-ignored directory:

    mkdir -p build/parent
    git archive <commit> wav2vec2_tpu_torch/csrc | tar -x -C build/parent
    python3 tools/k5_compare.py [--dtype float32] \\
        build/parent/wav2vec2_tpu_torch/csrc/flash_attention.cu [variant.cu ...]

It compiles each source given with the port's nvcc flags into
`build/k5_compare/` while the port's own library builds (one nvcc process
each, all started together), prints each build's ptxas registers and
spills for K5's kernels, finds each source's launcher of the dtype (bf16:
`flash_attention_mma_launch` in the mma.sync form, or
`flash_attention_wgmma_launch`; f32: `flash_attention_fma_launch`), and
at each shape K5 runs on the main paths times, on the same padded inputs,
the sources' kernels and the current one in turns (in order, then
reversed; `chip_smoke.kernel_ms`, the mean of each one's two), and one
scaled_dot_product_attention call on the same dtype with the position
term and the mask as a precomputed bias (its construction excluded; the
backend its dispatcher picks named). Every kernel is held to the
plain version within `chip_smoke.FLASH_REL_BOUND`. The first source is
"earlier"; more (tuning variants of the current source) are timed beside
the two. It prints every time with the bound (at the dtype's peak: 989
TFLOP/s bf16 on the tensor cores, 67 f32), the TFLOP/s and the card's
name and power limit, and writes the rows to `build/k5_compare/rows.json`
(`rows_float32.json` for f32). With `--conformer-forward` (f32) it also
times wav2vec2-conformer-rel-pos-large's f32 forward at 32 x 10 s (full
width and depth, `chip_smoke`'s random weights), whose 24 K5 launches go
to the earlier kernel and to the current one in turns (earlier, current,
current, earlier; CUDA events), the two forwards' logits within 1e-4.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke  # noqa: E402
from wav2vec2_tpu_torch.models.layers import full_f32_precision  # noqa: E402
from wav2vec2_tpu_torch.ops import cuda_build, flash_attention_ref  # noqa: E402
from wav2vec2_tpu_torch.ops import flash_attention as fa  # noqa: E402

OUT = ROOT / "build" / "k5_compare"
# (name, B, NH, T, hd, rel): the conformer rel-pos large at 32 x 10 s, the
# forced plain attention of lv60 (hd 64) and mms-1b (hd 80) at 32 x 10 s,
# an online window of the conformer, and the (m2) mesh's local tiles
SHAPES = (("conformer rel-pos", 32, 16, 499, 64, True),
          ("forced plain hd 64", 32, 16, 499, 64, False),
          ("forced plain hd 80", 32, 16, 499, 80, False),
          ("online window", 1, 16, 249, 64, True),
          ("mesh tile (2x1)", 4, 16, 499, 64, True),
          ("mesh tile (1x2)", 8, 8, 499, 64, True))
# f32 also runs the long-form 30 s chunk of the conformer (T 1 499 → 1 536)
LONGFORM_CHUNK = ("long-form 30 s chunk", 2, 16, 1499, 64, True)
LAUNCHERS = {"bfloat16": ("flash_attention_mma_launch", "flash_attention_wgmma_launch"),
             "float32": ("flash_attention_fma_launch",)}


def build_source(source: Path, i: int) -> tuple[Path, subprocess.Popen]:
    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / f"libsource{i}.so"
    cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(lib), str(source)]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                 text=True)


def k5_ptxas(log: str) -> str:
    """The stack, spill and register lines of K5's kernels in a ptxas -v log."""
    lines, out = log.splitlines(), []
    for i, line in enumerate(lines):
        if "Function properties for" in line and "flash_attention" in line:
            name = line.split("flash_attention_")[-1].split("EE")[0]
            out.append(f"{name}: " + "; ".join(l.split(":", 1)[-1].strip()
                                               for l in lines[i + 1:i + 3]))
    return "\n  ".join(out)


def launcher(lib: ctypes.CDLL, dtype: str):
    for name in LAUNCHERS[dtype]:
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float,
                                                                       ctypes.c_void_p]
            fn.restype = ctypes.c_int
            return name, fn
    raise RuntimeError(f"the source has no {dtype} K5 launcher")


class _Launchers:
    """The kernel library with some launchers replaced."""

    def __init__(self, lib, **launchers):
        self._lib, self._launchers = lib, launchers

    def __getattr__(self, name):
        return self._launchers.get(name) or getattr(self._lib, name)


def conformer_forward(name: str, fn, card: str) -> dict:
    """The conformer rel-pos large f32 forward at 32 x 10 s with its K5
    launches in the earlier kernel (`fn`, a launcher of `name`) and in the
    current one, in turns."""
    from wav2vec2_tpu_torch.config import Wav2Vec2ModelConfig
    from wav2vec2_tpu_torch.models.ctc_model import wav2vec2_forward
    from wav2vec2_tpu_torch.models.params import params_from_jax
    from wav2vec2_tpu_torch.parallel.batching import _normalize_batch

    device = torch.device("cuda", 0)
    cfg = dataclasses.replace(Wav2Vec2ModelConfig.from_dict(chip_smoke.CONFORMER_CONFIG),
                              use_flash_attention=True)
    params = params_from_jax(chip_smoke.conformer_params(cfg, seed=10), device=device)
    _, audio, a_l, _, _ = chip_smoke.batch_inputs(np.random.default_rng(0),
                                                  chip_smoke.make_vocab(), 32, 10.0)
    lens = torch.from_numpy(a_l).to(device)
    x = _normalize_batch(torch.from_numpy(audio).to(device), lens)
    real = fa._library
    earlier = _Launchers(real(), **{name: fn})

    def forward(lib):
        fa._library = lambda: lib
        try:
            with torch.inference_mode():
                return wav2vec2_forward(params, x, cfg, audio_lens=lens,
                                        compute_dtype=torch.float32)
        finally:
            fa._library = real

    before = fa.kernel_launches["fma"]
    got, want = forward(earlier), forward(real())
    if fa.kernel_launches["fma"] - before != 2 * cfg.num_hidden_layers:
        raise AssertionError("the forwards did not launch the f32 kernel once a layer")
    err = rel_error(got, want.float())
    if err > 1e-4:
        raise AssertionError(f"conformer f32 forward: earlier vs current kernel {err}")
    del got, want
    times = {"earlier": [], "current": []}
    for label in ("earlier", "current", "current", "earlier"):
        lib = earlier if label == "earlier" else real()
        times[label].append(chip_smoke.cuda_time_ms(lambda: forward(lib), 3))
    ms = {label: sum(t) / 2 for label, t in times.items()}
    print(f"k5 float32 conformer rel-pos large f32 forward, 32 x 10 s (24 K5 launches): "
          f"earlier kernel {ms['earlier']:.3f} ms ({times['earlier'][0]:.3f}, "
          f"{times['earlier'][1]:.3f}), current {ms['current']:.3f} ms "
          f"({times['current'][0]:.3f}, {times['current'][1]:.3f}); "
          f"{ms['earlier'] - ms['current']:.3f} ms less; logits relative difference {err:.2e} "
          f"(CUDA events, medians of 3) {card}", flush=True)
    return dict(shape="conformer rel-pos large f32 forward, 32 x 10 s", ms=ms, times=times,
                logits_rel_diff=err, card=card)


def rel_error(got, want):
    return float((got.float() - want).abs().max()) / float(want.abs().max())


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("sources", type=Path, nargs="+",
                        help="the earlier flash_attention.cu, then any variants to time")
    parser.add_argument("--dtype", choices=sorted(LAUNCHERS), default="bfloat16")
    parser.add_argument("--conformer-forward", action="store_true",
                        help="f32: also time the conformer's f32 forward with each kernel")
    args = parser.parse_args()
    if args.conformer_forward and args.dtype != "float32":
        parser.error("--conformer-forward times the f32 kernel: give --dtype float32")
    if not torch.cuda.is_available():
        print("k5_compare: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    builds = [build_source(src, i) for i, src in enumerate(args.sources)]
    current = cuda_build.build()
    print(f"k5 current ({cuda_build.LIBRARY}), ptxas:\n  "
          f"{k5_ptxas(current['compiler_output']) or 'library up to date'}")
    launchers = {}
    for src, (lib, proc) in zip(args.sources, builds):
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{log}")
        launchers[str(src)] = launcher(ctypes.CDLL(str(lib)), args.dtype)
        print(f"k5 {src} ({launchers[str(src)][0]}), ptxas:\n  {k5_ptxas(log)}", flush=True)
    earliest = str(args.sources[0])
    device = torch.device("cuda", 0)
    dt = getattr(torch, args.dtype)
    f32 = args.dtype == "float32"
    peak = chip_smoke.PEAK_F32_OPS_PER_S if f32 else chip_smoke.PEAK_BF16_OPS_PER_S
    rows = []
    for what, b, nh, t, hd, rel in SHAPES + ((LONGFORM_CHUNK,) if f32 else ()):
        scale = hd ** -0.5
        q, k, v, mask, q_pos, rel_r = chip_smoke.flash_inputs(
            np.random.default_rng(14), b, nh, t, hd, args.dtype, rel, True, device)
        pq, pk, pv, pmask, pq_pos = fa.pad_inputs(q, k, v, mask, q_pos, rel_r)
        t_pad = pq.shape[2]
        out = torch.empty_like(pq)
        stream = torch.cuda.current_stream().cuda_stream

        def launch(label):
            name, fn = launchers[label]

            def call():
                err = fn(pq.data_ptr(), None if pq_pos is None else pq_pos.data_ptr(),
                         pk.data_ptr(), pv.data_ptr(),
                         None if rel_r is None else rel_r.data_ptr(), pmask.data_ptr(),
                         out.data_ptr(), b, nh, t_pad, hd, scale, stream)
                if err:
                    raise RuntimeError(f"{label} {name}: cudaError {err}")
                return out

            return call

        calls = {label: launch(label) for label in launchers}
        calls["current"] = lambda: fa.flash_attention(pq, pk, pv, pmask, q_pos=pq_pos,
                                                      rel_r=rel_r, scale=scale)
        with full_f32_precision():
            want = flash_attention_ref.attention(pq, pk, pv, pmask, q_pos=pq_pos, rel_r=rel_r,
                                                 scale=scale).float()
        errs = {label: rel_error(call(), want) for label, call in calls.items()}
        if max(errs.values()) > chip_smoke.FLASH_REL_BOUND[args.dtype]:
            raise AssertionError(f"{what}: relative errors {errs} against the plain version")
        del want
        launches = 5 if f32 else 20
        times = {label: [] for label in calls}
        for order in (list(calls), list(calls)[::-1]):
            for label in order:
                times[label].append(chip_smoke.kernel_ms(calls[label], launches))
        ms = {label: sum(t) / 2 for label, t in times.items()}
        with torch.inference_mode(), full_f32_precision():
            bias = pmask[:, None, None, :]
            if rel:
                bias = flash_attention_ref.rel_scores(pq_pos, rel_r) * scale + bias
            bias = bias.to(dt)
            library = lambda: F.scaled_dot_product_attention(  # noqa: E731
                pq, pk, pv, attn_mask=bias, scale=scale)
            library()
            lib_ms = chip_smoke.kernel_ms(library, launches)
            backend = chip_smoke.sdpa_backend(pq, pk, pv, bias, scale)
            del bias
        bound_ms, bound_by = chip_smoke.flash_bound(b, nh, t_pad, hd, pq.element_size(), peak,
                                                    rel=rel)
        work = (6 if rel else 4) * t_pad * t_pad * hd * b * nh
        tflops = {label: work / (x * 1e-3) / 1e12 for label, x in ms.items()}
        rows.append(dict(shape=what, dtype=args.dtype, b=b, nh=nh, t=t, t_pad=t_pad, hd=hd,
                         rel=rel, earlier_ms=ms[earliest], current_ms=ms["current"], ms=ms,
                         times=times, tflops=tflops, sdpa_ms=lib_ms, sdpa_backend=backend,
                         bound_ms=bound_ms, bound_by=bound_by, errors=errs, card=smi))
        c, e = ms["current"], ms[earliest]
        others = "".join(f"; {label} {x:.4f} ms ({tflops[label]:.1f} TFLOP/s)"
                         for label, x in ms.items() if label not in (earliest, "current"))
        print(f"k5 {args.dtype} {what} B={b} NH={nh} T={t} (T_pad={t_pad}) hd={hd}: earlier "
              f"({earliest}) {e:.4f} ms ({times[earliest][0]:.4f}, {times[earliest][1]:.4f}), "
              f"current {c:.4f} ms ({times['current'][0]:.4f}, {times['current'][1]:.4f}), "
              f"SDPA {lib_ms:.4f} ms ({backend}); current/SDPA {c / lib_ms:.2f}, "
              f"current/earlier {c / e:.2f}; {tflops['current']:.1f} vs {tflops[earliest]:.1f} "
              f"TFLOP/s; bound {bound_ms:.4f} ms by {bound_by} ({bound_ms / c:.1%} of it)"
              f"{others}; relative errors "
              + ", ".join(f"{label} {err:.2e}" for label, err in errs.items())
              + f" {card}", flush=True)
    if args.conformer_forward:
        rows.append(conformer_forward(*launchers[earliest], smi))
    suffix = "_float32" if f32 else ""
    (OUT / f"rows{suffix}.json").write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
