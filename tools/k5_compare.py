"""K5's bf16 kernel against an earlier form of it, on an NVIDIA GPU.

Run from the repository root on a machine with the card, with the earlier
form's source unpacked from its commit into a git-ignored directory:

    mkdir -p build/parent
    git archive <commit> wav2vec2_tpu_torch/csrc | tar -x -C build/parent
    python3 tools/k5_compare.py build/parent/wav2vec2_tpu_torch/csrc/flash_attention.cu

It compiles that source with the port's nvcc flags into `build/k5_compare/`
while the port's own library builds (two nvcc processes started together),
finds the earlier source's bf16 launcher (`flash_attention_mma_launch` in
the mma.sync form, or `flash_attention_wgmma_launch`), and at each shape K5
runs on the main paths times, on the same padded inputs, the earlier
kernel and the current one in turns (earlier, current, current, earlier;
`chip_smoke.kernel_ms`, the median of each pair), and one
scaled_dot_product_attention call with the position term and the mask as
a precomputed bf16 bias (its construction excluded). Both kernels are held
to the plain version within `chip_smoke.FLASH_REL_BOUND`. It prints every
time with the bound, the TFLOP/s and the card's name and power limit, and
writes the rows to `build/k5_compare/rows.json`.
"""

from __future__ import annotations

import ctypes
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


def build_earlier(source: Path) -> subprocess.Popen:
    OUT.mkdir(parents=True, exist_ok=True)
    cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(OUT / "libearlier.so"),
           str(source)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def earlier_launcher(lib: ctypes.CDLL):
    for name in ("flash_attention_mma_launch", "flash_attention_wgmma_launch"):
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float,
                                                                       ctypes.c_void_p]
            fn.restype = ctypes.c_int
            return name, fn
    raise RuntimeError("the earlier source has no bf16 K5 launcher")


def rel_error(got, want):
    return float((got.float() - want).abs().max()) / float(want.abs().max())


def main() -> int:
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    earlier = build_earlier(Path(sys.argv[1]))
    cuda_build.build()
    log = earlier.communicate()[0]
    if earlier.returncode != 0:
        raise RuntimeError(f"nvcc failed on the earlier source:\n{log}")
    name, old = earlier_launcher(ctypes.CDLL(str(OUT / "libearlier.so")))
    device = torch.device("cuda", 0)
    rows = []
    for what, b, nh, t, hd, rel in SHAPES:
        scale = hd ** -0.5
        q, k, v, mask, q_pos, rel_r = chip_smoke.flash_inputs(
            np.random.default_rng(14), b, nh, t, hd, "bfloat16", rel, True, device)
        pq, pk, pv, pmask, pq_pos = fa.pad_inputs(q, k, v, mask, q_pos, rel_r)
        t_pad = pq.shape[2]
        out = torch.empty_like(pq)
        stream = torch.cuda.current_stream().cuda_stream

        def earlier_call():
            err = old(pq.data_ptr(), None if pq_pos is None else pq_pos.data_ptr(),
                      pk.data_ptr(), pv.data_ptr(), None if rel_r is None else rel_r.data_ptr(),
                      pmask.data_ptr(), out.data_ptr(), b, nh, t_pad, hd, scale, stream)
            if err:
                raise RuntimeError(f"{name}: cudaError {err}")
            return out

        def current_call():
            return fa.flash_attention(pq, pk, pv, pmask, q_pos=pq_pos, rel_r=rel_r, scale=scale)

        want = flash_attention_ref.attention(pq, pk, pv, pmask, q_pos=pq_pos, rel_r=rel_r,
                                             scale=scale).float()
        errs = {"earlier": rel_error(earlier_call(), want),
                "current": rel_error(current_call(), want)}
        bound = chip_smoke.FLASH_REL_BOUND["bfloat16"]
        if max(errs.values()) > bound:
            raise AssertionError(f"{what}: relative errors {errs} against the plain version")
        e1 = chip_smoke.kernel_ms(earlier_call, 20)
        c1 = chip_smoke.kernel_ms(current_call, 20)
        c2 = chip_smoke.kernel_ms(current_call, 20)
        e2 = chip_smoke.kernel_ms(earlier_call, 20)
        with torch.inference_mode():
            bias = pmask[:, None, None, :]
            if rel:
                bias = flash_attention_ref.rel_scores(pq_pos, rel_r) * scale + bias
            bias = bias.to(torch.bfloat16)
            lib_ms = chip_smoke.kernel_ms(
                lambda: F.scaled_dot_product_attention(pq, pk, pv, attn_mask=bias, scale=scale),
                20)
        bound_ms, bound_by = chip_smoke.flash_bound(b, nh, t_pad, hd, 2,
                                                    chip_smoke.PEAK_BF16_OPS_PER_S, rel=rel)
        work = (6 if rel else 4) * t_pad * t_pad * hd * b * nh
        row = dict(shape=what, b=b, nh=nh, t=t, t_pad=t_pad, hd=hd, rel=rel,
                   earlier_ms=(e1 + e2) / 2, current_ms=(c1 + c2) / 2, sdpa_ms=lib_ms,
                   bound_ms=bound_ms, bound_by=bound_by, errors=errs, card=smi)
        row["current_tflops"] = work / (row["current_ms"] * 1e-3) / 1e12
        row["earlier_tflops"] = work / (row["earlier_ms"] * 1e-3) / 1e12
        rows.append(row)
        print(f"k5 {what} B={b} NH={nh} T={t} (T_pad={t_pad}) hd={hd}: earlier ({name}) "
              f"{row['earlier_ms']:.4f} ms ({e1:.4f}, {e2:.4f}), current {row['current_ms']:.4f} "
              f"ms ({c1:.4f}, {c2:.4f}), SDPA {lib_ms:.4f} ms; current/SDPA "
              f"{row['current_ms'] / lib_ms:.2f}, current/earlier "
              f"{row['current_ms'] / row['earlier_ms']:.2f}; {row['current_tflops']:.1f} vs "
              f"{row['earlier_tflops']:.1f} TFLOP/s; bound {bound_ms:.4f} ms by {bound_by} "
              f"({bound_ms / row['current_ms']:.1%} of it); relative errors "
              f"{errs['earlier']:.2e} / {errs['current']:.2e} {card}", flush=True)
    (OUT / "rows.json").write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
