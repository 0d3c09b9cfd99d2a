"""Export a model dir (config.json + vocab.json + model.safetensors) to
model.onnx, on PyTorch.

Counterpart of the JAX package's `scripts/export_onnx_model.py` (the analog
of the reference's scripts/export_ctc_model_to_onnx.py), with no torch.onnx
or onnx dependency: the graph is built by `wav2vec2_tpu_torch.onnx.export`
from the parameter tree the torch backend runs, so the two runtimes share
weights by construction. The output is f32 with dynamic batch/time axes
(opset 17, primitive ops only): it loads in stock onnxruntime and in the
port's embedded session.

Usage:
    python -m wav2vec2_tpu_torch.cli.export_onnx_model --model-dir M \
        [--out M/model.onnx] [--verify] [--device cuda|cpu]

`--verify` runs one random utterance through the embedded session on
`--device` (cuda by default) and compares its logits with the port's f32
forward on the same device.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

VERIFY_TOLERANCE = 1e-3  # the JAX script's bound on max |onnx - forward|


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model-dir", required=True)
    p.add_argument("--out", default=None,
                   help="output path (default MODEL_DIR/model.onnx)")
    p.add_argument("--verify", action="store_true",
                   help="compare embedded-session logits vs the port's f32 "
                        "forward on one random utterance")
    p.add_argument("--device", default="cuda",
                   help="torch device of --verify: cuda (default) or cpu")
    args = p.parse_args(argv)

    from ..config import Wav2Vec2ModelConfig
    from ..models.params import load_safetensors_params
    from ..onnx import export_ctc_model, save_model

    model_dir = Path(args.model_dir)
    out = Path(args.out) if args.out else model_dir / "model.onnx"
    cfg = Wav2Vec2ModelConfig.load(model_dir / "config.json")
    params = load_safetensors_params(model_dir / "model.safetensors", cfg)

    t0 = time.perf_counter()
    model = export_ctc_model(cfg, params)
    save_model(out, model)
    size_mb = out.stat().st_size / 1e6
    print(f"[export_onnx] wrote {out} ({size_mb:.1f} MB, "
          f"{len(model.graph.nodes)} nodes) in "
          f"{time.perf_counter() - t0:.1f} s")

    if args.verify:
        from ..errors import InvalidInputError
        from ..models.ctc_model import wav2vec2_forward
        from ..models.params import params_to_device
        from ..onnx import EmbeddedOnnxSession
        from ..utils.device import select_device

        try:
            device = select_device(args.device)
        except InvalidInputError as e:
            raise SystemExit(f"error: {e}") from None
        sess = EmbeddedOnnxSession(out, device=device)
        audio = np.random.default_rng(0).normal(
            size=(1, 16000)).astype(np.float32)
        (logits,) = sess.run(None, {"audio": audio})
        with torch.inference_mode():
            ref = wav2vec2_forward(params_to_device(params, device),
                                   torch.from_numpy(audio).to(device), cfg)
        diff = float(np.abs(logits - ref.cpu().numpy()).max())
        print(f"[export_onnx] verify: max|onnx - torch| = {diff:.2e} on "
              f"{sess.get_providers()[0]}")
        if diff > VERIFY_TOLERANCE:
            print("[export_onnx] FAIL: logits diverge", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
