"""ONNX runtime backend (counterpart of `wav2vec2_tpu.pipeline.onnx_runtime`).

Parity with the reference's second model runtime (model_runtime.rs:198-655,
OnnxRuntimeBackend): it consumes the ONNX files its exporter produces
(`onnx/export.py`, `python -m wav2vec2_tpu_torch.cli.export_onnx_model`),
input `[1, num_samples]` f32, output `[1, T, V]` or `[T, V]` logits (batch
must be 1), precision-aware extraction (f16/bf16/f64 converted to f32,
model_runtime.rs:350-470), then the row-wise max-shift log-softmax with f64
accumulation on the host (:640-655). The helpers are the JAX package's,
carried over unchanged.

Where the session runs:
- with onnxruntime installed, an `onnxruntime.InferenceSession` over the
  provider chain of `execution_providers`. Asked for `cuda`, the backend
  checks that the session's first provider is CUDA and raises if it is
  not: onnxruntime drops to its CPU provider quietly, and that must not
  pass as a card run;
- without onnxruntime (the card's machine has none), the port's
  `EmbeddedOnnxSession` on the asked torch device: the graph runs as torch
  operations on the card, or raises where there is no card. It never runs
  the forward on the CPU when asked for `cuda`. `allow_embedded=False`
  restores the reference's "onnx feature disabled ⇒ runtime error"
  behavior (model_runtime.rs:15-44).

The logits come to the host for the f64 log-softmax, as in the reference;
on `cuda` the f32 log-probs then go back to the card, so the Viterbi DP
and the evidence run there (K1, or the blocked tiers for long inputs).
"""

from __future__ import annotations

import logging
import threading
import time
from pathlib import Path

import numpy as np
import torch

from ..config import Wav2Vec2ModelConfig
from ..errors import RuntimeBackendError
from .traits import ForwardOutput

logger = logging.getLogger(__name__)

_PRECISION_LABELS = {
    "float16": "f16", "f16": "f16", "fp16": "f16", "half": "f16",
    "bfloat16": "bf16", "bf16": "bf16",
    "float32": "f32", "f32": "f32", "fp32": "f32", "float": "f32",
    "float64": "f64", "f64": "f64", "fp64": "f64", "double": "f64",
}


def normalize_precision_label(dtype: str) -> str:
    """Trim/lowercase/strip separators (model_runtime.rs
    normalize_precision_label)."""
    return dtype.strip().lower().replace("-", "").replace("_", "")


def precision_from_config(dtype: str | None) -> str | None:
    """Config `dtype` → canonical label, or None when unspecified
    (OnnxTensorPrecision::from_config, model_runtime.rs:358-375)."""
    if dtype is None:
        return None
    label = _PRECISION_LABELS.get(normalize_precision_label(dtype))
    if label is None:
        raise RuntimeBackendError(
            "onnx precision",
            f"unsupported ONNX model dtype '{dtype}', expected f32, f16, "
            f"bf16, or f64",
        )
    return label


def extract_raw_logits_f32(logits) -> tuple[np.ndarray, str]:
    """ONNX output tensor → (float32 array, precision label).

    Mirrors extract_onnx_raw_logits + the f16/bf16/f64→f32 converters
    (model_runtime.rs:408-487). bfloat16 outputs arrive as ml_dtypes.bfloat16
    arrays (onnxruntime's numpy binding) — converted via f32 cast."""
    arr = np.asarray(logits)
    if arr.dtype == np.float32:
        return arr, "f32"
    if arr.dtype == np.float16:
        return arr.astype(np.float32), "f16"
    if arr.dtype == np.float64:
        return arr.astype(np.float32), "f64"
    try:
        import ml_dtypes

        if arr.dtype == ml_dtypes.bfloat16:
            return arr.astype(np.float32), "bf16"
    except ImportError:
        pass
    raise RuntimeBackendError(
        "onnx extract logits",
        f"unsupported ONNX logits dtype '{arr.dtype}', expected f32, f16, "
        f"bf16, or f64",
    )


def execution_providers(device: str) -> list[str]:
    """EP chain with fallback (onnx_execution_providers,
    model_runtime.rs:490-506): cpu → CPU; cuda → CUDA then CPU."""
    dev = device.strip().lower()
    if dev == "cpu":
        return ["CPUExecutionProvider"]
    if dev == "cuda":
        return ["CUDAExecutionProvider", "CPUExecutionProvider"]
    raise RuntimeBackendError(
        "onnx device", f"unsupported ONNX device '{device}', expected 'cpu' or 'cuda'"
    )


def parse_onnx_output_shape(shape: tuple[int, ...]) -> tuple[int, int]:
    """Accepts [1, T, V] or [T, V]; batch must be 1
    (model_runtime.rs:586-618)."""
    if len(shape) == 3:
        if shape[0] != 1:
            raise RuntimeBackendError(
                "onnx output", f"batch dimension must be 1, got {shape[0]}"
            )
        return int(shape[1]), int(shape[2])
    if len(shape) == 2:
        return int(shape[0]), int(shape[1])
    raise RuntimeBackendError("onnx output", f"unexpected logits shape {shape}")


def raw_logits_to_log_probs(logits: np.ndarray) -> np.ndarray:
    """Row-wise max-shift log-softmax with f64 accumulation
    (model_runtime.rs:640-655)."""
    x = np.asarray(logits, dtype=np.float64)
    m = x.max(axis=-1, keepdims=True)
    shifted = x - m
    logsum = np.log(np.exp(shifted).sum(axis=-1, keepdims=True))
    return (shifted - logsum).astype(np.float32)


class OnnxRuntimeBackend:
    """RuntimeBackend over an ONNX session (held behind a lock like the
    reference's Mutex, model_runtime.rs:200-202), on `device`: "cuda" (the
    default) or "cpu"."""

    def __init__(self, model_path: str | Path, model_cfg: Wav2Vec2ModelConfig,
                 device: str | torch.device = "cuda",
                 providers: list[str] | None = None, allow_embedded: bool = True):
        if not Path(model_path).exists():
            raise RuntimeBackendError("onnx runtime", f"model not found: {model_path}")
        self.model_cfg = model_cfg
        self.configured_precision = precision_from_config(
            getattr(model_cfg, "dtype", None)
        )
        try:
            self.device = torch.device(device)
        except (RuntimeError, TypeError):
            raise RuntimeBackendError(
                "onnx device", f"unsupported ONNX device '{device}', expected 'cpu' or 'cuda'"
            ) from None
        chain = execution_providers(self.device.type)  # validates the label
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeBackendError(
                "onnx runtime", "CUDA device requested but none is available")
        self._lock = threading.Lock()
        try:
            import onnxruntime as ort
        except ImportError as e:
            if not allow_embedded:
                raise RuntimeBackendError(
                    "onnx runtime",
                    "onnxruntime is not installed; install it or use the "
                    "default torch backend (TorchRuntimeBackend)",
                ) from e
            from ..onnx.reference_runtime import EmbeddedOnnxSession

            try:
                self._session = EmbeddedOnnxSession(model_path, device=self.device)
            except Exception as emb_err:
                raise RuntimeBackendError(
                    "onnx runtime",
                    f"onnxruntime is not installed and the embedded "
                    f"session cannot run this model: {emb_err}",
                ) from emb_err
        else:
            self._session = ort.InferenceSession(
                str(model_path),
                providers=providers if providers is not None else chain,
            )
            given = list(self._session.get_providers())
            if self.device.type == "cuda" and given[:1] != ["CUDAExecutionProvider"]:
                raise RuntimeBackendError(
                    "onnx runtime",
                    f"CUDA was asked for, but onnxruntime runs this session on "
                    f"{given}; install onnxruntime-gpu or pass device='cpu'",
                )
        self._input_name = self._session.get_inputs()[0].name
        self._warned_precision_mismatch = False
        logger.info(
            "wav2vec2 ONNX runtime loaded: model=%s device=%s providers=%s "
            "configured_precision=%s",
            model_path, self.device, self._session.get_providers(),
            self.configured_precision or "unspecified",
        )

    def _run(self, normalized: np.ndarray, profiled: bool) -> ForwardOutput:
        audio = np.asarray(normalized, dtype=np.float32)[None, :]
        t0 = time.perf_counter() if profiled else 0.0
        with self._lock:
            (logits,) = self._session.run(None, {self._input_name: audio})
        forward_ms = (time.perf_counter() - t0) * 1000.0 if profiled else 0.0

        t0 = time.perf_counter() if profiled else 0.0
        raw_f32, precision = extract_raw_logits_f32(logits)
        if (
            self.configured_precision is not None
            and precision != self.configured_precision
            and not self._warned_precision_mismatch
        ):
            logger.warning(
                "ONNX logits precision %s does not match configured dtype %s",
                precision, self.configured_precision,
            )
            self._warned_precision_mismatch = True
        t_len, vocab = parse_onnx_output_shape(raw_f32.shape)
        log_probs = raw_logits_to_log_probs(raw_f32.reshape(t_len, vocab))
        if self.device.type == "cuda":
            log_probs = torch.from_numpy(log_probs).to(self.device)
            if profiled:
                self.synchronize()
        post_ms = (time.perf_counter() - t0) * 1000.0 if profiled else 0.0
        return ForwardOutput(
            log_probs=log_probs, t_len=t_len, vocab_size=vocab,
            dtype=precision, forward_ms=forward_ms, post_ms=post_ms,
        )

    def infer(self, normalized: np.ndarray) -> ForwardOutput:
        return self._run(normalized, profiled=False)

    def infer_profiled(self, normalized: np.ndarray) -> ForwardOutput:
        """Timed variant: forward_ms wraps session.run (which returns host
        arrays, so it ends with the device's work), post_ms the precision
        extraction, the host log-softmax and, on the card, the copy back."""
        return self._run(normalized, profiled=True)

    def synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def device_label(self) -> str:
        providers = self._session.get_providers()
        return f"onnx:{providers[0] if providers else 'unknown'}"
