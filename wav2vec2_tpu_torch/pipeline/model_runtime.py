"""Acoustic model runtime backend on PyTorch.

Counterpart of `wav2vec2_tpu.pipeline.model_runtime.JaxRuntimeBackend`:
safetensors weights load (with the port's own reader) into the port's
parameter tree on the device, the forward + log-softmax run there, and the
log-probs stay on the device for the Viterbi kernel. Audio is padded to a
multiple of `pad_multiple` samples; padding is exact (masked GroupNorm and
attention), so padded results equal unpadded ones.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from ..config import Wav2Vec2Config, Wav2Vec2ModelConfig
from ..errors import RuntimeBackendError
from ..models.ctc_model import log_softmax_logits, wav2vec2_forward
from ..models.params import cast_compute_weights_bf16, params_to_device
from .traits import ForwardOutput

DEFAULT_PAD_MULTIPLE = 4000  # 0.25 s at 16 kHz

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class TorchRuntimeBackend:
    """wav2vec2 forward on a torch device ("cuda" or "cpu")."""

    def __init__(
        self,
        model_cfg: Wav2Vec2ModelConfig,
        params: dict,
        compute_dtype: str = "float32",
        pad_multiple: int = DEFAULT_PAD_MULTIPLE,
        device: str | torch.device = "cuda",
    ):
        if compute_dtype not in _DTYPES:
            raise RuntimeBackendError(
                "load model", f"unsupported compute dtype {compute_dtype!r}"
            )
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeBackendError("load model", "CUDA device requested but none is available")
        self.model_cfg = model_cfg
        self.compute_dtype = compute_dtype
        self._dtype = _DTYPES[compute_dtype]
        params = params_to_device(params, self.device)
        if compute_dtype == "bfloat16":
            params = cast_compute_weights_bf16(params)
        self.params = params
        self.pad_multiple = int(pad_multiple)

    @classmethod
    def from_config(cls, config: Wav2Vec2Config, model_cfg: Wav2Vec2ModelConfig, **kw):
        from ..models.params import load_safetensors_params

        path = Path(config.model_path)
        if not path.exists():
            raise RuntimeBackendError("load model", f"weights not found: {path}")
        dtype = model_cfg.dtype or "float32"
        if dtype in ("float16", "f16", "bf16"):
            dtype = "bfloat16"
        device = kw.pop("device", config.device)
        params = load_safetensors_params(path, model_cfg, device=device)
        return cls(model_cfg, params, compute_dtype=kw.pop("compute_dtype", dtype),
                   device=device, **kw)

    def _padded(self, normalized: np.ndarray) -> tuple[torch.Tensor, torch.Tensor, int]:
        n = int(np.shape(normalized)[-1])
        n_pad = -(-n // self.pad_multiple) * self.pad_multiple
        audio = np.zeros((1, n_pad), np.float32)
        audio[0, :n] = normalized
        return (torch.from_numpy(audio).to(self.device),
                torch.tensor([n], dtype=torch.int32, device=self.device), n)

    @torch.inference_mode()
    def infer(self, normalized: np.ndarray) -> ForwardOutput:
        audio, lens, n = self._padded(normalized)
        logits = wav2vec2_forward(self.params, audio, self.model_cfg,
                                  audio_lens=lens, compute_dtype=self._dtype)
        return ForwardOutput(
            log_probs=log_softmax_logits(logits)[0],  # [T_pad, V] on the device
            t_len=self.model_cfg.conv_output_length(n),
            vocab_size=self.model_cfg.vocab_size,
            dtype=self.compute_dtype,
        )

    @torch.inference_mode()
    def infer_profiled(self, normalized: np.ndarray) -> ForwardOutput:
        audio, lens, n = self._padded(normalized)
        self.synchronize()
        t0 = time.perf_counter()
        logits = wav2vec2_forward(self.params, audio, self.model_cfg,
                                  audio_lens=lens, compute_dtype=self._dtype)
        self.synchronize()
        forward_ms = (time.perf_counter() - t0) * 1000.0
        t0 = time.perf_counter()
        log_probs = log_softmax_logits(logits)[0]
        self.synchronize()
        post_ms = (time.perf_counter() - t0) * 1000.0
        return ForwardOutput(
            log_probs=log_probs,
            t_len=self.model_cfg.conv_output_length(n),
            vocab_size=self.model_cfg.vocab_size,
            dtype=self.compute_dtype,
            forward_ms=forward_ms,
            post_ms=post_ms,
        )

    def synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def device_label(self) -> str:
        if self.device.type == "cuda":
            return f"cuda:{torch.cuda.get_device_name(self.device)}"
        return self.device.type
