"""Kaldi-style log-mel frontend of Wav2Vec2-BERT (w2v-BERT 2.0).

PyTorch counterpart of `wav2vec2_tpu.models.mel`, with the same spec
(SeamlessM4TFeatureExtractor): waveform × 2¹⁵, 25 ms / 10 ms povey frames
(center=False), per-frame DC-offset removal then preemphasis 0.97, the
512-point power spectrum, 80 kaldi-scale mel filters (triangular in mel
space, floor 2⁻²³, natural log), per-bin utterance mean / variance
normalization (ddof=1), and stride-2 frame stacking to [T, 160].

DC removal, preemphasis and the window are linear per-frame operators, so
they are folded on the host in f64 into the real and imaginary DFT
matrices (`build_mel_matrices`, the same constants as the JAX package's):
the device does one [B·T, 400] frame view, one [400, 2·257] matmul, the
power, one [257, 80] mel matmul and a log. A padded batch takes masked
per-bin statistics, so it equals each utterance alone.

Precision: the matmuls run in f32 whatever the compute dtype, on powers up
to ~10¹³; TF32 or bf16 there would move the log-mel by far more than the
parity bound. `mel_frontend` turns TF32 off for its own matmuls and checks
that PyTorch reports full f32 precision before it runs them.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .layers import full_f32_precision

_FRAME = 400
_HOP = 160
_FFT = 512
_BINS = _FFT // 2 + 1
_PREEMPH = 0.97
_MEL_FLOOR = 1.192092955078125e-07  # 2^-23 (kaldi)


def _hertz_to_mel_kaldi(freq):
    return 1127.0 * np.log(1.0 + np.asarray(freq, np.float64) / 700.0)


def kaldi_mel_filter_bank(
    num_mel: int = 80, min_hz: float = 20.0, max_hz: float = 8000.0,
    sampling_rate: int = 16000, num_bins: int = _BINS,
) -> np.ndarray:
    """[num_bins, num_mel] triangular filters built in mel space
    (transformers mel_filter_bank(norm=None, mel_scale="kaldi",
    triangularize_in_mel_space=True))."""
    mel_pts = np.linspace(
        _hertz_to_mel_kaldi(min_hz), _hertz_to_mel_kaldi(max_hz), num_mel + 2
    )
    fft_bin_width = sampling_rate / ((num_bins - 1) * 2)
    fft_mels = _hertz_to_mel_kaldi(fft_bin_width * np.arange(num_bins))
    slopes = mel_pts[None, :] - fft_mels[:, None]  # [bins, num_mel+2]
    down = -slopes[:, :-2] / np.diff(mel_pts)[None, :-1]
    up = slopes[:, 2:] / np.diff(mel_pts)[None, 1:]
    return np.maximum(0.0, np.minimum(down, up))


def _povey_window(n: int = _FRAME) -> np.ndarray:
    return np.power(np.hanning(n), 0.85)


def build_mel_matrices(num_mel: int = 80, sampling_rate: int = 16000):
    """(cos_mat [400, 257], sin_mat [400, 257], mel_fb [257, M]) in f32.

    The per-frame linear chain — DC removal (I − 1/400·𝟙𝟙ᵀ), preemphasis
    (bidiagonal, first sample scaled by 1−α), povey window (diagonal) — is
    composed with the 512-point real-DFT basis in f64 on the host, so the
    device computes power[k] = (f·cos_k)² + (f·sin_k)² from raw frames."""
    w = _povey_window()
    # A = diag(w) @ P @ M_dc, applied as frame-vector · Aᵀ
    m_dc = np.eye(_FRAME) - np.full((_FRAME, _FRAME), 1.0 / _FRAME)
    p = np.eye(_FRAME)
    p[0, 0] = 1.0 - _PREEMPH
    idx = np.arange(1, _FRAME)
    p[idx, idx - 1] = -_PREEMPH
    a = (w[:, None] * p) @ m_dc  # [400, 400]
    n = np.arange(_FRAME)[:, None]
    k = np.arange(_BINS)[None, :]
    ang = -2.0 * math.pi * n * k / _FFT
    cos_mat = a.T @ np.cos(ang)  # [400, 257]
    sin_mat = a.T @ np.sin(ang)
    fb = kaldi_mel_filter_bank(num_mel, sampling_rate=sampling_rate)
    return (cos_mat.astype(np.float32), sin_mat.astype(np.float32),
            fb.astype(np.float32))


def num_mel_frames(n_samples: int) -> int:
    """Unstacked 10 ms frame count (center=False): 1 + ⌊(N−400)/160⌋."""
    if n_samples < _FRAME:
        return 0
    return 1 + (n_samples - _FRAME) // _HOP


_CONST_CACHE: dict = {}


def _mel_consts(num_mel: int):
    if num_mel not in _CONST_CACHE:
        _CONST_CACHE[num_mel] = build_mel_matrices(num_mel)
    return _CONST_CACHE[num_mel]


@functools.lru_cache(maxsize=8)
def _device_consts(num_mel: int, device: torch.device):
    """([400, 2·257] DFT matrix, [257, M] filter bank) on `device`, copied
    there once."""
    cos_mat, sin_mat, fb = _mel_consts(num_mel)
    dft = np.concatenate([cos_mat, sin_mat], axis=1)
    return torch.from_numpy(dft).to(device), torch.from_numpy(fb).to(device)


def mel_frontend(audio: torch.Tensor, cfg, audio_lens: torch.Tensor | None = None):
    """audio [B, N] (normalized or raw waveform) → (features [B, T, 2·M] f32,
    feat_lens [B] or None), T = num_mel_frames(N) // 2.

    A waveform's gain and offset cancel through the chain (DC removal
    takes the offset; the per-bin mean takes the log of the gain), so the
    pipeline's normalization before it changes nothing but where the 2⁻²³
    floor sits. With `audio_lens` the statistics cover each utterance's
    valid frames and its padded frames are set to 0 (HF's padding value)."""
    num_mel = cfg.feature_projection_input_dim // 2
    b, n = audio.shape
    t_mel = num_mel_frames(n)
    t_out = t_mel // 2
    if t_out == 0:
        raise ValueError(f"audio too short for the mel frontend: {n} samples")
    dft, fb = _device_consts(num_mel, audio.device)
    with full_f32_precision():
        if audio.device.type == "cuda" and torch.get_float32_matmul_precision() != "highest":
            raise RuntimeError(
                "the mel frontend needs full f32 matmuls, but PyTorch reports "
                f"float32 matmul precision {torch.get_float32_matmul_precision()!r}")
        # kaldi compliance: 16-bit-signed scaling before framing
        x = audio.float() * 32768.0
        frames = x.unfold(1, _FRAME, _HOP)  # [B, T_mel, 400], a view
        spec = torch.matmul(frames, dft)  # [B, T_mel, 2·257]
        power = spec[..., :_BINS].square() + spec[..., _BINS:].square()
        del spec
        logmel = torch.log(torch.clamp(torch.matmul(power, fb), min=_MEL_FLOOR))
    del power
    if audio_lens is None:
        mean = logmel.mean(dim=1, keepdim=True)
        var = (logmel - mean).square().sum(dim=1, keepdim=True) / max(t_mel - 1, 1)
        normed = (logmel - mean) / torch.sqrt(var + 1e-7)
        feat_lens = None
    else:
        lens_mel = torch.clamp(1 + torch.div(audio_lens - _FRAME, _HOP, rounding_mode="floor"),
                               0, t_mel)
        m = (torch.arange(t_mel, device=audio.device)[None, :]
             < lens_mel[:, None])[:, :, None].float()
        denom = torch.clamp(lens_mel, min=1)[:, None, None].float()
        mean = (logmel * m).sum(dim=1, keepdim=True) / denom
        var = ((logmel - mean) * m).square().sum(dim=1, keepdim=True) / (
            torch.clamp(lens_mel - 1, min=1)[:, None, None].float())
        normed = (logmel - mean) / torch.sqrt(var + 1e-7) * m  # padded frames → 0
        feat_lens = torch.div(lens_mel, 2, rounding_mode="floor")
    # stride-2 stacking: [B, T_mel, M] → [B, T_mel // 2, 2M]
    return normed[:, : t_out * 2].reshape(b, t_out, 2 * num_mel), feat_lens
