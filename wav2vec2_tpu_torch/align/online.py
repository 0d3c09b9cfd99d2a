"""Online (incremental) forced alignment for live audio feeds
(counterpart of `wav2vec2_tpu.align.online`).

Feed audio in arbitrary-size pieces as it arrives and receive words as
they become FINAL: the live-captioning / karaoke / teleprompter use case
where the script is known.

Design (the JAX package's, reusing the long-form machinery):
- audio accumulates into fixed-size overlapping encoder windows
  (`chunk_sec` + `overlap_sec`); each window runs through the forward on
  the device at B=1 and its log-probs come back to the host, where they
  are adopted up to the depth-crossover with the next window (the same
  deepest-context stitching rule as offline long-form);
- adopted frames extend an incremental banded Viterbi on the host
  (`IncrementalViterbi`, host numpy, a copy of the JAX class: append-only
  score row + backpointer rows; path-identical to the numpy oracle);
- after each window, the full provisional path is grouped with the
  standard pipeline and words that ended more than `finalize_margin_sec`
  before the adopted frontier are emitted as final; `flush()` processes
  the tail and emits the rest.

Finalized words never change once emitted, and results are independent of
how the audio is sliced into push() calls. The window forward is one
function per (config, compute dtype), shared by every session of the
process; it runs under `torch.inference_mode()` itself, since that mode is
per thread and sessions push from the serving daemon's handler threads.
For the conformer rel-pos family with the config's kernel switch on, each
window's attention runs the fused kernel K5 at B=1.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..config import AlignerHyperParams, Wav2Vec2ModelConfig
from ..errors import InvalidInputError
from ..models.ctc_model import log_softmax_logits, wav2vec2_forward
from ..models.params import params_to_device
from ..types import AlignmentOutput, WordTiming
from ..utils.device import select_device
from .grouping import frame_evidence_from_log_probs, group_into_words
from .grouping.phoneme import group_into_phonemes
from .tokenization import (
    build_token_sequence_case_aware,
    build_token_sequence_phoneme,
)

_NEG = np.float32(-np.inf)


_WINDOW_FORWARDS_MAX = 32
_window_forwards: dict = {}
_window_forwards_lock = threading.Lock()


def _shared_window_forward(cfg, dtype):
    """One window forward per (config, dtype), shared by every
    OnlineAligner session in the process (at most 32 kept, oldest dropped
    first, as the JAX package's lru_cache). It runs under
    `torch.inference_mode()` inside, since the mode is per thread."""
    key = (repr(cfg), dtype)
    with _window_forwards_lock:
        fwd = _window_forwards.get(key)
        if fwd is None:
            def fwd(p, audio, n):
                with torch.inference_mode():
                    logits = wav2vec2_forward(
                        p, audio, cfg, audio_lens=n, compute_dtype=dtype
                    )
                    return log_softmax_logits(logits)

            _window_forwards[key] = fwd
            while len(_window_forwards) > _WINDOW_FORWARDS_MAX:
                _window_forwards.pop(next(iter(_window_forwards)))
        return fwd


class IncrementalViterbi:
    """Append-only CTC Viterbi: one score row + per-frame backpointers.

    Transition rules, tie-breaking (stay > s-1 > s-2 on strict
    improvement), and the final-state rule replicate the offline oracle
    (ops/viterbi_ref.viterbi_numpy) — verified path-identical in tests.
    """

    def __init__(self, tokens: np.ndarray):
        self.tokens = np.asarray(tokens, np.int64)
        s = len(self.tokens)
        self.s_len = s
        self.prev = np.full(s, _NEG, np.float32)
        self.bp: list[np.ndarray] = []
        self.t = 0
        # skip transition allowed only when tokens differ two apart
        self._can_skip = np.zeros(s, bool)
        if s > 2:
            self._can_skip[2:] = self.tokens[2:] != self.tokens[:-2]

    def append(self, lp_row: np.ndarray) -> None:
        emis = lp_row[self.tokens].astype(np.float32)
        if self.t == 0:
            self.prev[0] = emis[0]
            if self.s_len > 1:
                self.prev[1] = emis[1]
            self.bp.append(np.zeros(self.s_len, np.int8))
        else:
            stay = self.prev
            from1 = np.full(self.s_len, _NEG, np.float32)
            from1[1:] = self.prev[:-1]
            from2 = np.full(self.s_len, _NEG, np.float32)
            from2[2:] = np.where(self._can_skip[2:], self.prev[:-2], _NEG)
            cand = np.stack([stay, from1, from2])
            step = np.argmax(cand, axis=0).astype(np.int8)  # first max wins
            best = cand[step, np.arange(self.s_len)]
            self.bp.append(step)
            self.prev = np.where(np.isneginf(best), _NEG, best + emis)
        self.t += 1

    def backtrace(self) -> np.ndarray:
        """Provisional best path [t] of states ending at the best of the
        two final states (blank vs last char; strict > favors the last
        state, viterbi.rs:90-93)."""
        if self.t == 0:
            return np.zeros(0, np.int64)
        s = self.s_len
        state = s - 1
        if s >= 2 and self.prev[s - 2] > self.prev[s - 1]:
            state = s - 2
        if np.isneginf(self.prev[state]):
            # not enough frames yet to cover the tokens: fall back to the
            # best reachable state so provisional grouping still works
            state = int(np.argmax(self.prev))
        path = np.empty(self.t, np.int64)
        for t in range(self.t - 1, -1, -1):
            path[t] = state
            state -= int(self.bp[t][state])
        return path


class OnlineAligner:
    """Incremental alignment session for ONE utterance/stream."""

    def __init__(
        self,
        model_cfg: Wav2Vec2ModelConfig,
        params: dict,
        vocab: dict[str, int],
        transcript: str,
        chunk_sec: float = 5.0,
        overlap_sec: float = 1.0,
        finalize_margin_sec: float = 2.0,
        sample_rate: int = 16000,
        compute_dtype: str = "float32",
        normalize: str = "window",
        hp: AlignerHyperParams | None = None,
        units: str = "word",
        device: str | torch.device = "cuda",
    ):
        """normalize: "window" (default — per-window zero-mean/unit-var,
        the only option for live input where global stats are unknown) or
        "none" (caller pre-normalized; gives exact agreement with the
        offline path on the same frames).

        units: "word" (default) or "phoneme" — phoneme streams tokenize
        whitespace-separated vocab symbols verbatim and finalize one tight
        unit per phone (same incremental machinery: per-state runs are
        append-only under a stable prefix path exactly like words).

        device: `cuda` unless the caller asks for the CPU (no CUDA device
        raises); the parameters are moved there (a no-op where they
        already are)."""
        self.device = select_device(device)
        self.cfg = model_cfg
        self.hp = hp or AlignerHyperParams()
        self.blank_id = model_cfg.pad_token_id
        self.word_sep_id = vocab.get("|", 0)
        # samples per output frame (mel frontend / adapter aware)
        self.stride = model_cfg.frame_stride_samples()
        self.stride_ms = model_cfg.frame_stride_ms(sample_rate)
        if units not in ("word", "phoneme"):
            raise InvalidInputError(f"unknown units {units!r}")
        self.units = units
        if units == "phoneme":
            self.seq = build_token_sequence_phoneme(
                transcript, vocab, self.blank_id, self.word_sep_id
            )
        else:
            self.seq = build_token_sequence_case_aware(
                transcript, vocab, self.blank_id, self.word_sep_id
            )
        self.dp = IncrementalViterbi(np.asarray(self.seq.tokens))

        self.chunk = (int(chunk_sec * sample_rate) // self.stride) * self.stride
        ov = (int(overlap_sec * sample_rate) // self.stride) * self.stride
        # real exceptions, not asserts: these validate CALLER input (e.g.
        # the serving daemon's client-supplied knobs) and must survive -O
        if not 0 < ov < self.chunk:
            raise InvalidInputError("need 0 < overlap_sec < chunk_sec")
        self.hop = self.chunk - ov
        # consecutive windows must overlap in FRAMES too: the conv stack's
        # receptive field eats ~(chunk/stride - conv_output_length(chunk))
        # frames off each window, so a too-small overlap would leave a gap
        # of frames no window produces (and silently desync the DP)
        if self.hop // self.stride >= model_cfg.conv_output_length(self.chunk):
            raise InvalidInputError(
                "overlap_sec too small for the model's receptive field"
            )
        self.margin_frames = int(finalize_margin_sec * 1000 / self.stride_ms)

        dtype = torch.float32 if compute_dtype == "float32" else torch.bfloat16
        # the window forward is SHARED across sessions with the same
        # (cfg, dtype) (the serving daemon opens many sessions)
        self._fwd = _shared_window_forward(self.cfg, dtype)
        self._params = params_to_device(params, self.device)

        self._normalize = normalize
        self._buf = np.zeros(0, np.float32)
        self._buf_base = 0         # samples dropped from the front of _buf
        self._next_start = 0       # sample index of the next window
        self._pending: tuple[np.ndarray, int] | None = None  # (lp, f0)
        self._lp = np.zeros((0, model_cfg.vocab_size), np.float32)
        self._n_rows = 0           # adopted frames (rows of _lp in use)
        self._last_finalized_at = 0
        self._emitted: list[WordTiming] = []
        self._closed = False

    # -- internals --------------------------------------------------------

    def _window_logprobs(self, start: int, true_len: int) -> np.ndarray:
        """Run the fixed-shape forward on window [start, start+chunk);
        true_len ≤ chunk masks the tail (flush's last window)."""
        audio = np.zeros(self.chunk, np.float32)
        b = start - self._buf_base
        avail = self._buf[b : b + true_len]
        audio[: len(avail)] = avail
        if self._normalize == "window" and len(avail):
            # per-stream normalization is global in the offline path;
            # online normalizes per window (live input has no global stats)
            mean = float(avail.mean())
            std = max(float(avail.std()), 1e-7)
            audio = (audio - mean) / std
            audio[len(avail):] = 0.0
        lp = self._fwd(
            self._params, torch.from_numpy(audio[None, :]).to(self.device),
            torch.tensor([len(avail)], dtype=torch.int32, device=self.device),
        )
        t_true = self.cfg.conv_output_length(len(avail))
        return lp[0, :t_true].float().cpu().numpy()

    def _append_row(self, row: np.ndarray) -> None:
        if self._n_rows == self._lp.shape[0]:
            cap = max(256, 2 * self._lp.shape[0])
            grown = np.zeros((cap, self._lp.shape[1]), np.float32)
            grown[: self._n_rows] = self._lp[: self._n_rows]
            self._lp = grown
        self._lp[self._n_rows] = row
        self._n_rows += 1
        self.dp.append(row)

    def _adopt(self, upto_f: int) -> None:
        """Append pending-window rows for global frames [n_rows, upto_f)
        to the DP."""
        if self._pending is None:
            return
        lp, f0 = self._pending
        for g in range(self._n_rows, upto_f):
            local = g - f0
            if local < 0:
                raise RuntimeError(
                    "frame gap between windows (overlap too small)"
                )
            if local < lp.shape[0]:
                self._append_row(lp[local])

    def _crossover(self, f0_a: int, n_a: int, f0_b: int, n_b: int) -> int:
        """First global frame the NEXT window owns — stitch_log_probs'
        deepest-context rule including both windows' edge depths and the
        earlier-window-wins tie break (strict >)."""
        for g in range(f0_b, f0_a + n_a):
            depth_a = min(g - f0_a, n_a - 1 - (g - f0_a))
            depth_b = min(g - f0_b, n_b - 1 - (g - f0_b))
            if depth_b > depth_a:
                return g
        return f0_a + n_a

    def _finalize(self, cut_frame: int) -> list[WordTiming]:
        self._last_finalized_at = self._n_rows
        t = self.dp.t
        if t == 0 or not self.seq.normalized_words:
            return []
        path = self.dp.backtrace()
        lp_all = self._lp[: self._n_rows]
        ev = frame_evidence_from_log_probs(
            lp_all, self.seq.tokens, path, self.blank_id
        )
        if self.units == "phoneme":
            words = group_into_phonemes(
                path, self.seq, ev, self.blank_id, self.word_sep_id,
                self.stride_ms,
            )
        else:
            words = group_into_words(
                path, self.seq.tokens, self.seq.chars,
                self.seq.normalized_words, ev, self.blank_id,
                self.word_sep_id, self.stride_ms, self.hp,
            )
        cut_ms = cut_frame * self.stride_ms
        out = []
        k = len(self._emitted)
        for w in words[k:]:
            if w.end_ms >= cut_ms:
                break
            out.append(w)
        self._emitted.extend(out)
        return out

    # -- public API -------------------------------------------------------

    def _ingest_window(self, start: int, true_len: int) -> None:
        lp = self._window_logprobs(start, true_len)
        f0 = start // self.stride
        if self._pending is not None:
            lp_a, f0_a = self._pending
            self._adopt(self._crossover(f0_a, lp_a.shape[0], f0, lp.shape[0]))
        self._pending = (lp, f0)

    def warmup(self) -> None:
        """Run one window before the stream starts, so the first real push
        never pays the first use inside its latency (cuDNN's algorithm
        choice, the kernel library's load and, for the conformer, K5's
        first launch). Does not consume audio."""
        saved, saved_base = self._buf, self._buf_base
        self._buf, self._buf_base = np.zeros(self.chunk, np.float32), 0
        self._window_logprobs(0, self.chunk)
        self._buf, self._buf_base = saved, saved_base

    def push(self, samples: np.ndarray) -> list[WordTiming]:
        """Feed more audio; returns newly FINALIZED words (possibly [])."""
        if self._closed:
            raise RuntimeError("push after flush")
        self._buf = np.concatenate([self._buf, np.asarray(samples, np.float32)])
        progressed = False
        while self._buf_base + len(self._buf) >= self._next_start + self.chunk:
            self._ingest_window(self._next_start, self.chunk)
            self._next_start += self.hop
            progressed = True
        # samples before the next window's start are never read again —
        # keep the buffer bounded at ~one window regardless of stream length
        drop = self._next_start - self._buf_base
        if drop > 0:
            self._buf = self._buf[drop:]
            self._buf_base = self._next_start
        if not progressed:
            return []
        # the pending window's left half (deepest context) is stable
        lp, f0 = self._pending
        self._adopt(f0 + lp.shape[0] // 2)
        # amortize: grouping the full provisional path is O(T); doing it on
        # every push would make long streams O(T²), so finalize only after
        # at least half a margin of new frames
        if self._n_rows - self._last_finalized_at < max(1, self.margin_frames // 2):
            return []
        return self._finalize(self._n_rows - self.margin_frames)

    def flush(self) -> AlignmentOutput:
        """End of stream: process the tail, emit everything, and return the
        COMPLETE alignment (all words, including those already emitted)."""
        if self._closed:
            raise RuntimeError("double flush")
        self._closed = True
        n_total = self._buf_base + len(self._buf)
        while n_total >= self._next_start + self.chunk:
            self._ingest_window(self._next_start, self.chunk)
            self._next_start += self.hop
        tail = n_total - self._next_start
        if tail > 0:
            self._ingest_window(self._next_start, tail)
        if self._pending is not None:
            lp, f0 = self._pending
            self._adopt(f0 + lp.shape[0])
        if self.seq.normalized_words:
            min_frames = -(-len(self.seq.tokens) // 2)
            if self._n_rows < min_frames:
                # same contract as the offline min-frames guard
                # (runtime.rs:116-121): the transcript cannot fit the audio
                raise InvalidInputError(
                    f"audio too short for transcript: {self._n_rows} "
                    f"frames < {min_frames} required"
                )
        # emit EVERYTHING: a frame-count cut converts to ms and the tight
        # units' min-1-ms-width rule can push the final unit's end_ms to
        # exactly (n_rows+1)·stride_ms at sub-ms frame strides, which the
        # `end_ms >= cut_ms` test would drop
        self._finalize(float("inf"))
        return AlignmentOutput(words=list(self._emitted))
