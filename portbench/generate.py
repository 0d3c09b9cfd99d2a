"""The one traffic generator: makes a mix's inputs from the seed.

A mix (`traffic/<mix>.json`, read by `manifest.traffic`) names the entry
it drives (`entry`) and its parameters. The work is the same for every
seed: the lengths are quantiles (i + 0.5) / n of the mix's distribution,
the transcript of the i-th quantile and the order of the pool and of each
pass over it are drawn from streams that the seed does not touch. The
seed draws the audio. Under bucketing the order decides the batches and
their padding, so a seeded order would change the work: every seed sends
the same sequence of utterances, and a seed the same audio every time.

Audio is int16-valued noise (the samples a 16-bit decoder gives, as f32
in [-1, 1)), drawn on the device in one call and copied to the host once.
"""

from __future__ import annotations

import statistics
from dataclasses import dataclass

import numpy as np

SAMPLE_RATE = 16000


def quantile_lengths(spec: dict, n: int) -> np.ndarray:
    """n lengths (seconds), ascending, at fixed quantiles of `spec`:
    {"dist": "lognormal", "mean", "sigma", "min", "max"} (clipped to
    [min, max], the median chosen so that the n lengths average `mean`)
    or {"dist": "uniform", "min", "max"}."""
    if spec["dist"] == "uniform":
        if n == 1:
            return np.array([0.5 * (spec["min"] + spec["max"])])
        return np.linspace(spec["min"], spec["max"], n)
    if spec["dist"] == "lognormal":
        z = np.array([statistics.NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])

        def at(median):
            return np.clip(median * np.exp(spec["sigma"] * z), spec["min"], spec["max"])

        lo, hi = spec["min"], spec["max"]
        for _ in range(100):  # the clipped mean grows with the median
            mid = 0.5 * (lo + hi)
            lo, hi = (mid, hi) if at(mid).mean() < spec["mean"] else (lo, mid)
        return at(0.5 * (lo + hi))
    raise ValueError(f"unknown length distribution {spec['dist']!r}")


@dataclass
class Item:
    """One utterance: f32 samples, the transcript, its words."""

    audio: np.ndarray
    transcript: str
    n_words: int

    @property
    def seconds(self) -> float:
        return len(self.audio) / SAMPLE_RATE


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2**64, stream])


FIXED = 0x5EED  # the seed of the streams every run shares: transcripts and order


def noise(total: int, seed: int, device) -> np.ndarray:
    """`total` int16-valued noise samples as f32 (σ ≈ 0.1 of full scale),
    drawn on `device` and copied to the host once."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2**63)
    x = torch.empty(total, dtype=torch.float32, device=device)
    x.normal_(0.0, 0.1 * 32768.0, generator=gen)
    x = torch.clamp(torch.round(x), -32768, 32767) / 32768.0
    return x.cpu().numpy()


def transcripts(mix: dict, lengths) -> list[str]:
    """The transcript of each length: round(length × words_per_s) words
    drawn from `words` by a stream of the length's own index, the same for
    every seed."""
    words = mix["words"]
    out = []
    for i, sec in enumerate(lengths):
        n_w = max(1, int(round(sec * mix["words_per_s"])))
        out.append(" ".join(words[j] for j in _rng(FIXED, 3 + i).integers(0, len(words), n_w)))
    return out


def items(mix: dict, seed: int, device) -> list[Item]:
    """The mix's pool: `pool` items whose lengths are quantiles of
    `seconds`, each with its own transcript, in the shared order; the audio
    from `seed`."""
    n = int(mix["pool"])
    lengths = quantile_lengths(mix["seconds"], n)
    texts = transcripts(mix, lengths)
    order = _rng(FIXED, 1).permutation(n)
    n_samples = [int(round(lengths[i] * SAMPLE_RATE)) for i in order]
    audio = noise(sum(n_samples), seed, device)
    out, at = [], 0
    for i, n_s in zip(order, n_samples):
        out.append(Item(audio=audio[at: at + n_s], transcript=texts[i],
                        n_words=len(texts[i].split())))
        at += n_s
    return out


def cycle_order(n: int, cycle: int) -> np.ndarray:
    """The pool's order in its `cycle`-th pass: a fresh permutation each
    pass, the same for every seed."""
    return _rng(FIXED, 1_000_000 + cycle).permutation(n)
