"""Whether what the timed path produced is correct: each judged item's
captured path, evidence and words against the plain reference, recomputed
from the same audio, transcript and weights after the window.

Numbers compared (the worst over the judged items):
- `emit_err`: mean over frames of |the program's emission log-prob − the
  reference's log-prob of the same state| (the forward, K5 inside it);
- `evid_err`: the largest of the mean |Δ| of the margin, the blank
  probability and the entropy, program against reference (the evidence);
- `dp_diff`: frames where the program's path differs from the reference's
  best path over the program's own log-probs (the DP: K1 to K4, exact: the
  same f32 sums and the same order of ties); tokens that differ from the
  reference's read `FAR`. This follows the program from its own state;
  the log-probs it starts from are judged by `emit_err`;
- `words_diff`: words the program returned that differ from the
  reference's grouping of the program's own path and evidence (word,
  start_ms, end_ms, or confidence by more than 1e-6) — the grouping, which
  follows the program's path step by step; the path and evidence are
  judged above — and in the first answer the caller was handed for the
  item; and each later answer for it that is none of the words its
  groupings made in the window (an utterance fed again goes out in another
  batch, whose bf16 sums may differ);
- `missing`: 1 where the window grouped nothing to judge, or completed
  nothing; and one for each judged item its caller was never handed.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference import forward, grouping, viterbi
from .reference.text import tokenize

NUMBERS = ("emit_err", "evid_err", "dp_diff", "words_diff", "missing")
FAR = 1e30  # what a path over other tokens or a non-finite reading reads


def reference_log_probs(ctx, item, quant=None) -> torch.Tensor:
    return forward.log_probs(ctx.params, item.audio, ctx.cfg, quant=quant, device=ctx.device)


def judge(ctx, judged: dict, captured: dict, answers: dict, outputs: dict,
          log_probs=reference_log_probs) -> dict:
    """{number: worst value} over the judged items ({key: item}); `answers`
    ({key: [words]}) is what the caller was handed for each, in order,
    `outputs` ({key: [words]}) what its groupings returned."""
    worst = dict(emit_err=0.0, evid_err=0.0, dp_diff=0, words_diff=0, missing=int(not judged))
    stride_ms = 1000.0 * float(np.prod(ctx.cfg["conv_stride"])) / 16000.0
    for key, item in judged.items():
        got = captured[key]
        seq = tokenize(item.transcript, ctx.vocab, ctx.blank_id, ctx.word_sep_id)
        lp = log_probs(ctx, item).cpu().numpy()
        path = got["path"]
        if list(got["tokens"]) != list(seq.tokens) or len(path) != lp.shape[0]:
            worst["dp_diff"] = FAR
            continue
        best = viterbi.best_path(got["log_probs"], seq.tokens)
        worst["dp_diff"] += int((best != path).sum())
        ref_ev = grouping.frame_evidence_from_log_probs(lp, seq.tokens, path, ctx.blank_id)
        worst["emit_err"] = max(worst["emit_err"], _mean_abs(got["emit_lp"], ref_ev.emit_lp))
        worst["evid_err"] = max(worst["evid_err"],
                                _mean_abs(got["margin"], ref_ev.margin),
                                _mean_abs(got["blank_prob"], ref_ev.blank_prob),
                                _mean_abs(got["entropy"], ref_ev.entropy))
        ev = grouping.FrameEvidence(emit_lp=got["emit_lp"], margin=got["margin"],
                                    blank_prob=got["blank_prob"], entropy=got["entropy"])
        ref_words = grouping.group_into_words(path, seq.tokens, seq.chars, seq.normalized_words,
                                              ev, ctx.blank_id, ctx.word_sep_id, stride_ms)
        worst["words_diff"] += _words_diff(got["words"], ref_words)
        sent = answers.get(key, [])
        worst["missing"] += not sent
        if sent:
            worst["words_diff"] += _words_diff(sent[0], ref_words)
        worst["words_diff"] += sum(words not in outputs.get(key, []) for words in sent[1:])
    return worst


def _mean_abs(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
        return FAR
    d = np.abs(a - b)
    return float(d.mean()) if np.isfinite(d).all() else FAR


def _words_diff(got: list, ref: list) -> int:
    n = abs(len(got) - len(ref))
    for (word, start, end, conf), w in zip(got, ref):
        same_conf = (conf is None and w.confidence is None) or (
            conf is not None and w.confidence is not None and abs(conf - w.confidence) <= 1e-6)
        n += not (word == w.word and start == w.start_ms and end == w.end_ms and same_conf)
    return n


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number the cell's limits name within its limit (a cell leaves
    out a number that no reading of its control separates from its sound
    runs; PERF.md gives why)."""
    return all(numbers[name] <= limit for name, limit in limits.items())
