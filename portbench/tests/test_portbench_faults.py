"""A whole run on the CPU at a tiny size (the look for a card skipped),
sound and with the timed path broken underneath: `correct` holds for the
sound run and comes out false for each fault a cell can have — a path, an
answer or the evidence altered where it is produced, half of each batch's
rows left out."""

from __future__ import annotations

import pytest
import torch

from portbench import run

SEED = 2**31 + 99


def _run(cell):
    result, _ = run.run(cell, SEED, 4.0, False, device="cpu")
    return result


@pytest.mark.parametrize("cell", ["base.batch", "conformer.batch"])
def test_sound_run_is_correct(tiny, cell):
    result = _run(cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0


def _break_paths(monkeypatch):
    """Every path the DP produces held one frame in its first state too
    long (the last state dropped)."""
    from wav2vec2_tpu_torch.ops import viterbi_cuda

    batch, single = viterbi_cuda.viterbi_batch, viterbi_cuda.viterbi_single

    def shift(paths):
        return torch.cat([paths[..., :1], paths[..., :-1]], dim=-1)

    monkeypatch.setattr(viterbi_cuda, "viterbi_batch", lambda *a, **k: shift(batch(*a, **k)))
    from wav2vec2_tpu_torch.ops import evidence

    monkeypatch.setattr(evidence.viterbi_cuda, "viterbi_single",
                        lambda *a, **k: shift(single(*a, **k)))


def _alter_answer(monkeypatch):
    """The grouping's first word ends one frame later than it does."""
    from wav2vec2_tpu_torch.parallel import batching

    group = batching.group_into_words

    def altered(*a, **k):
        words = group(*a, **k)
        if words:
            words[0].end_ms += 20
        return words

    monkeypatch.setattr(batching, "group_into_words", altered)


def _alter_evidence(monkeypatch):
    """The emission log-probs handed back from the device off by 0.5."""
    from wav2vec2_tpu_torch.ops import evidence

    batch = evidence.evidence_batch

    def off(*a, **k):
        emit, *rest = batch(*a, **k)
        return (emit - 0.5, *rest)

    from wav2vec2_tpu_torch.parallel import batching

    monkeypatch.setattr(batching, "evidence_batch", off)
    single = evidence.evidence_single
    monkeypatch.setattr(evidence, "evidence_single",
                        lambda *a, **k: (lambda e: (e[0] - 0.5, *e[1:]))(single(*a, **k)))


def _half_batch(monkeypatch):
    """Each batch's second half of rows never reaches the grouping: its
    utterances come back with no words."""
    from wav2vec2_tpu_torch.parallel import batching

    group = batching.BatchAligner.group_batch

    def half(self, seqs, handles):
        out = group(self, seqs, handles)
        keep = (len(out) + 1) // 2
        return out[:keep] + [batching.AlignmentOutput(words=[]) for _ in out[keep:]]

    monkeypatch.setattr(batching.BatchAligner, "group_batch", half)


FAULTS = {"path": _break_paths, "answer": _alter_answer, "evidence": _alter_evidence,
          "half_batch": _half_batch}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", ["base.batch", "conformer.batch"])
def test_each_fault_fails_the_check(tiny, monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch)
    assert not _run(cell)["correct"]
