"""PyTorch port vs the JAX package: per-frame evidence and bucketing.

Tolerances: the gathers (emit_lp) and the top-2 margin are exact (the same
f32 values selected and subtracted once); exp-based values (blank_prob,
entropy) allow 1e-5 relative (another exp implementation and summation
order). The batches the port's `align_utterances` submits are the JAX
package's `bucket_utterances` buckets, in any order.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from wav2vec2_tpu.ops import evidence as jax_evidence
from wav2vec2_tpu.parallel import batching as jax_batching
from wav2vec2_tpu_torch.config import Wav2Vec2ModelConfig
from wav2vec2_tpu_torch.models.params import init_params, params_from_jax
from wav2vec2_tpu_torch.ops import evidence as torch_evidence
from wav2vec2_tpu_torch.parallel import batching as torch_batching
from wav2vec2_tpu_torch.types import AlignmentOutput

EXP_RTOL = 1e-5
CONFIG = dict(
    model_type="wav2vec2",
    hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
    intermediate_size=64, conv_dim=[16, 16], conv_kernel=[10, 3],
    conv_stride=[5, 2], num_conv_pos_embeddings=16,
    num_conv_pos_embedding_groups=4, pad_token_id=0, vocab_size=32,
    do_stable_layer_norm=False, feat_extract_norm="group", conv_bias=False,
)
VOCAB = {"<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3, "|": 4}
for _i, _c in enumerate("ETAONIHSRDLUMWCFGYPBVKXJQZ"):
    VOCAB[_c] = 5 + _i
WORDS = ["THE", "QUICK", "BROWN", "FOX", "JUMPS", "OVER", "LAZY", "DOG"]


def _inputs(seed, b=3, t=40, v=10, s=16):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, v)).astype(np.float32) * 3
    lp = (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)
    lp[0, 5, :] = -np.inf  # non-finite top-2 → margin 0
    lp[0, 5, 1] = 0.0
    tok = rng.integers(0, v, size=(b, s)).astype(np.int32)
    paths = np.sort(rng.integers(0, s, size=(b, t)), axis=1).astype(np.int32)
    return lp, tok, paths


@pytest.mark.parametrize("seed", range(3))
def test_evidence_batch_matches_jax(seed):
    lp, tok, paths = _inputs(seed)
    want = [np.asarray(x) for x in jax_batching._evidence_batch(
        jnp.asarray(lp), jnp.asarray(tok), jnp.asarray(paths), 0)]
    got = [x.numpy() for x in torch_evidence.evidence_batch(
        torch.from_numpy(lp), torch.from_numpy(tok), torch.from_numpy(paths), 0)]
    np.testing.assert_array_equal(got[0], want[0])  # emit_lp
    np.testing.assert_array_equal(got[1], want[1])  # margin
    assert got[1][0, 5] == 0.0
    np.testing.assert_allclose(got[2], want[2], rtol=EXP_RTOL, atol=0)  # blank_prob
    ok = np.isfinite(want[3])
    np.testing.assert_allclose(got[3][ok], want[3][ok], rtol=EXP_RTOL, atol=1e-6)


def test_single_utterance_evidence_matches_jax_kernel():
    lp, tok, paths = _inputs(4, b=1)
    want = [np.asarray(x) for x in jax_evidence._evidence_kernel(
        jnp.asarray(lp[0]), jnp.asarray(tok[0]), jnp.asarray(paths[0]), 0)]
    got = [x.numpy() for x in torch_evidence.evidence_single(
        torch.from_numpy(lp[0]), torch.from_numpy(tok[0]), torch.from_numpy(paths[0]), 0)]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=EXP_RTOL, atol=0)


def test_fused_path_evidence_matches_jax():
    """DP + evidence with one copy back: same path, same evidence."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(48, 12)).astype(np.float32) * 3
    lp = (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)
    tok = np.zeros(128, np.int32)
    tok[:21] = rng.integers(0, 12, size=21)
    want_path, want_ev = jax_evidence.fused_path_evidence(
        jnp.asarray(lp), jnp.asarray(tok), 40, 21, 0, backend="scan")
    got_path, got_ev = torch_evidence.fused_path_evidence(
        torch.from_numpy(lp), torch.from_numpy(tok), 40, 21, 0)
    np.testing.assert_array_equal(got_path, want_path)
    assert got_path.dtype == np.int32 and got_ev.blank_prob.dtype == np.float64
    np.testing.assert_array_equal(got_ev.emit_lp, want_ev.emit_lp)
    np.testing.assert_array_equal(got_ev.margin, want_ev.margin)
    np.testing.assert_allclose(got_ev.blank_prob, want_ev.blank_prob, rtol=EXP_RTOL)
    np.testing.assert_allclose(got_ev.entropy, want_ev.entropy, rtol=EXP_RTOL)


@pytest.mark.parametrize("scheme", ["pow2", "linear"])
def test_bucketing_matches_jax(scheme, monkeypatch):
    """The (indices, n_pad, s_pad) of each batch the port's
    `align_utterances` hands `_submit_entries` (spied on; the forward never
    runs) are those of the JAX package's `bucket_utterances` on the same
    lengths, as sets in any order."""
    cfg = Wav2Vec2ModelConfig.from_dict(CONFIG)
    aligner = torch_batching.BatchAligner(cfg, params_from_jax(init_params(cfg, seed=0)),
                                          VOCAB, "float32", device="cpu")
    rng = np.random.default_rng(9)
    a_lens = rng.integers(1000, 90000, size=40).tolist()
    audios = [np.zeros(n, np.float32) for n in a_lens]
    # up to ~200 tokens, and never more than twice the frames
    texts = [" ".join(rng.choice(WORDS, size=int(rng.integers(1, min(34, n // 40)))))
             for n in a_lens]
    s_lens = [len(aligner._tokenize(t).tokens) for t in texts]
    index = {id(a): i for i, a in enumerate(audios)}
    got = []

    def spy(entries, n_pad, s_pad, max_batch, pad_batch):
        got.append((tuple(index[id(a)] for a, _ in entries), n_pad, s_pad))
        return len(entries)

    monkeypatch.setattr(aligner, "_submit_entries", spy)
    monkeypatch.setattr(aligner, "group_batch",
                        lambda seqs, rows: [AlignmentOutput(words=[])] * rows)
    outs = aligner.align_utterances(audios, texts, max_batch=8, bucket_scheme=scheme)
    assert len(outs) == len(audios)
    want = jax_batching.bucket_utterances(a_lens, s_lens, max_batch=8, scheme=scheme)
    assert len(want) > 5 and len({(b.n_pad, b.s_pad) for b in want}) > 3
    assert sorted(got) == sorted((tuple(b.indices), b.n_pad, b.s_pad) for b in want)
    rows = [np.arange(6).reshape(3, 2), np.arange(3)]
    for g, w in zip(torch_batching._pad_batch_rows(4, *rows),
                    jax_batching._pad_batch_rows(4, *rows)):
        np.testing.assert_array_equal(g, w)
