"""PyTorch port vs the JAX package: per-frame evidence, on-device audio
normalization and bucketing.

Tolerances: the gathers (emit_lp) and the top-2 margin are exact (the same
f32 values selected and subtracted once); exp-based values (blank_prob,
entropy) and the normalization's f32 sums allow 1e-5 relative (another
exp implementation and summation order).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from wav2vec2_tpu.ops import evidence as jax_evidence
from wav2vec2_tpu.parallel import batching as jax_batching
from wav2vec2_tpu_torch.ops import evidence as torch_evidence
from wav2vec2_tpu_torch.parallel import batching as torch_batching

EXP_RTOL = 1e-5


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


@pytest.mark.parametrize("dtype", [np.int16, np.float32])
def test_normalize_batch_matches_jax(dtype):
    rng = np.random.default_rng(8)
    audio = (rng.normal(size=(3, 3000)) * 3000).astype(dtype)
    lens = np.array([3000, 1700, 1], np.int32)
    want = np.asarray(jax_batching._normalize_batch(jnp.asarray(audio), jnp.asarray(lens)))
    got = torch_batching._normalize_batch(torch.from_numpy(audio), torch.from_numpy(lens)).numpy()
    np.testing.assert_allclose(got, want, rtol=EXP_RTOL, atol=1e-5)
    assert (got[1, 1700:] == 0).all()


@pytest.mark.parametrize("scheme", ["pow2", "linear"])
def test_bucketing_matches_jax(scheme):
    rng = np.random.default_rng(9)
    a_lens = rng.integers(1000, 90000, size=40).tolist()
    s_lens = rng.integers(5, 400, size=40).tolist()
    want = jax_batching.bucket_utterances(a_lens, s_lens, max_batch=8, scheme=scheme)
    got = torch_batching.bucket_utterances(a_lens, s_lens, max_batch=8, scheme=scheme)
    assert [(b.indices, b.n_pad, b.s_pad) for b in got] == \
        [(b.indices, b.n_pad, b.s_pad) for b in want]
    rows = [np.arange(6).reshape(3, 2), np.arange(3)]
    for g, w in zip(torch_batching._pad_batch_rows(4, *rows),
                    jax_batching._pad_batch_rows(4, *rows)):
        np.testing.assert_array_equal(g, w)
