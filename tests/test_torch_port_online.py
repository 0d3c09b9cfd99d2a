"""PyTorch port vs the JAX package: online alignment (`align/online.py`).

- `IncrementalViterbi` (a copy of JAX's class) gives `viterbi_numpy`'s
  path and JAX's, row by row appended.
- The window forward: each window's log-probs within 1e-4 of JAX's
  `_shared_window_forward` on the same window and weights, for a tiny
  wav2vec2, a tiny conformer rel-pos (the port through K5's plain
  version, JAX through its Pallas kernel in interpret mode) and a tiny
  w2v-BERT (log-mel frontend, 40 ms frames).
- The session logic: both aligners get the same numpy window forward in
  place of their model's, so every push's emitted words and the flush
  must be identical (word, start, end, confidence), for word and phoneme
  units and for `normalize` "window" and "none".
- JAX's `tests/test_online.py` behaviours on the port: the stable prefix
  and the word sequence of `align_longform`, piece-size independence, a
  tiny tail, an empty transcript, the min-frames guard, phoneme units,
  and the overlap errors.
- The port runs on `cuda` unless asked for the CPU: without a CUDA device
  the default raises.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wav2vec2_tpu.align import online as jax_online
from wav2vec2_tpu.config import Wav2Vec2ModelConfig as JaxCfg
from wav2vec2_tpu.models.params import init_params as jax_init_params
from wav2vec2_tpu.ops.viterbi_ref import viterbi_numpy as jax_viterbi_numpy
from wav2vec2_tpu_torch import align_longform
from wav2vec2_tpu_torch.align import online
from wav2vec2_tpu_torch.align.online import IncrementalViterbi, OnlineAligner
from wav2vec2_tpu_torch.config import Wav2Vec2ModelConfig as TorchCfg
from wav2vec2_tpu_torch.errors import InvalidInputError
from wav2vec2_tpu_torch.models import params as torch_params
from wav2vec2_tpu_torch.ops.viterbi_ref import viterbi_numpy
from wav2vec2_tpu_torch.pipeline.runtime import normalize_audio

LP_ATOL = 1e-4
TINY = dict(
    hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
    intermediate_size=64, conv_dim=[16, 16], conv_kernel=[10, 3],
    conv_stride=[5, 2], num_conv_pos_embeddings=16,
    num_conv_pos_embedding_groups=4, pad_token_id=0, vocab_size=8,
    feat_extract_norm="group", conv_bias=False,
)
CONFORMER = dict(
    model_type="wav2vec2-conformer", hidden_size=64, num_hidden_layers=2,
    num_attention_heads=2, intermediate_size=96, conv_dim=[16, 16], conv_kernel=[10, 3],
    conv_stride=[5, 2], num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
    pad_token_id=0, vocab_size=8, feat_extract_norm="layer", conv_bias=True,
    position_embeddings_type="relative", hidden_act="swish", conv_depthwise_kernel_size=7,
    use_flash_attention=True,
)
W2V_BERT = dict(
    model_type="wav2vec2-bert", hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
    intermediate_size=96, pad_token_id=0, vocab_size=8,
    position_embeddings_type="relative_key", left_max_position_embeddings=8,
    right_max_position_embeddings=2, conv_depthwise_kernel_size=7,
    add_adapter=True, adapter_kernel_size=3, adapter_stride=2, num_adapter_layers=1,
)
VOCAB = {"a": 1, "b": 2, "|": 3}
PHONEME_VOCAB = {"a": 1, "b": 2, "|": 3, "tʃ": 4, "ɛ̃": 5}


def _models(d, seed=0):
    jcfg, tcfg = JaxCfg.from_dict(d), TorchCfg.from_dict(d)
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(seed)))
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), torch_params.params_from_jax(tree)


@pytest.fixture(scope="module")
def tiny():
    return _models(TINY)


def _port(tcfg, tp, transcript, vocab=VOCAB, **kw):
    return OnlineAligner(tcfg, tp, vocab, transcript, device="cpu", **kw)


def _words(ws):
    return [(w.word, w.start_ms, w.end_ms, w.confidence) for w in ws]


def test_incremental_viterbi_matches_the_oracle_and_jax():
    rng = np.random.default_rng(0)
    for trial in range(12):
        t_len = int(rng.integers(8, 60))
        s_len = int(rng.integers(1, min(2 * t_len - 1, 20)))
        tokens = rng.integers(0, 8, size=s_len).astype(np.int64)
        lp = np.log(rng.dirichlet(np.ones(8), size=t_len)).astype(np.float32)
        ours, theirs = IncrementalViterbi(tokens), jax_online.IncrementalViterbi(tokens)
        for t in range(t_len):
            ours.append(lp[t])
            theirs.append(lp[t])
            np.testing.assert_array_equal(ours.backtrace(), theirs.backtrace())
            np.testing.assert_array_equal(ours.prev, theirs.prev)
        got = ours.backtrace()
        assert [(int(s), i) for i, s in enumerate(got)] == viterbi_numpy(lp, tokens) \
            == jax_viterbi_numpy(lp, tokens), (trial, t_len, s_len)


@pytest.mark.parametrize("family,d", [
    ("wav2vec2", TINY), ("conformer-rel-pos", CONFORMER), ("w2v-bert", W2V_BERT),
])
def test_window_log_probs_match_jax(family, d):
    """Every window of a stream at f32 (the full ones and flush's masked
    tail), from each package's own window forward."""
    jcfg, tcfg, jp, tp = _models(d, seed=3)
    audio = np.random.default_rng(4).normal(size=40_000).astype(np.float32)
    kw = dict(chunk_sec=1.0, overlap_sec=0.25, finalize_margin_sec=0.5)
    port = _port(tcfg, tp, "ab ba ab", **kw)
    ref = jax_online.OnlineAligner(jcfg, jp, VOCAB, "ab ba ab", **kw)
    seen = []
    for aligner, out in ((port, []), (ref, [])):
        real = aligner._window_logprobs

        def record(start, true_len, real=real, out=out):
            lp = real(start, true_len)
            out.append((start, true_len, lp))
            return lp

        aligner._window_logprobs = record
        for i in range(0, len(audio), 7000):
            aligner.push(audio[i: i + 7000])
        aligner.flush()
        seen.append(out)
    got, want = seen
    assert len(got) == len(want) >= 3
    assert got[-1][1] < port.chunk  # the masked tail window
    for (s1, n1, a), (s2, n2, b) in zip(got, want):
        assert (s1, n1) == (s2, n2) and a.shape == b.shape and a.dtype == np.float32
        np.testing.assert_allclose(a, b, atol=LP_ATOL, rtol=0)
    if family == "w2v-bert":
        assert port.stride_ms == 40.0


def _numpy_window_forward(cfg, seed=5):
    """A deterministic stand-in for the model: frame f's log-probs are a
    log-softmax of a projection of its samples, so they depend on the
    window's (normalized) audio and on its valid length."""
    stride = cfg.frame_stride_samples()
    w = np.random.default_rng(seed).normal(size=(stride, cfg.vocab_size)).astype(np.float32)

    def fwd(audio, n):
        audio = np.asarray(audio, np.float32)
        t = cfg.conv_output_length(audio.shape[1])
        x = audio[0, : t * stride].reshape(t, stride) @ w
        x[cfg.conv_output_length(int(np.asarray(n)[0])):] = 0.0
        x = x - x.max(axis=-1, keepdims=True)
        return (x - np.log(np.exp(x).sum(axis=-1, keepdims=True)))[None].astype(np.float32)

    return fwd


@pytest.mark.parametrize("units", ["word", "phoneme"])
@pytest.mark.parametrize("normalize", ["window", "none"])
def test_same_window_log_probs_give_the_same_words_at_every_push(tiny, units, normalize):
    jcfg, tcfg, jp, tp = tiny
    vocab = PHONEME_VOCAB if units == "phoneme" else VOCAB
    transcript = "a tʃ ɛ̃ b | a tʃ b a" if units == "phoneme" else "ab ba ab ba ab"
    fwd = _numpy_window_forward(tcfg)
    kw = dict(chunk_sec=1.0, overlap_sec=0.25, finalize_margin_sec=0.5, normalize=normalize,
              units=units)
    port = _port(tcfg, tp, transcript, vocab=vocab, **kw)
    ref = jax_online.OnlineAligner(jcfg, jp, vocab, transcript, **kw)
    port._fwd = lambda p, audio, n: torch.from_numpy(fwd(audio.numpy(), n.numpy()))
    ref._fwd = lambda p, audio, n: fwd(audio, n)
    rng = np.random.default_rng(6)
    audio = (0.3 * rng.normal(size=56_000) + 0.05).astype(np.float32)
    pos, pushes, emitted = 0, 0, 0
    for piece in rng.integers(500, 9000, size=200):
        if pos >= len(audio):
            break
        chunk = audio[pos: pos + piece]
        got, want = port.push(chunk), ref.push(chunk)
        assert _words(got) == _words(want), pushes
        pos += piece
        pushes += 1
        emitted += len(got)
    assert emitted > 0, "nothing finalized before flush"
    assert _words(port.flush().words) == _words(ref.flush().words)


def test_online_matches_longform_and_is_stable(tiny):
    _, tcfg, _, tp = tiny
    rng = np.random.default_rng(1)
    audio = normalize_audio(rng.normal(size=48_000).astype(np.float32))
    transcript = "ab ba ab ba ab"
    offline = align_longform(audio, transcript, tp, tcfg, VOCAB, chunk_sec=1.0,
                             overlap_sec=0.25, sample_rate=16000, device="cpu")
    aligner = _port(tcfg, tp, transcript, chunk_sec=1.0, overlap_sec=0.25,
                    finalize_margin_sec=0.5, normalize="none")
    emitted = []
    for i in range(0, len(audio), 3100):
        emitted += aligner.push(audio[i: i + 3100])
    out = aligner.flush()
    assert emitted and _words(out.words)[: len(emitted)] == _words(emitted)
    assert [w.word for w in out.words] == [w.word for w in offline.words]
    starts = [w.start_ms for w in out.words]
    assert starts == sorted(starts)


@pytest.mark.parametrize("units", ["word", "phoneme"])
def test_online_piece_size_independent(tiny, units):
    _, tcfg, _, tp = tiny
    vocab = PHONEME_VOCAB if units == "phoneme" else VOCAB
    transcript = "a tʃ ɛ̃ b" if units == "phoneme" else "ab ba ab"
    audio = normalize_audio(np.random.default_rng(3).normal(size=40_000).astype(np.float32))
    outs = []
    for piece in (1000, 7777, len(audio)):
        aligner = _port(tcfg, tp, transcript, vocab=vocab, chunk_sec=1.0, overlap_sec=0.25,
                        finalize_margin_sec=0.5, normalize="none", units=units)
        for i in range(0, len(audio), piece):
            aligner.push(audio[i: i + piece])
        outs.append(_words(aligner.flush().words))
    assert outs[0] and outs[0] == outs[1] == outs[2]


def test_online_tiny_tail_and_empty_transcript(tiny):
    _, tcfg, _, tp = tiny
    rng = np.random.default_rng(2)
    aligner = _port(tcfg, tp, "ab", chunk_sec=1.0, overlap_sec=0.25,
                    finalize_margin_sec=0.2, normalize="window")
    assert aligner.push(rng.normal(size=4000).astype(np.float32)) == []
    assert [w.word for w in aligner.flush().words] == ["ab"]
    empty = _port(tcfg, tp, "   ", chunk_sec=1.0, overlap_sec=0.25)
    empty.push(rng.normal(size=20000).astype(np.float32))
    assert empty.flush().words == []
    with pytest.raises(RuntimeError, match="push after flush"):
        empty.push(np.zeros(10, np.float32))
    with pytest.raises(RuntimeError, match="double flush"):
        empty.flush()


def test_online_flush_min_frames_guard(tiny):
    _, tcfg, _, tp = tiny
    aligner = _port(tcfg, tp, " ".join(["ab ba"] * 40), chunk_sec=1.0, overlap_sec=0.25)
    aligner.push(np.zeros(2000, np.float32))
    with pytest.raises(InvalidInputError, match="too short"):
        aligner.flush()


def test_online_phoneme_units(tiny):
    _, tcfg, _, tp = tiny
    audio = normalize_audio(np.random.default_rng(7).normal(size=32_000).astype(np.float32))
    aligner = _port(tcfg, tp, "a tʃ ɛ̃ b | a tʃ", vocab=PHONEME_VOCAB, chunk_sec=1.0,
                    overlap_sec=0.25, finalize_margin_sec=0.5, normalize="none",
                    units="phoneme")
    streamed = []
    for i in range(0, len(audio), 5000):
        streamed.extend(aligner.push(audio[i: i + 5000]))
    out = aligner.flush()
    assert [u.word for u in out.words] == ["a", "tʃ", "ɛ̃", "b", "a", "tʃ"]
    assert all(u.end_ms > u.start_ms for u in out.words)
    assert _words(streamed) == _words(out.words)[: len(streamed)]


def test_online_overlap_and_units_errors(tiny):
    _, tcfg, _, tp = tiny
    for overlap in (0.0, 1.0, 2.0):
        with pytest.raises(InvalidInputError, match="overlap_sec < chunk_sec"):
            _port(tcfg, tp, "ab", chunk_sec=1.0, overlap_sec=overlap)
    with pytest.raises(InvalidInputError, match="receptive field"):
        _port(tcfg, tp, "ab", chunk_sec=1.0, overlap_sec=0.001)
    with pytest.raises(InvalidInputError, match="units"):
        _port(tcfg, tp, "ab", units="syllable")


def test_window_forward_is_shared_per_config_and_dtype(tiny):
    _, tcfg, _, tp = tiny
    a = _port(tcfg, tp, "ab", chunk_sec=1.0, overlap_sec=0.25)
    b = _port(tcfg, tp, "ba", chunk_sec=1.0, overlap_sec=0.25)
    c = _port(tcfg, tp, "ab", chunk_sec=1.0, overlap_sec=0.25, compute_dtype="bfloat16")
    other = _port(dataclasses.replace(tcfg, layer_norm_eps=1e-3), tp, "ab", chunk_sec=1.0,
                  overlap_sec=0.25)
    assert a._fwd is b._fwd and a._fwd is not c._fwd and a._fwd is not other._fwd
    a.warmup()
    assert a._buf.size == 0 and a.push(np.zeros(100, np.float32)) == []
    assert len(online._window_forwards) <= online._WINDOW_FORWARDS_MAX


def test_default_device_without_cuda_raises(tiny, monkeypatch):
    _, tcfg, _, tp = tiny
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(InvalidInputError, match="--device cpu"):
        OnlineAligner(tcfg, tp, VOCAB, "ab")
