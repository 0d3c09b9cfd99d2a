"""PyTorch port vs the JAX package: long-form alignment, on the CPU.

- `chunk_spans`, `stitch_log_probs` and `stitch_indices` give the JAX
  functions' results on seeded inputs (ragged tail chunks included); the
  port's `stitch_indices` also raises on a frame no chunk covers, where the
  JAX one gathers chunk 0, frame 0.
- The device-gather stitch (`stitch_device`) equals the host stitch bit for
  bit over chunk log-probs from more than one forward sub-batch.
- `align_longform` on the tiny config of tests/test_longform.py at f32:
  stitched log-probs within 1e-4 of the JAX forward's (f32 forwards agree to
  ~1e-5 on the CPU), Viterbi paths bit-identical when both DPs get the same
  log-probs, the same words with boundaries within one frame of the JAX
  `align_longform`; words independent of `max_chunk_batch`.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from wav2vec2_tpu.align import longform as jax_longform
from wav2vec2_tpu.config import Wav2Vec2ModelConfig as JaxCfg
from wav2vec2_tpu.models.ctc_model import log_softmax_logits as jax_log_softmax
from wav2vec2_tpu.models.ctc_model import make_forward_fn
from wav2vec2_tpu.models.params import init_params as jax_init_params
from wav2vec2_tpu.ops.viterbi_ref import viterbi_numpy as jax_viterbi_numpy
from wav2vec2_tpu.pipeline.runtime import normalize_audio as jax_normalize_audio
from wav2vec2_tpu_torch import InvalidInputError, align_longform
from wav2vec2_tpu_torch.align import longform
from wav2vec2_tpu_torch.config import Wav2Vec2ModelConfig as TorchCfg
from wav2vec2_tpu_torch.models.params import params_from_jax
from wav2vec2_tpu_torch.ops import viterbi_cuda
from wav2vec2_tpu_torch.pipeline.runtime import normalize_audio

TINY = dict(
    hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
    intermediate_size=64, conv_dim=[16, 16], conv_kernel=[10, 3],
    conv_stride=[5, 2], num_conv_pos_embeddings=16,
    num_conv_pos_embedding_groups=4, pad_token_id=0, vocab_size=8,
    feat_extract_norm="group", conv_bias=False,
)
VOCAB = {"a": 1, "b": 2, "|": 3}
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def tiny_model():
    jcfg, tcfg = JaxCfg(**TINY), TorchCfg(**TINY)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp))


def _chunk_lps(rng, n_frames, v=5):
    return [rng.standard_normal((n, v)).astype(np.float32) for n in n_frames]


@pytest.mark.parametrize("n,chunk,overlap,stride", [
    (100_000, 32_000, 8_000, 320),   # ragged tail
    (96_000, 32_000, 8_000, 320),    # ends on a hop
    (32_000, 32_000, 8_000, 320),    # one chunk
    (48_017, 16_000, 4_000, 10),     # unaligned length, tiny stride
    (9_600_000, 480_000, 80_000, 320),  # 10 min, 30 s chunks, 5 s overlap
])
def test_chunk_spans_match_jax(n, chunk, overlap, stride):
    assert longform.chunk_spans(n, chunk, overlap, stride) == \
        jax_longform.chunk_spans(n, chunk, overlap, stride)


def test_chunk_spans_refuses_an_overlap_that_is_not_inside_the_chunk():
    with pytest.raises(ValueError, match="overlap"):
        longform.chunk_spans(10_000, 3_200, 3_200, 320)


@pytest.mark.parametrize("spans,n_frames,total", [
    ([(0, 120), (70, 190), (160, 210)], [12, 12, 5], 21),      # ragged tail, ties
    ([(0, 100), (60, 160)], [10, 10], 16),
    ([(0, 300), (200, 500), (400, 700), (600, 730)], [30, 30, 30, 13], 73),
])
def test_stitch_matches_jax(spans, n_frames, total):
    rng = np.random.default_rng(total)
    lps = _chunk_lps(rng, n_frames)
    want = jax_longform.stitch_log_probs(lps, spans, 10, total)
    np.testing.assert_array_equal(longform.stitch_log_probs(lps, spans, 10, total), want)
    c_idx, l_idx = longform.stitch_indices(n_frames, spans, 10, total)
    jc, jl = jax_longform.stitch_indices(n_frames, spans, 10, total)
    np.testing.assert_array_equal(c_idx, jc)
    np.testing.assert_array_equal(l_idx, jl)
    stacked = torch.zeros((len(lps), max(n_frames), lps[0].shape[1]))
    for i, lp in enumerate(lps):
        stacked[i, : len(lp)] = torch.from_numpy(lp)
    got = longform.stitch_device(stacked, spans, n_frames, 10, total)
    np.testing.assert_array_equal(got.numpy(), want)


def test_stitch_indices_raises_on_an_uncovered_frame():
    """Chunks that leave global frames 10..11 uncovered: the JAX function
    silently maps them to chunk 0, frame 0; the port refuses."""
    spans, n_frames = [(0, 100), (120, 220)], [10, 10]
    jc, jl = jax_longform.stitch_indices(n_frames, spans, 10, 22)
    assert jc[10] == jl[10] == 0
    with pytest.raises(ValueError, match="covered by no chunk"):
        longform.stitch_indices(n_frames, spans, 10, 22)


def _jax_stitched(jcfg, jp, audio, chunk, overlap):
    """The JAX forward over the whole chunk batch + the host stitch."""
    normalized = jax_normalize_audio(audio)
    stride = jcfg.frame_stride_samples()
    spans = jax_longform.chunk_spans(len(normalized), chunk, overlap, stride)
    n_pad = max(s1 - s0 for s0, s1 in spans)
    batch = np.zeros((len(spans), n_pad), np.float32)
    lens = np.array([s1 - s0 for s0, s1 in spans], np.int32)
    for i, (s0, s1) in enumerate(spans):
        batch[i, : s1 - s0] = normalized[s0:s1]
    logits = make_forward_fn(jcfg)(jp, jnp.asarray(batch), jnp.asarray(lens))
    lp = np.asarray(jax_log_softmax(logits))
    chunks = [lp[i, : jcfg.conv_output_length(int(n))] for i, n in enumerate(lens)]
    return jax_longform.stitch_log_probs(chunks, spans, stride,
                                         jcfg.conv_output_length(len(audio)))


def test_sub_batched_chunks_and_device_stitch(tiny_model):
    """4.3 s in 1 s chunks (ragged tail) through 3 forward sub-batches of
    2: the device stitch equals `stitch_log_probs` on the same chunk
    log-probs bit for bit, and the stitched matrix is within 1e-4 of the
    JAX forward's."""
    jcfg, tcfg, jp, tp = tiny_model
    audio = np.random.default_rng(3).normal(size=68_800).astype(np.float32)
    lps, spans, n_frames = longform.chunk_log_probs(
        normalize_audio(audio), tp, tcfg, 16_000, 4_000, torch.float32, 2, CPU)
    assert len(spans) == 6 and spans[-1][1] - spans[-1][0] < 16_000
    total = tcfg.conv_output_length(len(audio))
    host = longform.stitch_log_probs([lps[i, :n].numpy() for i, n in enumerate(n_frames)],
                                     spans, tcfg.frame_stride_samples(), total)
    dev = longform.stitch_device(lps, spans, n_frames, tcfg.frame_stride_samples(), total)
    np.testing.assert_array_equal(dev.numpy(), host)
    np.testing.assert_allclose(dev.numpy(), _jax_stitched(jcfg, jp, audio, 16_000, 4_000),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("seconds,chunk_sec", [(3.0, 1.0), (0.5, 1.0)])
def test_align_longform_matches_jax(tiny_model, seconds, chunk_sec):
    """Chunked (3 s in 1 s chunks) and one-forward (0.5 s) inputs."""
    jcfg, tcfg, jp, tp = tiny_model
    rng = np.random.default_rng(1)
    audio = rng.normal(size=int(seconds * 16000)).astype(np.float32)
    transcript = "ab ba ab ba ab" if seconds > 1 else "ab ba"
    chunk, overlap = int(chunk_sec * 16000), int(0.25 * 16000)

    stitched = longform.longform_log_probs(
        normalize_audio(audio), tp, tcfg, chunk, overlap, torch.float32, 32, CPU)
    if seconds > chunk_sec:
        want = _jax_stitched(jcfg, jp, audio, chunk, overlap)
        np.testing.assert_allclose(stitched.numpy(), want, atol=1e-4, rtol=0)

    # the same log-probs into both DPs: bit-identical paths
    from wav2vec2_tpu_torch.align.tokenization import build_token_sequence_case_aware
    seq = build_token_sequence_case_aware(transcript, VOCAB, 0, 3)
    lp = stitched.numpy()
    tok = np.zeros(128, np.int32)
    tok[: len(seq.tokens)] = seq.tokens
    path = viterbi_cuda.viterbi_single(stitched, torch.from_numpy(tok), lp.shape[0],
                                       len(seq.tokens)).numpy()
    assert list(path) == [s for s, _ in jax_viterbi_numpy(lp, np.asarray(seq.tokens))]

    got = align_longform(audio, transcript, tp, tcfg, VOCAB, chunk_sec=chunk_sec,
                         overlap_sec=0.25, device="cpu")
    ref = jax_longform.align_longform(audio, transcript, jp, jcfg, VOCAB,
                                      chunk_sec=chunk_sec, overlap_sec=0.25)
    assert [w.word for w in got.words] == [w.word for w in ref.words] == transcript.split()
    stride_ms = tcfg.frame_stride_ms(16000)
    for g, w in zip(got.words, ref.words):
        assert abs(g.start_ms - w.start_ms) <= stride_ms
        assert abs(g.end_ms - w.end_ms) <= stride_ms
    for a, b in zip(got.words, got.words[1:]):
        assert a.end_ms <= b.start_ms


def test_align_longform_independent_of_max_chunk_batch(tiny_model):
    _, tcfg, _, tp = tiny_model
    audio = np.random.default_rng(5).normal(size=64_000).astype(np.float32)
    transcript = "ab ba ab ba ab ba"
    outs = [align_longform(audio, transcript, tp, tcfg, VOCAB, chunk_sec=1.0,
                           overlap_sec=0.25, max_chunk_batch=mcb, device="cpu")
            for mcb in (2, 3, 32)]
    assert [w.word for w in outs[0].words] == transcript.split()
    for other in outs[1:]:
        assert [w.word for w in other.words] == [w.word for w in outs[0].words]
        for a, b in zip(outs[0].words, other.words):
            assert (a.start_ms, a.end_ms) == (b.start_ms, b.end_ms)
            assert a.confidence == pytest.approx(b.confidence, abs=1e-6)


def test_align_longform_input_contract(tiny_model):
    """Empty audio or transcript → no words, before any forward; audio too
    short for the transcript → InvalidInputError, as the JAX function."""
    _, tcfg, _, tp = tiny_model
    assert align_longform(np.zeros(0, np.float32), "ab", tp, tcfg, VOCAB,
                          device="cpu").words == []
    assert align_longform(np.ones(8000, np.float32), " zz ", tp, tcfg, VOCAB,
                          device="cpu").words == []
    with pytest.raises(InvalidInputError):
        align_longform(np.ones(60, np.float32), "ab ba ab", tp, tcfg, VOCAB, device="cpu")
    with pytest.raises(ValueError, match="dtype"):
        align_longform(np.ones(8000, np.float32), "ab", tp, tcfg, VOCAB,
                       compute_dtype="float16", device="cpu")


def test_frame_stride_samples_matches_jax(tiny_model):
    jcfg, tcfg, _, _ = tiny_model
    assert tcfg.frame_stride_samples() == jcfg.frame_stride_samples() == 10
    base = dict(TINY, conv_kernel=[10, 3, 3, 3, 3, 2, 2], conv_stride=[5, 2, 2, 2, 2, 2, 2],
                conv_dim=[16] * 7)
    assert TorchCfg(**base).frame_stride_samples() == JaxCfg(**base).frame_stride_samples() == 320
    assert TorchCfg(**base).frame_stride_ms(16000) == JaxCfg(**base).frame_stride_ms(16000)
