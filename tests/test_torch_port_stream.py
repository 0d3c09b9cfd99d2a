"""PyTorch port vs the JAX package: `BatchAligner.align_stream` on the CPU.

The same utterances go through the port's `align_stream` and JAX's at
f32: mixed buckets with degenerate inputs (empty audio, a blank
transcript), a `max_pending` early flush of the fullest bucket, and an
utterance too short for its transcript. The yielded index order must be
identical; the words equal, boundaries within one frame stride (the
tolerance of `tests/test_torch_port_pipeline.py::_assert_same_alignment`).
The port's stream must also equal the port's own `align_utterances`
exactly: where no early flush runs, its buckets hold the same utterances.
"""

import dataclasses

import jax
import numpy as np
import pytest

from wav2vec2_tpu.config import Wav2Vec2ModelConfig as JaxCfg
from wav2vec2_tpu.errors import InvalidInputError as JaxInvalidInput
from wav2vec2_tpu.models.params import init_params as jax_init_params
from wav2vec2_tpu.parallel.batching import BatchAligner as JaxBatchAligner
from wav2vec2_tpu_torch import BatchAligner, InvalidInputError
from wav2vec2_tpu_torch.config import Wav2Vec2ModelConfig as TorchCfg
from wav2vec2_tpu_torch.models.params import params_from_jax

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
# utterance lengths in samples: with audio_multiple=1000 they fall in the
# 1000, 2000 and 4000 buckets
LENGTHS = [1800, 900, 3500, 1900, 0, 3100, 800, 1700, 2600, 1200, 3900, 600]


@pytest.fixture(scope="module")
def aligners():
    jcfg, tcfg = JaxCfg.from_dict(CONFIG), TorchCfg.from_dict(CONFIG)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(7))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    return (BatchAligner(tcfg, tp, VOCAB, compute_dtype="float32", device="cpu"),
            JaxBatchAligner(jcfg, jp, VOCAB, compute_dtype="float32"),
            tcfg.frame_stride_ms(16000))


def _items(seed, lengths=LENGTHS, blank_at=(7,)):
    rng = np.random.default_rng(seed)
    items = []
    for i, n in enumerate(lengths):
        text = "   " if i in blank_at else " ".join(rng.choice(WORDS, size=1 + n // 1500))
        items.append((rng.normal(size=n).astype(np.float32), text))
    return items


def _collect(stream):
    """The stream's (index, output) pairs, and the error that ended it."""
    out = []
    try:
        for idx, res in stream:
            out.append((idx, res))
    except (InvalidInputError, JaxInvalidInput) as e:
        return out, e
    return out, None


def _assert_streams_agree(got, want, stride_ms):
    assert [i for i, _ in got] == [i for i, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert [x.word for x in g.words] == [x.word for x in w.words]
        for a, b in zip(g.words, w.words):
            assert abs(a.start_ms - b.start_ms) <= stride_ms
            assert abs(a.end_ms - b.end_ms) <= stride_ms


@pytest.mark.parametrize("max_batch,max_pending,max_in_flight", [
    (2, 256, 2),   # mixed buckets, no early flush
    (4, 3, 1),     # the fullest pending bucket flushes early
    (8, 5, 3),
])
def test_align_stream_matches_jax(aligners, max_batch, max_pending, max_in_flight):
    port, jax_aligner, stride_ms = aligners
    items = _items(0)
    kw = dict(audio_multiple=1000, max_batch=max_batch, max_pending=max_pending,
              max_in_flight=max_in_flight)
    got, err = _collect(port.align_stream(iter(items), **kw))
    want, jax_err = _collect(jax_aligner.align_stream(iter(items), **kw))
    assert err is None and jax_err is None
    _assert_streams_agree(got, want, stride_ms)
    assert sorted(i for i, _ in got) == list(range(len(items)))
    # degenerate inputs (empty audio at 4, blank transcript at 7) yield
    # at once: ahead of every utterance that arrived after them
    order = [i for i, _ in got]
    for i in (4, 7):
        assert all(order.index(i) < order.index(j) for j in range(i + 1, len(items)))
    by_index = dict(got)
    assert by_index[4].words == [] and by_index[7].words == []
    if max_pending >= len(items):
        full = port.align_utterances([a for a, _ in items], [t for _, t in items],
                                     audio_multiple=1000, max_batch=max_batch)
        for i, out in enumerate(full):
            assert dataclasses.asdict(by_index[i]) == dataclasses.asdict(out)


def test_align_stream_early_flush_order(aligners):
    """Which bucket goes first under max_pending: the fullest one, before
    the stream ends — the same index order as JAX's, different from the
    order without the cap."""
    port, jax_aligner, stride_ms = aligners
    items = _items(1, lengths=[900, 1800, 950, 1900, 3500, 880, 970], blank_at=())
    capped, _ = _collect(port.align_stream(iter(items), audio_multiple=1000, max_batch=8,
                                           max_pending=4, max_in_flight=1))
    want, _ = _collect(jax_aligner.align_stream(iter(items), audio_multiple=1000,
                                                max_batch=8, max_pending=4,
                                                max_in_flight=1))
    _assert_streams_agree(capped, want, stride_ms)
    uncapped, _ = _collect(port.align_stream(iter(items), audio_multiple=1000, max_batch=8,
                                             max_in_flight=1))
    assert [i for i, _ in capped] != [i for i, _ in uncapped]


def test_align_stream_too_short_raises_like_jax(aligners):
    port, jax_aligner, stride_ms = aligners
    items = _items(2, lengths=[1800, 2500, 400, 1900], blank_at=())
    items[2] = (items[2][0], " ".join(WORDS * 3))
    kw = dict(audio_multiple=1000, max_batch=1, max_in_flight=0)
    got, err = _collect(port.align_stream(iter(items), **kw))
    want, jax_err = _collect(jax_aligner.align_stream(iter(items), **kw))
    assert isinstance(err, InvalidInputError) and isinstance(jax_err, JaxInvalidInput)
    assert str(err) == str(jax_err)
    assert "utterance 2" in str(err)
    _assert_streams_agree(got, want, stride_ms)
    assert [i for i, _ in got] == [0, 1]
