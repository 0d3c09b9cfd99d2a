"""The traffic generator: the same seed gives the same inputs, every seed
the same utterances in the same order, at the lengths and word rate the
mix states and its published source gives."""

from __future__ import annotations

import numpy as np

from portbench import generate, manifest
from portbench.tests.conftest import tiny_mix


def test_same_seed_same_inputs_and_every_seed_the_same_work():
    m = tiny_mix("librispeech_stream")
    a = generate.items(m, 2**40 + 17, "cpu")
    b = generate.items(m, 2**40 + 17, "cpu")
    c = generate.items(m, 5, "cpu")
    assert [it.transcript for it in a] == [it.transcript for it in b]
    assert all(np.array_equal(x.audio, y.audio) for x, y in zip(a, b))
    # another seed: the same utterances in the same order, other audio
    assert [(len(x.audio), x.transcript) for x in a] == [(len(y.audio), y.transcript) for y in c]
    assert not any(np.array_equal(x.audio, y.audio) for x, y in zip(a, c))


def test_lengths_and_word_rate_from_the_source():
    m = manifest.traffic("librispeech_stream")
    src = m["source"]
    # test-clean: 5.4 h in 2 620 utterances and 52 576 words
    assert m["seconds"]["mean"] == round(src["hours"] * 3600 / src["utterances"], 2)
    assert m["words_per_s"] == round(src["words"] / (src["hours"] * 3600), 1)
    lengths = generate.quantile_lengths(m["seconds"], m["pool"])
    assert abs(lengths.mean() - m["seconds"]["mean"]) < 1e-6
    assert np.all(np.diff(lengths) >= 0)
    assert m["seconds"]["min"] < lengths.min() and lengths.max() < m["seconds"]["max"]
    its = generate.items({**m, "pool": 64}, 3, "cpu")
    rate = sum(it.n_words for it in its) / sum(it.seconds for it in its)
    assert abs(rate - m["words_per_s"]) < 0.05 * m["words_per_s"]
    for it in its:
        assert len(it.transcript.split()) == it.n_words
        assert np.abs(it.audio).max() <= 1.0
        assert np.array_equal(np.round(it.audio * 32768), it.audio * 32768)  # int16 values


def test_clipped_lengths_keep_the_mean():
    spec = {"dist": "lognormal", "mean": 10.0, "sigma": 1.0, "min": 2.0, "max": 20.0}
    lengths = generate.quantile_lengths(spec, 200)
    assert lengths.min() == 2.0 and lengths.max() == 20.0
    assert abs(lengths.mean() - 10.0) < 1e-6


def test_cycle_order_is_a_fresh_permutation_each_pass():
    a, b = generate.cycle_order(50, 0), generate.cycle_order(50, 1)
    assert sorted(a) == sorted(b) == list(range(50))
    assert not np.array_equal(a, b)
    assert np.array_equal(a, generate.cycle_order(50, 0))
