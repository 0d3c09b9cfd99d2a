"""K7, the audio normalization kernel (`ops.normalize`, `csrc/normalize.cu`),
and the batch path that feeds it raw rows.

On the CPU: K7's plain version (`normalize.reference`, f64 torch) against
`normalize_audio` row by row, from 1 sample to 32 s, on int16-valued, int16,
f64 and any f32 rows and on rows under the 1e-7 σ floor: within 1 f32 ulp
where |value| >= 2^-8 and 2^-30 nearer 0 (`chip_smoke.k7_gap`), the share
bit for bit reported; the padded layout (zeros past each length, fill rows
their source row bit for bit); `pack_rows`' offsets; the argument checks;
the CPU and mesh paths of `_submit_entries` still normalizing each row
with `normalize_audio`, and the packed path (run here on the CPU, pinning
stubbed) giving the host path's words; the `batching.prepare` counts.

On the card (marked `cuda`; they skip here, since a CUDA kernel has no CPU
mode): K7 against its plain version and `normalize_audio` at the mix's
bucket shapes, bit for bit on at least 99.99% of elements; the pack and the
upload through K7's launch under `torch.cuda.set_sync_debug_mode("error")`;
`align_stream` with K7 and with the host path on one seeded pool, the same
words and times. This file imports neither jax nor the JAX package; on a
GPU machine run

    python -m pytest --noconftest tests/test_torch_port_normalize.py -m cuda
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from chip_smoke import k7_gap
from wav2vec2_tpu_torch.config import Wav2Vec2ModelConfig
from wav2vec2_tpu_torch.models.params import init_params, params_from_jax
from wav2vec2_tpu_torch.ops import cuda_build, normalize
from wav2vec2_tpu_torch.parallel import batching
from wav2vec2_tpu_torch.parallel.batching import BatchAligner
from wav2vec2_tpu_torch.pipeline.runtime import normalize_audio
from wav2vec2_tpu_torch.utils import spans

SOURCE = Path(normalize.__file__).resolve().parent.parent / "csrc" / "normalize.cu"
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
WORDS = ("THE", "OF", "AND", "TO", "HE", "WAS", "THAT", "HIS", "WITH", "FOR")
LENGTHS = (1, 2, 3, 5, 7, 4_001, 16_000, 160_000, 512_000)  # up to 32 s
KINDS = ("int16_valued", "int16", "f64", "f32", "constant", "tiny")


def _row(kind, n, rng):
    """One raw row of `kind`: int16-valued f32 (the mix's), int16, f64, any
    f32, a constant (σ 0, the floor) or σ 1e-9 noise (under the floor)."""
    q = np.clip(np.round(rng.normal(0, 3276.8, n)), -32768, 32767)
    if kind == "int16_valued":
        return q.astype(np.float32) / np.float32(32768)
    if kind == "int16":
        return q.astype(np.int16)
    if kind == "f64":
        return rng.normal(0.02, 0.3, n)
    if kind == "f32":
        return (rng.normal(0.01, 0.3, n) * rng.uniform(0.5, 2.0)).astype(np.float32)
    if kind == "constant":
        return np.full(n, np.float32(1234 / 32768))
    return rng.normal(0, 1e-9, n).astype(np.float32)


def _host_padded(rows, n_pad, fill=0):
    """`normalize_audio` of each row, padded with zeros to n_pad; `fill`
    more rows repeating the last."""
    out = np.zeros((len(rows) + fill, n_pad), np.float32)
    for j, r in enumerate(rows):
        out[j, :len(r)] = normalize_audio(r)
    out[len(rows):] = out[len(rows) - 1]
    return torch.from_numpy(out)


def _tiny_model():
    cfg = Wav2Vec2ModelConfig.from_dict(CONFIG)
    return cfg, params_from_jax(init_params(cfg, seed=3))


def _pool(seed, n=10):
    """(audio, transcript) items: int16-valued noise of 1-4 s, 2.7 words/s."""
    rng = np.random.default_rng(seed)
    items = []
    for _ in range(n):
        audio = _row("int16_valued", int(rng.integers(16_000, 64_000)), rng)
        n_w = max(1, round(len(audio) / 16_000 * 2.7))
        items.append((audio, " ".join(rng.choice(WORDS, n_w))))
    return items


def _words(results):
    return {i: [(w.word, w.start_ms, w.end_ms) for w in out.words] for i, out in results}


@pytest.fixture
def no_library(monkeypatch):
    """Loading the kernel library fails the test."""
    def refuse(*_):
        raise AssertionError("the kernel library was loaded")

    normalize._library.cache_clear()
    monkeypatch.setattr(cuda_build, "library", refuse)
    monkeypatch.setattr(normalize, "library", refuse)
    yield
    normalize._library.cache_clear()


@pytest.fixture
def unpinned(monkeypatch):
    """The packed path on the CPU: `pack_rows` and `pin_memory` leave host
    tensors as they are (pinning needs CUDA)."""
    pack = normalize.pack_rows
    monkeypatch.setattr(normalize, "pack_rows",
                        lambda rows, n_pad, fill=0, pin=False: pack(rows, n_pad, fill))
    monkeypatch.setattr(torch.Tensor, "pin_memory", lambda self: self)


# --- the CPU ----------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_plain_version_within_an_ulp_of_normalize_audio(kind, no_library, record_property):
    rng = np.random.default_rng(KINDS.index(kind))
    rows = [_row(kind, n, rng) for n in LENGTHS]
    packed = normalize.pack_rows(rows, LENGTHS[-1])
    got = normalize.normalize_rows(packed.samples, packed.offsets, packed.lens, packed.n_pad)
    worst, exact = k7_gap(got, _host_padded(rows, LENGTHS[-1]))
    record_property("bit_for_bit_share", exact)
    print(f"{kind}: {worst} f32 ulp where |value| >= 2^-8, {exact:.6%} bit for bit")
    if kind in ("int16_valued", "int16", "constant"):
        # the f64 sum of int16 values is exact in any order: so is the mean
        assert exact >= 0.99999


@pytest.mark.parametrize("n_pad", [4_000, 4_003])
def test_padded_layout_and_fill_rows(n_pad, no_library):
    rng = np.random.default_rng(5)
    rows = [_row("f32", n, rng) for n in (4_000, 1, 2_999, 17)]
    packed = normalize.pack_rows(rows, n_pad, fill=3)
    got = normalize.normalize_rows(packed.samples, packed.offsets, packed.lens, n_pad)
    assert got.shape == (7, n_pad) and got.dtype == torch.float32
    for j, r in enumerate(rows):
        assert not got[j, len(r):].any()
        assert got[j, :len(r)].abs().max() > 0 or len(r) == 1
    for j in range(4, 7):  # the fill rows: their source row, bit for bit
        assert torch.equal(got[j].view(torch.int32), got[3].view(torch.int32))
    k7_gap(got, _host_padded(rows, n_pad, fill=3))


def test_pack_rows_offsets():
    rows = [np.arange(1, dtype=np.int16), np.arange(4, dtype=np.float64) + 0.1,
            np.arange(5, dtype=np.float32), np.zeros(0, np.float32), np.ones(3, np.float32)]
    packed = normalize.pack_rows(rows, 8, fill=2)
    assert packed.offsets.tolist() == [0, 4, 8, 16, 16, 16, 16]
    assert packed.lens.tolist() == [1, 4, 5, 0, 3, 3, 3]
    assert packed.offsets.dtype == torch.int64 and packed.lens.dtype == torch.int32
    assert packed.samples.shape == (20,) and packed.samples.dtype == torch.float32
    assert packed.real == 13 and packed.shape == (7, 8)
    flat = packed.samples.numpy()
    for at, r in zip(packed.offsets.tolist(), rows):
        np.testing.assert_array_equal(flat[at:at + len(r)], np.asarray(r, np.float32))
    assert all(at % normalize.ALIGN == 0 for at in packed.offsets.tolist())
    with pytest.raises(ValueError, match="at least one row"):
        normalize.pack_rows([], 8)
    with pytest.raises(ValueError, match="past n_pad"):
        normalize.pack_rows([np.zeros(9, np.float32)], 8)


@pytest.mark.parametrize("case,message", [
    (dict(samples=torch.zeros(8, dtype=torch.float64)), "contiguous f32"),
    (dict(samples=torch.zeros(2, 4)), "contiguous f32"),
    (dict(offsets=torch.zeros(2, dtype=torch.int32)), "offsets"),
    (dict(lens=torch.zeros(2, dtype=torch.int64)), "lens"),
    (dict(lens=torch.zeros(3, dtype=torch.int32)), "lens"),
    (dict(n_pad=0), "n_pad"),
])
def test_argument_checks_raise_before_any_library_load(case, message, no_library):
    args = dict(samples=torch.zeros(8), offsets=torch.zeros(2, dtype=torch.int64),
                lens=torch.ones(2, dtype=torch.int32), n_pad=4)
    args.update(case)
    with pytest.raises(ValueError, match=message):
        normalize.normalize_rows(**args)


def test_a_device_without_the_kernel_raises(no_library):
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="no K7 kernel"):
        normalize.normalize_rows(torch.zeros(8, **meta), torch.zeros(2, dtype=torch.int64, **meta),
                                 torch.ones(2, dtype=torch.int32, **meta), 4)


def test_constants_match_the_source():
    text = SOURCE.read_text()
    assert float(re.search(r"kStdFloor = ([0-9.e+-]+);", text).group(1)) == normalize.STD_FLOOR
    # a row reads as float4 vectors: ALIGN samples of 4 bytes are 16 bytes
    assert "float4" in text and normalize.ALIGN * 4 == 16
    assert SOURCE in cuda_build.SOURCES


def test_which_rows_go_raw_to_the_card():
    cuda, cpu, mesh = torch.device("cuda", 0), torch.device("cpu"), object()
    assert batching._raw_rows_to_card(cuda, None)
    assert not batching._raw_rows_to_card(cpu, None)
    assert not batching._raw_rows_to_card(cuda, mesh)  # the mesh: host rows


def _submitted(aligner, monkeypatch, entries, n_pad=64_000):
    """What `_submit_entries` hands `submit_padded_batch`, and the number of
    `normalize_audio` calls on the way."""
    calls, got = [], {}
    monkeypatch.setattr(batching, "normalize_audio",
                        lambda a: calls.append(len(a)) or normalize_audio(a))
    monkeypatch.setattr(aligner, "submit_padded_batch",
                        lambda *args: got.setdefault("args", args))
    aligner._submit_entries(entries, n_pad, 128, 8, True)
    return got["args"], calls


@pytest.mark.parametrize("path", ["cpu", "mesh"])
def test_host_paths_still_call_normalize_audio(path, monkeypatch):
    cfg, params = _tiny_model()
    aligner = BatchAligner(cfg, params, VOCAB, "float32", device="cpu")
    if path == "mesh":  # a CUDA device under a mesh decides as the CPU does
        aligner._raw_to_card = batching._raw_rows_to_card(torch.device("cuda"), object())
    entries = [(a, aligner._tokenize(t)) for a, t in _pool(1, n=3)]
    (audio, a_l, tokens, s_l), calls = _submitted(aligner, monkeypatch, entries)
    assert calls == [len(a) for a, _ in entries]
    assert isinstance(audio, np.ndarray) and audio.shape == (4, 64_000)
    want = _host_padded([a for a, _ in entries], 64_000, fill=1)
    np.testing.assert_array_equal(audio, want.numpy())
    assert a_l.tolist() == [len(a) for a, _ in entries] + [len(entries[-1][0])]


def test_packed_path_on_the_cpu_gives_the_host_paths_words(unpinned, monkeypatch):
    cfg, params = _tiny_model()
    pool = _pool(7)
    host = BatchAligner(cfg, params, VOCAB, "float32", device="cpu")
    raw = BatchAligner(cfg, params, VOCAB, "float32", device="cpu")
    raw._raw_to_card = True
    entries = [(a, raw._tokenize(t)) for a, t in pool[:3]]
    (audio, a_l, tokens, s_l), calls = _submitted(raw, monkeypatch, entries)
    assert calls == [] and isinstance(audio, normalize.PackedRows) and audio.shape == (4, 64_000)
    assert a_l is audio.lens and tokens.shape == (4, 128) and tokens.dtype == torch.int32
    assert torch.equal(tokens[3], tokens[2]) and s_l.tolist()[3] == s_l.tolist()[2]
    streamed = BatchAligner(cfg, params, VOCAB, "float32", device="cpu")
    streamed._raw_to_card = True
    kw = dict(max_batch=4, max_pending=8, max_in_flight=2)
    got = _words(streamed.align_stream(pool, **kw))
    assert got == _words(host.align_stream(pool, **kw))
    assert sum(len(w) for w in got.values()) > 0


def test_prepare_counts_real_samples_and_those_on_the_card(unpinned):
    cfg, params = _tiny_model()
    pool = _pool(9, n=3)
    real = sum(len(a) for a, _ in pool)
    counts = {}
    for on_card in (False, True):
        aligner = BatchAligner(cfg, params, VOCAB, "float32", device="cpu")
        aligner._raw_to_card = on_card
        with profile(activities=[ProfilerActivity.CPU]):
            spans.clear()
            list(aligner.align_stream(pool, max_batch=4))
            counts[on_card] = [s.counts for s in spans.snapshot()
                               if s.name == "batching.prepare"]
        spans.clear()
    for on_card, found in counts.items():
        assert sum(c["samples_real"] for c in found) == real
        assert sum(c["samples_card"] for c in found) == (real if on_card else 0)
        assert all(c["samples_total"] >= c["samples_real"] for c in found)
    assert [{k: c[k] for k in ("samples_fill", "samples_total")} for c in counts[True]] == \
        [{k: c[k] for k in ("samples_fill", "samples_total")} for c in counts[False]]


# --- the card ----------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int16_valued", "f32"])
@pytest.mark.parametrize("rows,seconds", [(1, 1), (32, 1), (5, 2), (32, 8), (17, 16), (3, 32),
                                          (32, 32)])
def test_kernel_against_plain_and_normalize_audio(rows, seconds, kind):
    device = _card()
    rng = np.random.default_rng(rows * 100 + seconds)
    n_pad = seconds * 16_000
    lens = rng.integers(max(1, n_pad // 2), n_pad + 1, rows)
    raw = [_row(kind, int(n), rng) for n in lens]
    fill = (1 << (rows - 1).bit_length()) - rows
    packed = normalize.pack_rows(raw, n_pad, fill=fill, pin=True)
    args = [t.to(device) for t in (packed.samples, packed.offsets, packed.lens)]
    before = normalize.launches["normalize"]
    got = normalize.normalize_rows(*args, n_pad)
    plain = normalize.reference(*args, n_pad)
    torch.cuda.synchronize()
    assert normalize.launches["normalize"] == before + 1
    want = _host_padded(raw, n_pad, fill=fill).to(device)
    worst, exact = k7_gap(got, want)
    k7_gap(plain, want)
    k7_gap(got, plain)
    assert not got[torch.arange(n_pad, device=device)[None, :]
                   >= args[2].long()[:, None]].any()
    for j in range(rows, rows + fill):
        assert torch.equal(got[j].view(torch.int32), got[rows - 1].view(torch.int32))
    print(f"K7 {rows} x {n_pad} {kind}: {worst} ulp, {exact:.6%} bit for bit")


@pytest.mark.cuda
def test_pack_and_upload_do_not_synchronise(monkeypatch):
    device = _card()
    cfg, params = _tiny_model()
    aligner = BatchAligner(cfg, params, VOCAB, "bfloat16", device=device)
    entries = [(a, aligner._tokenize(t)) for a, t in _pool(11, n=5)]

    class Launched(Exception):
        pass

    def stop(params, audio, *args, **kwargs):
        raise Launched(audio)

    monkeypatch.setattr(batching, "wav2vec2_forward", stop)
    for mode in ("default", "error"):  # the first builds, pins and warms up
        torch.cuda.set_sync_debug_mode(mode)
        try:
            with pytest.raises(Launched) as launched:
                aligner._submit_entries(entries, 64_000, 128, 8, True)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    audio = launched.value.args[0]
    assert audio.device.type == "cuda" and audio.shape == (8, 64_000)
    k7_gap(audio, _host_padded([a for a, _ in entries], 64_000, fill=3).to(device))


@pytest.mark.cuda
def test_align_stream_same_words_with_k7_and_on_the_host():
    device = _card()
    cfg, params = _tiny_model()
    pool = _pool(13, n=24)
    kw = dict(max_batch=8, max_pending=16, max_in_flight=2)
    got = {}
    for on_card in (True, False):
        aligner = BatchAligner(cfg, params, VOCAB, "bfloat16", device=device)
        aligner._raw_to_card = on_card
        before = normalize.launches["normalize"]
        got[on_card] = _words(aligner.align_stream(pool, **kw))
        assert (normalize.launches["normalize"] > before) == on_card
    assert got[True] == got[False]
    assert sum(len(w) for w in got[True].values()) > 0
