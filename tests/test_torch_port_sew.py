"""PyTorch port vs the JAX package: SEW and SEW-D.

Small models (2 layers, hidden 64, 4 heads, squeeze factor 2; SEW-D with 16
position buckets over 64 positions and its 1e-7 encoder epsilon), JAX
random-init weights with every norm affine and bias drawn off its init
value (`perturb` of tests/test_torch_port_families.py), carried across by
`params_from_jax`. Same numpy audio on both sides, the JAX side at HIGHEST
precision.

Bounds: f32 log-probs within 1e-4 of JAX's `wav2vec2_forward`
(`F32_LP_ATOL`) and of each utterance alone; bf16 within bench.py's gate
of f32; the DeBERTa buckets and the diagonal selectors equal to JAX's for
every T from 1 to 600, and `_rel_shift` equal to JAX's `_rel_shift` for
every T from 1 to 600; SEW-D's c2p and p2c terms within 1e-5 of JAX's and
of the gather formulation. Under WAV2VEC2_FLASH_FORCE=1, SEW's attention
calls the K5 wrapper once per layer at the pooled length (its plain
version on the CPU) and matches JAX's forced forward; SEW-D never calls it.
On a 20 ms frontend: K1's paths (the plain version on the CPU) equal
`viterbi_numpy` bit for bit, `BatchAligner` gives JAX's words with equal
boundaries, and `ForcedAlignerBuilder` and `alignment_report --device cpu`
on `sew.` / `sew_d.` model directories give the batch entry's words.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from wav2vec2_tpu.config import Wav2Vec2ModelConfig as JaxCfg
from wav2vec2_tpu.models import encoder as jax_encoder
from wav2vec2_tpu.models.params import init_params as jax_init_params
from wav2vec2_tpu.parallel.batching import BatchAligner as JaxBatchAligner
from wav2vec2_tpu_torch import AlignmentInput, ForcedAlignerBuilder, Wav2Vec2Config
from wav2vec2_tpu_torch.cli.alignment_report import run as port_cli
from wav2vec2_tpu_torch.config import Wav2Vec2ModelConfig as TorchCfg
from wav2vec2_tpu_torch.data.audio import read_audio_mono
from wav2vec2_tpu_torch.data.flac_encoder import write_flac
from wav2vec2_tpu_torch.data.textgrid import parse_textgrid_file
from wav2vec2_tpu_torch.errors import InvalidInputError
from wav2vec2_tpu_torch.models import ctc_model as torch_ctc
from wav2vec2_tpu_torch.models import encoder as torch_encoder
from wav2vec2_tpu_torch.models import params as torch_params
from wav2vec2_tpu_torch.ops import flash_attention as fa
from wav2vec2_tpu_torch.ops.viterbi_ref import viterbi_numpy
from wav2vec2_tpu_torch.parallel.batching import BatchAligner
from wav2vec2_tpu_torch.pipeline.runtime import normalize_audio
from wav2vec2_tpu_torch.utils.checkpoint import save_safetensors

from test_torch_port_families import F32_LP_ATOL, SMALL, batch, jax_lp, perturb, torch_lp

SEW_D = dict(model_type="sew-d", position_buckets=16, max_position_embeddings=64,
             layer_norm_eps=1e-7)
SEW_FAMILIES = {
    "sew": dict(model_type="sew"),
    # conv width == hidden size: SEW skips the projection
    "sew-no-projection": dict(model_type="sew", conv_dim=[32, 64]),
    "sew-squeeze-3": dict(model_type="sew", squeeze_factor=3),
    "sew-d": SEW_D,
    "sew-d-c2p-only": dict(SEW_D, pos_att_type=["c2p"]),
}
# the 7-layer frontend of the real checkpoints' 20 ms frames (cut to width 32)
CONV_7 = dict(conv_dim=[32] * 7, conv_kernel=[10, 3, 3, 3, 3, 2, 2],
              conv_stride=[5, 2, 2, 2, 2, 2, 2])
VOCAB = {"<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3, "|": 4}
for _i, _c in enumerate("ETAONIHSRDLUMWCFGYPBVKXJQZ"):
    VOCAB[_c] = 5 + _i
STRIDE_MS = 20


def family_models(d, seed=0):
    d = {**SMALL, **d}
    jcfg, tcfg = JaxCfg.from_dict(d), TorchCfg.from_dict(d)
    tree = perturb(jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(seed))),
                   seed + 1)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), tree


_CACHE = {}


def models(family):
    if family not in _CACHE:
        jcfg, tcfg, jp, tree = family_models(SEW_FAMILIES[family])
        _CACHE[family] = jcfg, tcfg, jp, torch_params.params_from_jax(tree)
    return _CACHE[family]


@pytest.mark.parametrize("family", sorted(SEW_FAMILIES))
def test_f32_padded_batch_matches_jax(family):
    jcfg, tcfg, jp, tp = models(family)
    assert tcfg.encoder_style == "sew"
    assert ("projection" in tp["feature_projection"]) == (family != "sew-no-projection")
    audio, lens = batch()
    want = jax_lp(jp, jcfg, audio, lens)
    got = torch_lp(tp, tcfg, audio, lens)
    assert got.shape == want.shape == (3, tcfg.conv_output_length(4000), 32)
    np.testing.assert_allclose(got, want, atol=F32_LP_ATOL, rtol=0)


@pytest.mark.parametrize("family", sorted(SEW_FAMILIES))
def test_padded_batch_equals_unpadded(family):
    _, tcfg, _, tp = models(family)
    audio, lens = batch(1)
    padded = torch_lp(tp, tcfg, audio, lens)
    for i in (1, 2):
        alone = torch_lp(tp, tcfg, audio[i:i + 1, : lens[i]].copy(), None)
        t_i = tcfg.conv_output_length(int(lens[i]))
        assert alone.shape[1] == t_i
        np.testing.assert_allclose(padded[i, :t_i], alone[0], atol=F32_LP_ATOL, rtol=0)


@pytest.mark.parametrize("family", ["sew", "sew-d"])
def test_bf16_within_gate_of_f32_and_bf16_storage_is_exact(family):
    _, tcfg, _, tp = models(family)
    audio, lens = batch(2)
    ref = torch_lp(tp, tcfg, audio, lens)
    lp = torch_lp(tp, tcfg, audio, lens, dtype=torch.bfloat16)
    valid = torch_ctc.frame_lengths(tcfg, torch.from_numpy(lens)).numpy()
    d = np.concatenate([np.abs(lp[i, :t].astype(np.float64) - ref[i, :t]).ravel()
                        for i, t in enumerate(valid)])
    assert d.mean() <= 0.05 and np.percentile(d, 99) <= 0.3, (d.mean(), np.percentile(d, 99))
    cast = torch_params.cast_compute_weights_bf16(tp)
    np.testing.assert_array_equal(torch_lp(cast, tcfg, audio, lens, dtype=torch.bfloat16), lp)


@pytest.mark.parametrize("span,max_position", [(256, 512), (16, 64), (2, 8)])
def test_deberta_buckets_match_jax_for_every_t(span, max_position):
    """The buckets of every diagonal offset, and the table rows the c2p and
    p2c terms read, equal the JAX package's for every T from 1 to 600."""
    for t in range(1, 601):
        offsets = np.arange(t - 1, -t, -1)
        want = jax_encoder._deberta_log_bucket_positions(offsets, span, max_position)
        got = torch_encoder._deberta_log_bucket_positions(offsets, span, max_position)
        np.testing.assert_array_equal(got, want, err_msg=f"T={t}")
        c2p, p2c = torch_encoder._deberta_selectors(t, span, max_position, torch.device("cpu"))
        np.testing.assert_array_equal(c2p.numpy(), np.clip(want + span, 0, 2 * span - 1))
        np.testing.assert_array_equal(p2c.numpy(), np.clip(-want + span, 0, 2 * span - 1))
    rel = np.arange(40)[:, None] - np.arange(40)[None, :]  # a [T, T] grid, as HF builds it
    np.testing.assert_array_equal(
        torch_encoder._deberta_log_bucket_positions(rel, span, max_position),
        jax_encoder._deberta_log_bucket_positions(rel, span, max_position))


def test_rel_shift_matches_jax_for_every_t():
    """`_rel_shift` of an index tensor (every element its own flat index)
    equals JAX's `_rel_shift` for every T from 1 to 600; JAX's side runs as
    one compiled program per group of T. It is a view of the input, no
    copy."""
    ts = list(range(1, 601))
    while ts:
        group, size = [], 0
        while ts and size < 4_000_000:
            group.append(ts.pop(0))
            size += group[-1] * (2 * group[-1] - 1)
        zs = [np.arange(t * (2 * t - 1), dtype=np.int32).reshape(1, t, 2 * t - 1)
              for t in group]
        want = jax.jit(lambda zs: [jax_encoder._rel_shift(z) for z in zs])(zs)
        for t, z, w in zip(group, zs, want):
            zt = torch.from_numpy(z)
            got = torch_encoder._rel_shift(zt)
            np.testing.assert_array_equal(got.numpy(), np.asarray(w), err_msg=f"T={t}")
            assert got.untyped_storage().data_ptr() == zt.untyped_storage().data_ptr()
    with pytest.raises(ValueError):
        torch_encoder._rel_shift(torch.zeros(3, 4))


@pytest.mark.parametrize("t", [1, 2, 3, 4, 9, 17, 60])
def test_c2p_and_p2c_terms_match_jax_and_the_gather(t):
    """SEW-D's position terms as the port computes them (the layer's table
    rows per diagonal, q or k against them, `_rel_shift`) against the same
    terms through JAX's functions and against HF's gather over a [T, T]
    bucket grid, within 1e-5."""
    span, max_position, hd = 4, 32, 8
    rng = np.random.default_rng(11 + t)
    q = rng.normal(size=(2, 3, t, hd)).astype(np.float32)
    k = rng.normal(size=(2, 3, t, hd)).astype(np.float32)
    pos_k = rng.normal(size=(3, 2 * span, hd)).astype(np.float32)
    pos_q = rng.normal(size=(3, 2 * span, hd)).astype(np.float32)
    c2p_sel, p2c_sel = torch_encoder._deberta_selectors(t, span, max_position,
                                                        torch.device("cpu"))
    tq, tk = torch.from_numpy(q), torch.from_numpy(k)
    c2p = torch_encoder._rel_shift(
        torch.matmul(tq, torch.from_numpy(pos_k)[:, c2p_sel].transpose(-1, -2))).numpy()
    p2c = torch_encoder._rel_shift(
        torch.matmul(tk, torch.from_numpy(pos_q)[:, p2c_sel].transpose(-1, -2))
    ).transpose(-1, -2).numpy()
    diag = jax_encoder._deberta_log_bucket_positions(np.arange(t - 1, -t, -1), span,
                                                     max_position)
    jc2p = np.asarray(jax_encoder._rel_shift(jnp.einsum(
        "bhqd,hed->bhqe", q, pos_k[:, np.clip(diag + span, 0, 2 * span - 1)])))
    jp2c = np.asarray(jax_encoder._rel_shift(jnp.einsum(
        "bhkd,hed->bhke", k, pos_q[:, np.clip(-diag + span, 0, 2 * span - 1)]))).swapaxes(-1, -2)
    grid = jax_encoder._deberta_log_bucket_positions(
        np.arange(t)[:, None] - np.arange(t)[None, :], span, max_position)
    row = np.arange(t)[:, None]
    gather_c2p = np.einsum("bhqd,hsd->bhqs", q, pos_k)[:, :, row,
                                                       np.clip(grid + span, 0, 2 * span - 1)]
    gather_p2c = np.einsum("bhkd,hsd->bhks", k, pos_q)[:, :, row,
                                                       np.clip(-grid + span, 0, 2 * span - 1)]
    for got, want in ((c2p, jc2p), (c2p, gather_c2p), (p2c, jp2c),
                      (p2c, gather_p2c.swapaxes(-1, -2))):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_sew_d_refuses_separate_attention_keys():
    with pytest.raises(InvalidInputError, match="share_att_key"):
        TorchCfg.from_dict({**SMALL, **SEW_D, "share_att_key": False})
    _, tcfg, _, tp = models("sew-d")
    cfg = dataclasses.replace(tcfg, share_att_key=False)
    with pytest.raises(NotImplementedError, match="share_att_key"):
        torch_encoder.sew_d_layers_forward(tp["encoder"], torch.zeros(1, 5, 64), cfg, None)


@pytest.mark.parametrize("family", ["sew", "sew-d"])
def test_forced_flash_runs_k5_on_sew_at_the_pooled_length(family, monkeypatch):
    """WAV2VEC2_FLASH_FORCE=1: SEW's layers call the K5 wrapper once each
    on the pooled frames (T // 2) and match JAX's forced forward (its
    kernel in interpret mode); SEW-D's disentangled attention never calls
    it, as in the JAX package."""
    jcfg, tcfg, jp, tp = models(family)
    monkeypatch.setenv(fa.FORCE_ENV, "1")
    calls = []
    real = fa.flash_attention

    def counting(q, *a, **kw):
        calls.append(q.shape[2])
        return real(q, *a, **kw)

    monkeypatch.setattr(fa, "flash_attention", counting)
    audio, lens = batch(3)
    got = torch_lp(tp, tcfg, audio, lens, flash=True)
    if family == "sew-d":
        assert calls == []
        return
    t = tcfg.conv_output_length(audio.shape[1])
    assert calls == [t // 2] * tcfg.num_hidden_layers
    np.testing.assert_allclose(got, jax_lp(jp, jcfg, audio, lens, flash=True),
                               atol=F32_LP_ATOL, rtol=0)
    np.testing.assert_allclose(got, torch_lp(tp, tcfg, audio, lens), atol=F32_LP_ATOL, rtol=0)


# --- the entry points on a 20 ms frontend ----------------------------------

ENTRY = {"sew": dict(model_type="sew", **CONV_7), "sew-d": dict(SEW_D, **CONV_7)}
CASES = [(48_000, "the quick brown fox"), (40_000, "jumps over the dog"),
         (30_000, "a lazy dog")]


@pytest.fixture(scope="module", params=sorted(ENTRY))
def entry_model(request):
    jcfg, tcfg, jp, tree = family_models(ENTRY[request.param], seed=7)
    return request.param, jcfg, tcfg, jp, tree


def _assert_same_words(got, want, exact=True):
    assert got and [w.word for w in got] == [w.word for w in want]
    for a, b in zip(got, want):
        if exact:
            assert (a.start_ms, a.end_ms) == (b.start_ms, b.end_ms), (a, b)
        else:
            assert abs(a.start_ms - b.start_ms) <= STRIDE_MS
            assert abs(a.end_ms - b.end_ms) <= STRIDE_MS


def _audios(seed=2):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=n).astype(np.float32) for n, _ in CASES], [t for _, t in CASES]


def test_k1_paths_and_batch_aligner_match_jax(entry_model):
    """K1's paths on a padded batch equal `viterbi_numpy` on the same
    log-probs bit for bit; `BatchAligner` gives JAX's words with equal
    boundaries on the 20 ms grid."""
    _, jcfg, tcfg, jp, tree = entry_model
    tp = torch_params.params_from_jax(tree)
    assert tcfg.frame_stride_ms(16000) == STRIDE_MS
    audios, texts = _audios()
    aligner = BatchAligner(tcfg, tp, VOCAB, compute_dtype="float32", device="cpu")
    n_pad = max(len(a) for a in audios)
    audio = np.zeros((len(audios), n_pad), np.float32)
    for i, a in enumerate(audios):
        audio[i, : len(a)] = normalize_audio(a)
    seqs = [aligner._tokenize(t) for t in texts]
    tokens = np.zeros((len(seqs), 128), np.int32)
    for i, s in enumerate(seqs):
        tokens[i, : len(s.tokens)] = s.tokens
    handles = aligner.submit_padded_batch(
        torch.from_numpy(audio), torch.tensor([len(a) for a in audios], dtype=torch.int32),
        torch.from_numpy(tokens), torch.tensor([len(s.tokens) for s in seqs], dtype=torch.int32),
        return_log_probs=True)
    paths, t_lens, lp = handles[0].numpy(), handles[1].numpy(), handles[-1].numpy()
    for i, s in enumerate(seqs):
        oracle = [st for st, _ in viterbi_numpy(lp[i, : t_lens[i]], np.asarray(s.tokens))]
        assert list(paths[i, : t_lens[i]]) == oracle
    got = aligner.align_utterances(audios, texts, max_batch=2)
    want = JaxBatchAligner(jcfg, jp, VOCAB, compute_dtype="float32") \
        .align_utterances(audios, texts, max_batch=2)
    for g, w, text in zip(got, want, texts):
        assert [x.word for x in g.words] == text.upper().split()
        _assert_same_words(g.words, w.words)


def _write_dir(path, family, tcfg, tree):
    d = {**SMALL, **ENTRY[family]}
    path.mkdir()
    (path / "config.json").write_text(json.dumps(d))
    (path / "vocab.json").write_text(json.dumps(VOCAB))
    flat = torch_params.params_to_hf_flat_dict(tree, tcfg, model_type=d["model_type"])
    prefix = torch_params.HF_PREFIXES[d["model_type"]]
    assert all(k.startswith((prefix, "lm_head.")) for k in flat)
    save_safetensors(path / "model.safetensors", flat)
    return path


def test_builder_and_cli_on_a_model_dir_match_the_batch_entry(entry_model, tmp_path):
    """A `sew.` / `sew_d.` HF-format directory through `ForcedAlignerBuilder`
    and through `alignment_report --device cpu` (textgrid, f32): the batch
    entry's words on the same samples, equal boundaries."""
    family, _, tcfg, _, tree = entry_model
    model_dir = _write_dir(tmp_path / "model", family, tcfg, tree)
    base = tmp_path / "data" / "LibriSpeech" / "test-clean" / "1" / "2"
    base.mkdir(parents=True)
    rng = np.random.default_rng(5)
    lines = []
    for i, (n, text) in enumerate(CASES):
        write_flac(base / f"1-2-{i:04d}.flac",
                   np.clip(rng.normal(size=n) * 3000, -32768, 32767).astype(np.int64), 16000)
        lines.append(f"1-2-{i:04d} {text.upper()}")
    (base / "1-2.trans.txt").write_text("\n".join(lines))
    samples = [read_audio_mono(base / f"1-2-{i:04d}.flac")[0] for i in range(len(CASES))]
    texts = [t for _, t in CASES]
    batch_entry = BatchAligner(tcfg, torch_params.params_from_jax(tree), VOCAB,
                               compute_dtype="float32", device="cpu") \
        .align_utterances(samples, texts)
    files = dict(model_path=str(model_dir / "model.safetensors"),
                 config_path=str(model_dir / "config.json"),
                 vocab_path=str(model_dir / "vocab.json"))
    single = ForcedAlignerBuilder(Wav2Vec2Config(**files, device="cpu")).build()
    assert port_cli(["--model-dir", str(model_dir), "--dataset-root", str(tmp_path / "data"),
                     "--device", "cpu", "--compute-dtype", "float32",
                     "--output-format", "textgrid"]) == 0
    for i, (s, text, want) in enumerate(zip(samples, texts, batch_entry)):
        assert [w.word for w in want.words] == text.upper().split()
        _assert_same_words(single.align(AlignmentInput(16000, s, text)).words, want.words)
        tier = parse_textgrid_file(base / f"1-2-{i:04d}.TextGrid").tier("words")
        words = [iv for iv in tier.intervals if iv.text.strip()]
        assert [iv.text for iv in words] == [w.word for w in want.words]
        for iv, w in zip(words, want.words):
            assert (round(iv.xmin * 1000), round(iv.xmax * 1000)) == (w.start_ms, w.end_ms)
