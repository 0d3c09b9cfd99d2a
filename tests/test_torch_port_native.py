"""PyTorch port: the native C++ grouping engine's binding, on the CPU.

- The port's binding (its own build of `native/grouping.cpp` under
  `build/torch_native/`) is bit-identical to the port's Python path on the
  golden corpus and on randomized cases (the `tests/test_native_grouping.py`
  pattern), and to the JAX package's native engine on the same inputs.
- `NATIVE_GROUPING`: "off" forces the Python path, "require" raises where
  the library is unavailable, and a `measure` hook runs the Python path,
  as in the JAX package. The batch engine's drain runs the native engine.
- `utils.native_build` compiles into its build directory, skips an
  up-to-date library, rebuilds after a newer source, and two processes
  that build at once both load a whole library.

The JAX package's loaders build their libraries inside `native/` with
`make`, without a lock, and the grouping loader gives up for good on its
first error. Test files run in parallel processes, so one process could
load a library another was still writing. `private_jax_natives` (a
module fixture here and in every port test file that reaches a JAX
loader) builds the JAX package's engine and FLAC decoder with the port's
locked builder into a directory of the module's own and points the JAX
loaders at it for the module.
"""

import contextlib
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from wav2vec2_tpu.align import grouping as jax_grouping
from wav2vec2_tpu.align.grouping import native as jax_native
from wav2vec2_tpu.data import flac as jax_flac
from wav2vec2_tpu_torch.align import grouping
from wav2vec2_tpu_torch.align.grouping import (
    frame_evidence_from_log_probs,
    group_into_words_profiled,
)
from wav2vec2_tpu_torch.align.grouping import native as native_mod
from wav2vec2_tpu_torch.align.tokenization import build_token_sequence_case_aware
from wav2vec2_tpu_torch.config import AlignerHyperParams, ExpansionPolicyConfig
from wav2vec2_tpu_torch.ops.viterbi_ref import viterbi_numpy
from wav2vec2_tpu_torch.utils import native_build

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tests" / "golden"))
from generate_golden import BLANK_ID, CASE_EXTRAS, CASES, SEP_ID, STRIDE_MS, VOCAB, synth_log_probs  # noqa: E402


# the JAX loaders: (module, the library it loads, the attributes saved and restored)
_JAX_LOADERS = ((jax_native, "grouping", ("_NATIVE_DIR", "_LIB_PATH", "_lib", "_lib_failed")),
                (jax_flac, "flacdec", ("_NATIVE_DIR", "_LIB_PATH", "_lib")))


@contextlib.contextmanager
def jax_natives_in(directory: Path):
    """Build the JAX package's grouping engine and FLAC decoder from
    `native/` with `utils.native_build` (file lock, temp name renamed into
    place, the Makefile's flags) into `directory`, and point the JAX
    loaders there, with no library loaded and no failure recorded, until
    the block ends; then restore every attribute. The loaders find no
    source in `directory`, so they never run `make`."""
    build_dir, native_build.BUILD_DIR = native_build.BUILD_DIR, Path(directory)
    try:
        libs = {name: native_build.build(name) for _, name, _ in _JAX_LOADERS}
    finally:
        native_build.BUILD_DIR = build_dir
    saved = [(mod, attr, getattr(mod, attr)) for mod, _, attrs in _JAX_LOADERS
             for attr in attrs]
    try:
        for mod, name, attrs in _JAX_LOADERS:
            mod._NATIVE_DIR, mod._LIB_PATH, mod._lib = Path(directory), libs[name], None
            if "_lib_failed" in attrs:
                mod._lib_failed = False
        yield
    finally:
        for mod, attr, value in saved:
            setattr(mod, attr, value)


@pytest.fixture(scope="module", autouse=True)
def private_jax_natives(tmp_path_factory):
    with jax_natives_in(tmp_path_factory.mktemp("jax_native")):
        yield


def _lp(rng, t_len, scale=1.0):
    logits = rng.normal(0, scale, size=(t_len, 33))
    return (logits - np.log(np.exp(logits).sum(1, keepdims=True))).astype(np.float32)


def _group(module, engine, transcript, lp, hp, path_as_array=False):
    seq = build_token_sequence_case_aware(transcript, VOCAB, BLANK_ID, SEP_ID)
    path = viterbi_numpy(lp, np.asarray(seq.tokens))
    states = np.asarray([s for s, _ in path], np.int32)
    ev = frame_evidence_from_log_probs(lp, seq.tokens, states, BLANK_ID)
    prev = module.NATIVE_GROUPING
    try:
        module.NATIVE_GROUPING = engine
        return module.group_into_words_profiled(
            states if path_as_array else path, seq.tokens, seq.chars,
            seq.normalized_words, ev, BLANK_ID, SEP_ID, STRIDE_MS, hp,
        ).words
    finally:
        module.NATIVE_GROUPING = prev


def _as_dicts(words):
    return [dataclasses.asdict(w) for w in words]


def _assert_native_is_python(transcript, lp, hp=None):
    hp = hp or AlignerHyperParams()
    calls = dict(grouping.engine_calls)
    nat = _group(grouping, "require", transcript, lp, hp)
    nat_array = _group(grouping, "require", transcript, lp, hp, path_as_array=True)
    py = _group(grouping, "off", transcript, lp, hp)
    assert grouping.engine_calls["native"] == calls["native"] + 2
    assert grouping.engine_calls["python"] == calls["python"] + 1
    assert _as_dicts(nat) == _as_dicts(py) == _as_dicts(nat_array)
    jax_nat = _group(jax_grouping, "require", transcript, lp, hp)
    assert _as_dicts(jax_nat) == _as_dicts(nat)
    return nat


def test_native_library_builds_under_build_torch_native():
    assert native_mod.native_available()
    assert native_build.library_path("grouping") == REPO / "build" / "torch_native" / "libgrouping.so"
    assert native_build.library_path("grouping").exists()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_native_matches_python_on_golden_corpus(case):
    case_id, transcript, t_len, seed, noise, signal, smear = case
    seq = build_token_sequence_case_aware(transcript, VOCAB, BLANK_ID, SEP_ID)
    lp = synth_log_probs(seq.tokens, t_len, seed, noise, signal, smear,
                         **CASE_EXTRAS.get(case_id, {}))
    assert _assert_native_is_python(transcript, lp)


@pytest.mark.parametrize("trial", range(12))
def test_native_matches_python_randomized(trial):
    rng = np.random.default_rng(100 + trial)
    words = ["THE", "CAT", "SAT", "ON", "A", "MAT", "BOOKKEEPER", "LLAMA", "IT'S"]
    transcript = " ".join(rng.choice(words, size=int(rng.integers(1, 7))))
    seq = build_token_sequence_case_aware(transcript, VOCAB, BLANK_ID, SEP_ID)
    t_len = int(rng.integers(len(seq.tokens) // 2 + 1, 200))
    budgets = tuple(int(x) for x in rng.integers(0, 20, size=3))
    hp = AlignerHyperParams(expansion_policies=(
        ExpansionPolicyConfig("balanced", *budgets),
        ExpansionPolicyConfig("conservative_start", 10, 2, 6),
        ExpansionPolicyConfig("aggressive_tail", 16, 4, 2),
    ))
    _assert_native_is_python(transcript, _lp(rng, t_len, rng.uniform(0.5, 3.0)), hp)


def test_comparison_holds_after_the_jax_loader_failed(tmp_path, monkeypatch):
    """A worker whose JAX grouping loader already failed (it keeps
    `_lib_failed` for good, so `require` raises) still compares: the private
    build resets the loader, and the old state comes back after the block."""
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_lib_failed", True)
    lp = _lp(np.random.default_rng(7), 80)
    with pytest.raises(RuntimeError, match="native grouping required"):
        _group(jax_grouping, "require", "THE CAT", lp, AlignerHyperParams())
    with jax_natives_in(tmp_path):
        assert jax_native._LIB_PATH == tmp_path / "libgrouping.so"
        assert [w.word for w in _assert_native_is_python("THE CAT", lp)] == ["THE", "CAT"]
        assert jax_native._lib is not None and not jax_native._lib_failed
    assert jax_native._lib is None and jax_native._lib_failed


def test_native_off_and_measure_hook_use_python(monkeypatch):
    called = []
    monkeypatch.setattr(native_mod, "group_into_words_native",
                        lambda *a, **k: called.append(1))
    rng = np.random.default_rng(0)
    lp = _lp(rng, 60)
    assert [w.word for w in _group(grouping, "off", "THE CAT", lp, AlignerHyperParams())] \
        == ["THE", "CAT"]
    seq = build_token_sequence_case_aware("A", VOCAB, BLANK_ID, SEP_ID)
    lp = _lp(rng, 20)
    path = viterbi_numpy(lp, np.asarray(seq.tokens))
    ev = frame_evidence_from_log_probs(lp, seq.tokens, [s for s, _ in path], 0)
    stages = []
    out = group_into_words_profiled(
        path, seq.tokens, seq.chars, seq.normalized_words, ev, BLANK_ID, SEP_ID, STRIDE_MS,
        measure=lambda name, fn: (stages.append(name), fn())[1],
    )
    assert not called
    assert stages == ["conf"] and [w.word for w in out.words] == ["A"]


def test_native_require_raises_when_unavailable(monkeypatch):
    monkeypatch.setattr(native_mod, "_lib", None)
    monkeypatch.setattr(native_mod, "_lib_failed", True)
    lp = _lp(np.random.default_rng(1), 40)
    with pytest.raises(RuntimeError, match="native grouping required"):
        _group(grouping, "require", "THE CAT", lp, AlignerHyperParams())
    # "auto" falls back to the Python path
    assert [w.word for w in _group(grouping, "auto", "THE CAT", lp, AlignerHyperParams())] \
        == ["THE", "CAT"]


def test_batch_drain_runs_the_native_engine():
    import jax

    from wav2vec2_tpu.config import Wav2Vec2ModelConfig as JaxCfg
    from wav2vec2_tpu.models.params import init_params
    from wav2vec2_tpu_torch import BatchAligner
    from wav2vec2_tpu_torch.config import Wav2Vec2ModelConfig
    from wav2vec2_tpu_torch.models.params import params_from_jax

    cfg_dict = dict(hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
                    intermediate_size=64, conv_dim=[16, 16], conv_kernel=[10, 3],
                    conv_stride=[5, 2], num_conv_pos_embeddings=16,
                    num_conv_pos_embedding_groups=4, pad_token_id=0, vocab_size=33,
                    feat_extract_norm="group", conv_bias=False)
    params = params_from_jax(jax.tree.map(np.asarray, init_params(
        JaxCfg.from_dict(cfg_dict), jax.random.PRNGKey(0))))
    aligner = BatchAligner(Wav2Vec2ModelConfig.from_dict(cfg_dict), params, VOCAB,
                           compute_dtype="float32", device="cpu")
    rng = np.random.default_rng(2)
    audios = [rng.normal(size=n).astype(np.float32) for n in (2000, 3000)]
    before = dict(grouping.engine_calls)
    outs = aligner.align_utterances(audios, ["THE CAT", "ON A MAT"], audio_multiple=1000)
    assert grouping.engine_calls["native"] == before["native"] + 2
    assert grouping.engine_calls["python"] == before["python"]
    assert [[w.word for w in o.words] for o in outs] == [["THE", "CAT"], ["ON", "A", "MAT"]]


@pytest.fixture
def scratch_build(tmp_path, monkeypatch):
    """native_build pointed at a copy of the grouping source and an empty
    build directory."""
    src = tmp_path / "grouping.cpp"
    src.write_bytes(native_build.SOURCES["grouping"].read_bytes())
    monkeypatch.setattr(native_build, "SOURCES", {"grouping": src})
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "build")
    return src, tmp_path / "build" / "libgrouping.so"


def test_native_build_rebuilds_only_when_the_source_is_newer(scratch_build):
    src, lib = scratch_build
    assert native_build.build("grouping") == lib and lib.exists()
    stamp = lib.stat().st_mtime_ns
    native_build.build("grouping")
    assert lib.stat().st_mtime_ns == stamp
    later = stamp + 10**9
    os.utime(src, ns=(later, later))
    native_build.build("grouping")
    assert lib.stat().st_mtime_ns > stamp
    assert not list(lib.parent.glob("*.tmp.so"))
    assert native_build.load("grouping").group_words_native


def test_native_build_in_parallel_processes(scratch_build):
    src, lib = scratch_build
    script = (
        "import sys; from pathlib import Path; sys.path.insert(0, sys.argv[1]);"
        "from wav2vec2_tpu_torch.utils import native_build as nb;"
        "nb.SOURCES = {'grouping': Path(sys.argv[2])}; nb.BUILD_DIR = Path(sys.argv[3]);"
        "print(nb.load('grouping').group_words_native is not None)"
    )
    procs = [subprocess.Popen([sys.executable, "-c", script, str(REPO), str(src),
                               str(lib.parent)], stdout=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=300)[0].strip() for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0] and outs == ["True"] * 3
    assert not list(lib.parent.glob("*.tmp.so"))
