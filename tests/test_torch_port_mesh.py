"""PyTorch port vs the JAX package: the device mesh (`parallel/mesh.py`) and
the entry points that take one (`BatchAligner`, `align_longform`,
`make_train_step`), on the CPU.

The port is SPMD: one process per rank under `torch.distributed`. Here the
ranks are spawned processes on the CPU under gloo (a `FileStore` in
`tmp_path`, one thread each), and the JAX package runs on conftest's 8
virtual CPU devices in this process. Two spawned worlds: 8 ranks run the
ten phases of `__graft_entry__.dryrun_multichip` (same configs, same
meshes: (4×2), WavLM + adapters at (2×4)) and the other mesh cases, 4 ranks
run K5 under a (2×2) mesh. Each rank writes what it got; every rank must
get the same full result.

- `param_shardings`: the port's spec tuple of every leaf equals JAX's
  `PartitionSpec` on a (4×2) mesh, for every preset (JAX shape trees, no
  weights) and an int8 tree (no process group needed).
- Each phase: the loss is finite, `step == 1`, and the sharded
  `BatchAligner` gives the unsharded one's words and ms. Phases 1, 4 and 10
  train at f32 and their loss is within 1e-5 relative of the JAX step's on
  its 8-device mesh, on the same numpy params and batch; the others train at
  bf16, as the dryrun does.
- `BatchAligner(mesh)` on 5 rows over 'data' = 4, host-staged and
  tensor-staged: every output equal to the unsharded port's (paths and
  lengths exact, evidence within 1e-5) and paths equal to the JAX engine's.
- K5 under (2×2) (its plain version on the CPU) within 1e-5 of the
  unsharded call, JAX's ValueError where the mesh does not divide the batch
  or the heads; the K1–K4 wrapper refuses a DTensor.
- `align_longform(mesh)` at (8×1): the words and ms of `mesh=None`, and the
  JAX mesh run's words.
- `make_train_step(mesh)` at (4×2) and (2×4): the loss within 1e-5
  relative of the unsharded port step's, each leaf's gradient within 5e-5
  of it relative to the leaf's gradient norm (‖Δ‖₂ ≤ 5e-5·max(‖g‖₂, 1e-3 ×
  the largest leaf's); k_proj's bias, 0 in exact arithmetic, holds
  rounding noise alone, hence the floor). 5e-5 is five times the f32
  step's own floor on these inputs: the unsharded f32 gradients are
  9.9e-6 from an f64 step's by this measure, a one-ulp change of the
  weights moves them by 1.1e-5, and the tensor-parallel split (each row's
  sums over heads and over F in another order) lands at 1.03e-5, where
  splitting the batch alone gives 1.5e-6. Tensor-parallel leaves keep
  their placements through the step, and K5 is never reached.
- int8 serving under (4×2), from placed f32 weights and from an int8
  tree placed by JAX's rule: the unsharded int8 aligner's outputs.
- One row on a (1×8) mesh, whose 'data' axis is 1 (the batch then stays
  whole on it): `BatchAligner`, `align_longform` and a train step give
  the unsharded results.
"""

import os
import pickle
import traceback

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from wav2vec2_tpu_torch.config import Wav2Vec2ModelConfig as TorchCfg
from wav2vec2_tpu_torch.models import params as torch_params
from wav2vec2_tpu_torch.parallel import mesh as tmesh
from wav2vec2_tpu_torch.parallel.batching import BatchAligner

VOCAB = {"a": 1, "b": 2, "|": 3, "c": 4}
BASE = dict(
    hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
    intermediate_size=3072, conv_dim=[512] * 7,
    conv_kernel=[10, 3, 3, 3, 3, 2, 2], conv_stride=[5, 2, 2, 2, 2, 2, 2],
    num_conv_pos_embeddings=128, num_conv_pos_embedding_groups=16,
    pad_token_id=0, vocab_size=32, do_stable_layer_norm=False,
    feat_extract_norm="group", conv_bias=False,
)
TINY = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=64, conv_dim=[16, 16], conv_kernel=[10, 3],
            conv_stride=[5, 2], num_conv_pos_embeddings=16,
            num_conv_pos_embedding_groups=4, vocab_size=16)
CONFORMER = dict(TINY, model_type="wav2vec2-conformer",
                 position_embeddings_type="relative", hidden_act="swish",
                 conv_depthwise_kernel_size=7)
# (name, config overrides, model axis, train_n, align_n, flash): the ten
# phases of __graft_entry__.dryrun_multichip(8)
PHASES = [
    ("wav2vec2", TINY, 2, 800, 3000, False),
    ("wavlm+adapters", dict(TINY, num_attention_heads=4, model_type="wavlm",
                            num_buckets=16, max_bucket_distance=50, adapter_attn_dim=8),
     4, 800, 3000, False),
    ("sew-d", dict(TINY, model_type="sew-d", squeeze_factor=2, position_buckets=8,
                   max_position_embeddings=16), 2, 800, 3000, False),
    ("conformer", CONFORMER, 2, 800, 3000, False),
    ("w2v-bert", dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                      intermediate_size=64, vocab_size=16, model_type="wav2vec2-bert",
                      position_embeddings_type="relative_key",
                      left_max_position_embeddings=8, right_max_position_embeddings=2,
                      conv_depthwise_kernel_size=7, hidden_act="swish",
                      add_adapter=True, num_adapter_layers=1), 2, 12800, 12000, False),
    ("sew", dict(TINY, conv_dim=[16, 16, 16], conv_kernel=[10, 3, 1],
                 conv_stride=[5, 2, 1], model_type="sew", squeeze_factor=2),
     2, 800, 3000, False),
    ("data2vec", dict(TINY, model_type="data2vec-audio", num_conv_pos_embeddings=2,
                      conv_pos_kernel_size=5, feat_extract_norm="layer", conv_bias=True),
     2, 800, 3000, False),
    ("mhubert", dict(TINY, conv_pos_batch_norm=True, feat_proj_layer_norm=True),
     2, 800, 3000, False),
    ("wav2vec2+glu-adapter", dict(TINY, do_stable_layer_norm=True, feat_extract_norm="layer",
                                  conv_bias=True, add_adapter=True, adapter_kernel_size=3,
                                  adapter_stride=2, num_adapter_layers=2),
     2, 3200, 12000, False),
    ("conformer+flash", CONFORMER, 2, 800, 3000, True),
]
F32_PHASES = {"wav2vec2", "conformer", "conformer+flash"}
N_RANKS = 8


def _config(over: dict) -> dict:
    d = dict(BASE, **over)
    if over.get("model_type") == "wav2vec2-bert":
        for k in ("conv_dim", "conv_kernel", "conv_stride", "num_conv_pos_embeddings",
                  "num_conv_pos_embedding_groups"):
            d.pop(k)
    return d


def _phase_batch(b: int, train_n: int, vocab_size: int, align_n: int):
    """The dryrun's batch: train audio, lengths, labels, label lengths, then
    the utterances and transcripts it aligns (numpy's generator, seed 0)."""
    rng = np.random.default_rng(0)
    train = (rng.normal(size=(b, train_n)).astype(np.float32),
             np.full(b, train_n, np.int32),
             rng.integers(1, vocab_size, size=(b, 8)).astype(np.int32),
             np.full(b, 8, np.int32))
    audios = [rng.normal(size=align_n).astype(np.float32) for _ in range(b)]
    transcripts = (["ab ca", "ba", "ab", "ca ab"] * ((b + 3) // 4))[:b]
    return train, audios, transcripts


def _words(outputs):
    return [[(w.word, w.start_ms, w.end_ms) for w in o.words] for o in outputs]


# ---------------------------------------------------------------- the ranks
# Run in spawned processes: they import this module, which imports no JAX.


def _job_phase(mesh_axes, spec):
    from wav2vec2_tpu_torch.ops import flash_attention as fa
    from wav2vec2_tpu_torch.parallel.train import (
        init_train_state,
        make_optimizer,
        make_train_step,
    )

    name, over, model, train_n, align_n, flash = spec["phase"]
    cfg = TorchCfg.from_dict(_config(over))
    mesh = tmesh.make_mesh(model=model, device="cpu")
    tx = make_optimizer()
    state = init_train_state(tmesh.shard_params(
        torch_params.params_from_jax(spec["train_params"]), mesh), tx)
    train, audios, transcripts = _phase_batch(spec["b"], train_n, cfg.vocab_size, align_n)
    train = tmesh.distribute_rows(mesh, *train)
    dtype = torch.float32 if name in F32_PHASES else torch.bfloat16
    state, loss = make_train_step(cfg, tx, mesh=mesh, compute_dtype=dtype)(state, *train)
    infer = torch_params.params_from_jax(spec["infer_params"])
    aligner = BatchAligner(cfg, infer, VOCAB, compute_dtype="float32", device="cpu",
                           mesh=mesh, use_flash_attention=True if flash else None)
    calls = []
    real = fa.flash_attention
    fa.flash_attention = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        out = aligner.align_utterances(audios, transcripts, audio_multiple=500,
                                       token_multiple=16)
    finally:
        fa.flash_attention = real
    return {"loss": float(loss.full_tensor()), "step": state.step, "words": _words(out),
            "flash_spmd": getattr(aligner.cfg, "flash_spmd", None) is not None,
            "flash_calls": len(calls)}


def _job_uneven(mesh_axes, spec):
    cfg = TorchCfg.from_dict(_config(TINY))
    mesh = tmesh.make_mesh(model=2, device="cpu")
    params = tmesh.shard_params(torch_params.params_from_jax(spec["params"]), mesh)
    aligner = BatchAligner(cfg, params, VOCAB, compute_dtype="float32", device="cpu",
                           mesh=mesh)
    host = aligner.align_padded_batch(*spec["batch"])
    staged = aligner.align_padded_batch(*(torch.from_numpy(a) for a in spec["batch"]))
    return {"host": host, "staged": staged}


def _job_longform(mesh_axes, spec):
    from wav2vec2_tpu_torch.align.longform import align_longform

    cfg = TorchCfg.from_dict(_config(TINY))
    mesh = tmesh.make_mesh(model=1, device="cpu")
    out = align_longform(spec["audio"], spec["transcript"],
                         torch_params.params_from_jax(spec["params"]), cfg, VOCAB,
                         chunk_sec=1.0, overlap_sec=0.25, device="cpu", mesh=mesh)
    return {"words": _words([out])[0]}


def _job_train(mesh_axes, spec):
    from wav2vec2_tpu_torch.ops import flash_attention as fa
    from wav2vec2_tpu_torch.parallel.train import (
        init_train_state,
        make_optimizer,
        make_train_step,
        tree_leaves,
    )

    cfg = TorchCfg.from_dict(_config(spec["config"]))
    mesh = tmesh.make_mesh(model=spec["model"], device="cpu")
    tx = make_optimizer()
    state = init_train_state(tmesh.shard_params(
        torch_params.params_from_jax(spec["params"]), mesh), tx)
    before = [p.placements for p in tree_leaves(state.params)]

    def refuse(*a, **k):
        raise AssertionError("K5 reached in a train step")

    real, fa.flash_attention = fa.flash_attention, refuse
    try:
        state, loss = make_train_step(cfg, tx, mesh=mesh, compute_dtype=torch.float32)(
            state, *spec["batch"])
    finally:
        fa.flash_attention = real
    leaves = tree_leaves(state.params)
    return {"loss": float(loss.full_tensor()),
            "grads": [p.grad.full_tensor().numpy() for p in leaves],
            "params": [p.full_tensor().detach().numpy() for p in leaves],
            "placements": [str(p.placements) for p in leaves],
            "kept": [p.placements for p in leaves] == before,
            "q_spec": str(state.params["encoder"]["layers"]["attention"]["q_proj"]
                          ["kernel"].placements)}


def _job_flash(mesh_axes, spec):
    from torch.distributed.tensor import Replicate, Shard

    from wav2vec2_tpu_torch.ops import flash_attention as fa
    from wav2vec2_tpu_torch.ops import viterbi_cuda

    mesh = tmesh.make_mesh(model=2, device="cpu")
    q, k, v, q_pos, rel_r, mask = (torch.from_numpy(a) for a in spec["inputs"])
    tile, rows = (Shard(0), Shard(1)), tmesh.batch_sharding(mesh)
    dq, dk, dv, dqp = (tmesh.distribute(x, mesh, tile) for x in (q, k, v, q_pos))
    out = {}
    with torch.no_grad():
        sharded = fa.flash_attention(dq, dk, dv, tmesh.distribute(mask, mesh, rows),
                                     q_pos=dqp, rel_r=tmesh.distribute(rel_r, mesh,
                                                                      (Replicate(), Shard(0))),
                                     scale=0.125, spmd_mesh=mesh)
        out["placements"] = str(sharded.placements)
        out["sharded"] = sharded.full_tensor().numpy()
        # plain tensors under spmd_mesh: the same tiles
        out["plain_under_mesh"] = fa.flash_attention(
            q, k, v, mask, q_pos=q_pos, rel_r=rel_r, scale=0.125, spmd_mesh=mesh).numpy()
    for case, (qq, vv) in {"batch": (q[:3], v[:3]), "heads": (q[:, :3], v[:, :3])}.items():
        try:
            fa.flash_attention(qq, qq, vv, spmd_mesh=mesh)
            out[case] = None
        except ValueError as e:
            out[case] = str(e)
    lp = tmesh.distribute(torch.zeros(4, 8, 5), mesh, rows)
    ints = [tmesh.distribute(torch.zeros(4, *s, dtype=torch.int32), mesh, rows)
            for s in ((4,), (), ())]
    try:
        viterbi_cuda.viterbi_batch(lp, *ints)
        out["k1_dtensor"] = None
    except TypeError as e:
        out["k1_dtensor"] = str(e)
    return out


def _job_one_row(mesh_axes, spec):
    """A batch of one row on a mesh whose 'data' axis is 1 (1×8): one
    utterance through `BatchAligner`, a recording of one chunk through
    `align_longform`, and a train step on one row."""
    from wav2vec2_tpu_torch.align.longform import align_longform
    from wav2vec2_tpu_torch.parallel.train import (
        init_train_state,
        make_optimizer,
        make_train_step,
    )

    cfg = TorchCfg.from_dict(_config(ONE_ROW))
    mesh = tmesh.make_mesh(model=N_RANKS, device="cpu")
    params = tmesh.shard_params(torch_params.params_from_jax(spec["params"]), mesh)
    aligner = BatchAligner(cfg, params, VOCAB, compute_dtype="float32", device="cpu",
                           mesh=mesh)
    audio, text, train = _one_row_inputs()
    out = {"align": _words(aligner.align_utterances([audio], [text])),
           "longform": _words([align_longform(audio, text, params, cfg, VOCAB,
                                              device="cpu", mesh=mesh)])}
    tx = make_optimizer()
    _, loss = make_train_step(cfg, tx, mesh=mesh, compute_dtype=torch.float32)(
        init_train_state(params, tx), *train)
    out["train"] = float(loss.full_tensor())
    return out


def _job_int8(mesh_axes, spec):
    """int8 serving under (4×2), quantized by the aligner from placed f32
    weights, or an int8 tree placed by JAX's rule (q/k/v `kernel_q` split
    on the input axis)."""
    from wav2vec2_tpu_torch.models.quantize import quantize_encoder_int8

    cfg = TorchCfg.from_dict(_config(TINY))
    mesh = tmesh.make_mesh(model=2, device="cpu")
    params = torch_params.params_from_jax(spec["params"])
    if spec["tree"] == "int8":
        aligner = BatchAligner(cfg, tmesh.shard_params(quantize_encoder_int8(params), mesh),
                               VOCAB, compute_dtype="float32", device="cpu", mesh=mesh)
    else:
        aligner = BatchAligner(cfg, tmesh.shard_params(params, mesh), VOCAB,
                               compute_dtype="float32", device="cpu", mesh=mesh,
                               quantize_int8=True)
    return aligner.align_padded_batch(*UNEVEN_BATCH)


JOBS = {"phase": _job_phase, "uneven": _job_uneven, "longform": _job_longform,
        "train": _job_train, "flash": _job_flash, "one row": _job_one_row,
        "int8": _job_int8}


def _rank_main(rank, world, store, jobs_path, out_dir):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    with open(jobs_path, "rb") as f:
        jobs = pickle.load(f)
    results = {}
    for key, (kind, spec) in jobs.items():
        try:
            results[key] = JOBS[kind](None, spec)
        except Exception:
            results[key] = {"error": traceback.format_exc()}
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    dist.destroy_process_group()


def _spawn(tmp, world: int, jobs: dict) -> list[dict]:
    """Run `jobs` on `world` gloo ranks; each rank's {key: result}."""
    tmp.mkdir(parents=True, exist_ok=True)
    jobs_path = tmp / "jobs.pkl"
    with open(jobs_path, "wb") as f:
        pickle.dump(jobs, f)
    mp.spawn(_rank_main, args=(world, str(tmp / "store"), str(jobs_path), str(tmp)),
             nprocs=world)
    out = []
    for r in range(world):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _same_on_every_rank(ranks: list[dict], key: str):
    """The rank-0 result for `key`, after checking every rank got it too."""
    first = ranks[0][key]
    assert not (isinstance(first, dict) and "error" in first), first.get("error")
    for r, res in enumerate(ranks[1:], 1):
        assert pickle.dumps(res[key]) == pickle.dumps(first), (key, r)
    return first


# ------------------------------------------------------------ the JAX side


def _np_tree(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def _jax_params(over: dict, seed: int):
    import jax

    from wav2vec2_tpu.config import Wav2Vec2ModelConfig as JaxCfg
    from wav2vec2_tpu.models.params import init_params

    return _np_tree(init_params(JaxCfg.from_dict(_config(over)), jax.random.PRNGKey(seed)))


UNEVEN_BATCH = (
    np.random.default_rng(3).normal(size=(5, 3000)).astype(np.float32),
    np.array([3000, 2800, 2600, 3000, 2000], np.int32),
    np.random.default_rng(4).integers(1, 5, size=(5, 16)).astype(np.int32),
    np.array([5, 4, 3, 5, 2], np.int32),
)
LONGFORM_AUDIO = np.random.default_rng(5).normal(size=48_000).astype(np.float32)
LONGFORM_TEXT = "ab ba ab ba ab"
TRAIN_CASES = {"4x2": (TINY, 2), "2x4": (dict(TINY, num_attention_heads=4), 4)}
ONE_ROW = dict(TINY, num_attention_heads=8)
INT8_TREES = ("f32", "int8")


def _one_row_inputs():
    rng = np.random.default_rng(9)
    return (rng.normal(size=6000).astype(np.float32), "ab ba",
            (rng.normal(size=(1, 800)).astype(np.float32), np.full(1, 800, np.int32),
             rng.integers(1, 16, size=(1, 8)).astype(np.int32), np.full(1, 8, np.int32)))


def _train_batch():
    rng = np.random.default_rng(7)
    return (rng.normal(size=(8, 800)).astype(np.float32), np.full(8, 800, np.int32),
            rng.integers(1, 16, size=(8, 8)).astype(np.int32), np.full(8, 8, np.int32))


@pytest.fixture(scope="module")
def mesh_world(tmp_path_factory):
    """Every 8-rank job in one spawned world, with the inputs it needs."""
    jobs = {}
    for phase in PHASES:
        b = max(2 * (N_RANKS // phase[2]), 4)
        jobs[phase[0]] = ("phase", {"phase": phase, "b": b,
                                    "train_params": _jax_params(phase[1], 0),
                                    "infer_params": _jax_params(phase[1], 1)})
    tiny = _jax_params(TINY, 1)
    jobs["uneven"] = ("uneven", {"params": tiny, "batch": UNEVEN_BATCH})
    jobs["longform"] = ("longform", {"params": tiny, "audio": LONGFORM_AUDIO,
                                     "transcript": LONGFORM_TEXT})
    for key, (over, model) in TRAIN_CASES.items():
        jobs[f"train {key}"] = ("train", {"config": dict(over, use_flash_attention=True),
                                          "model": model, "params": _jax_params(over, 0),
                                          "batch": _train_batch()})
    jobs["one row"] = ("one row", {"params": _jax_params(ONE_ROW, 2)})
    for tree in INT8_TREES:
        jobs[f"int8 {tree}"] = ("int8", {"params": tiny, "tree": tree})
    return _spawn(tmp_path_factory.mktemp("mesh8"), N_RANKS, jobs)


# ------------------------------------------------------------------- tests


def _jax_spec_tree(tree):
    """JAX's param_shardings on a (4×2) mesh of the virtual devices, as
    {path: spec tuple}."""
    import jax

    from wav2vec2_tpu.parallel.mesh import make_mesh, param_shardings

    shardings = param_shardings(tree, make_mesh(8, model=2))
    flat = jax.tree_util.tree_flatten_with_path(shardings)[0]
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path): tuple(s.spec)
            for path, s in flat}


def _port_spec_tree(tree):
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (i,))
        else:
            out[path] = tmesh.spec_for(path, len(node.shape))

    walk(tree, ())
    return out


def _spec_tuple(spec: tuple) -> tuple:
    """A PartitionSpec tuple without its trailing Nones, as the port's."""
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def _preset_names():
    from wav2vec2_tpu_torch.models.presets import PRESETS

    return sorted(PRESETS)


@pytest.mark.parametrize("preset", _preset_names())
def test_param_shardings_equal_jax_for_every_preset(preset):
    import jax

    from wav2vec2_tpu.models import presets as jax_presets
    from wav2vec2_tpu.models.params import init_params

    cfg = jax_presets.PRESETS[preset](32)
    shapes = jax.eval_shape(lambda: init_params(cfg, jax.random.PRNGKey(0)))
    want = _jax_spec_tree(shapes)
    got = _port_spec_tree(shapes)
    assert set(got) == set(want)
    for path in want:
        assert _spec_tuple(got[path]) == _spec_tuple(want[path]), (path, got[path], want[path])
    assert any("model" in s for s in got.values())


def test_param_shardings_equal_jax_on_an_int8_tree():
    """On an int8 tree the q/k/v leaves are `kernel_q`, which JAX's rule
    gives the bias spec (None, 'model'): the port's rule gives the same."""
    import jax

    from wav2vec2_tpu.models import quantize as jq
    from wav2vec2_tpu.models.params import init_params
    from wav2vec2_tpu.config import Wav2Vec2ModelConfig as JaxCfg
    from wav2vec2_tpu_torch.models import quantize as tq

    over = dict(TINY, num_hidden_layers=2, adapter_attn_dim=4)
    jtree = jq.quantize_encoder_int8(init_params(JaxCfg.from_dict(_config(over)),
                                                 jax.random.PRNGKey(0)))
    ttree = tq.quantize_encoder_int8(torch_params.params_from_jax(_np_tree(
        init_params(JaxCfg.from_dict(_config(over)), jax.random.PRNGKey(0)))))
    want, got = _jax_spec_tree(jtree), _port_spec_tree(ttree)
    assert set(got) == set(want)
    for path in want:
        assert _spec_tuple(got[path]) == _spec_tuple(want[path]), path
    q = ("encoder", "layers", "attention", "q_proj", "kernel_q")
    assert want[q] == (None, "model") and got[q] == (None, "model")
    placements = tmesh.param_shardings(ttree, None)["encoder"]["layers"]["attention"]
    assert placements["q_proj"]["kernel_q"][1].is_shard(1)
    assert placements["out_proj"]["kernel_q"][1].is_shard(1)


def test_make_mesh_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh(device="cuda")


def _jax_f32_loss(over: dict, b: int, train_n: int):
    import jax
    import jax.numpy as jnp

    from wav2vec2_tpu.config import Wav2Vec2ModelConfig as JaxCfg
    from wav2vec2_tpu.models.params import init_params
    from wav2vec2_tpu.parallel.mesh import batch_sharding, make_mesh, shard_params
    from wav2vec2_tpu.parallel.train import init_train_state, make_optimizer, make_train_step

    cfg = JaxCfg.from_dict(_config(over))
    mesh = make_mesh(8, model=2)
    tx = make_optimizer()
    state = init_train_state(shard_params(init_params(cfg, jax.random.PRNGKey(0)), mesh), tx)
    train, _, _ = _phase_batch(b, train_n, cfg.vocab_size, 1)
    batch = [jax.device_put(a, batch_sharding(mesh)) for a in train]
    with mesh:
        _, loss = make_train_step(cfg, tx, mesh=mesh, compute_dtype=jnp.float32)(state, *batch)
    return float(loss)


@pytest.mark.parametrize("phase", PHASES, ids=[p[0] for p in PHASES])
def test_dryrun_phase(mesh_world, phase):
    """One phase of dryrun_multichip on the port: a train step under the
    mesh, then the sharded aligner against the unsharded one."""
    name, over, model, train_n, align_n, flash = phase
    res = _same_on_every_rank(mesh_world, name)
    assert np.isfinite(res["loss"]), res["loss"]
    assert res["step"] == 1
    cfg = TorchCfg.from_dict(_config(over))
    b = max(2 * (N_RANKS // model), 4)
    _, audios, transcripts = _phase_batch(b, train_n, cfg.vocab_size, align_n)
    plain = BatchAligner(cfg, torch_params.params_from_jax(_jax_params(over, 1)), VOCAB,
                         compute_dtype="float32", device="cpu",
                         use_flash_attention=True if flash else None)
    want = _words(plain.align_utterances(audios, transcripts, audio_multiple=500,
                                         token_multiple=16))
    assert res["words"] == want
    assert sum(len(w) for w in want) > 0
    assert res["flash_spmd"] == flash
    assert (res["flash_calls"] > 0) == flash
    if name in F32_PHASES:
        jax_loss = _jax_f32_loss(over, b, train_n)
        assert abs(res["loss"] - jax_loss) <= 1e-5 * abs(jax_loss), (res["loss"], jax_loss)


@pytest.mark.parametrize("staging", ["host", "staged"])
def test_batch_aligner_uneven_batch_over_the_mesh(mesh_world, staging):
    """5 rows over 'data' = 4: padded by repeating the last row, host-staged
    and tensor input alike; the real rows come back."""
    from wav2vec2_tpu.config import Wav2Vec2ModelConfig as JaxCfg
    from wav2vec2_tpu.parallel.batching import BatchAligner as JaxBatchAligner

    got = _same_on_every_rank(mesh_world, "uneven")[staging]
    params = _jax_params(TINY, 1)
    plain = BatchAligner(TorchCfg.from_dict(_config(TINY)),
                         torch_params.params_from_jax(params), VOCAB,
                         compute_dtype="float32", device="cpu")
    want = plain.align_padded_batch(*UNEVEN_BATCH)
    assert [x.shape for x in got] == [x.shape for x in want]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
    jax_out = JaxBatchAligner(JaxCfg.from_dict(_config(TINY)), params, VOCAB,
                              compute_dtype="float32", use_pallas=False,
                              use_flash_attention=False).align_padded_batch(*UNEVEN_BATCH)
    np.testing.assert_array_equal(got[0], np.asarray(jax_out[0])[:5])


def test_align_longform_over_the_mesh(mesh_world):
    import jax

    from wav2vec2_tpu.align.longform import align_longform as jax_align_longform
    from wav2vec2_tpu.config import Wav2Vec2ModelConfig as JaxCfg
    from wav2vec2_tpu.parallel.mesh import make_mesh, replicated
    from wav2vec2_tpu_torch.align.longform import align_longform

    got = _same_on_every_rank(mesh_world, "longform")["words"]
    params = _jax_params(TINY, 1)
    plain = align_longform(LONGFORM_AUDIO, LONGFORM_TEXT, torch_params.params_from_jax(params),
                           TorchCfg.from_dict(_config(TINY)), VOCAB, chunk_sec=1.0,
                           overlap_sec=0.25, device="cpu")
    assert got == _words([plain])[0]
    mesh = make_mesh(8, model=1)
    jax_out = jax_align_longform(LONGFORM_AUDIO, LONGFORM_TEXT,
                                 jax.device_put(params, replicated(mesh)),
                                 JaxCfg.from_dict(_config(TINY)), VOCAB, chunk_sec=1.0,
                                 overlap_sec=0.25, mesh=mesh)
    assert [w[0] for w in got] == [w.word for w in jax_out.words] == LONGFORM_TEXT.split()


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_train_step_over_the_mesh(mesh_world, case):
    from wav2vec2_tpu_torch.parallel.train import (
        init_train_state,
        make_optimizer,
        make_train_step,
        tree_leaves,
    )

    res = _same_on_every_rank(mesh_world, f"train {case}")
    over, model = TRAIN_CASES[case]
    cfg = TorchCfg.from_dict(_config(over))
    tx = make_optimizer()
    state = init_train_state(torch_params.params_from_jax(_jax_params(over, 0)), tx)
    state, loss = make_train_step(cfg, tx, compute_dtype=torch.float32)(state, *_train_batch())
    assert abs(res["loss"] - float(loss)) <= 1e-5 * abs(float(loss))
    grads = [p.grad.numpy() for p in tree_leaves(state.params)]
    assert len(grads) == len(res["grads"])
    floor = 1e-3 * max(np.linalg.norm(w) for w in grads)
    for g, w in zip(res["grads"], grads):
        assert np.linalg.norm(g - w) <= 5e-5 * max(np.linalg.norm(w), floor), (
            np.linalg.norm(g - w), np.linalg.norm(w))
    assert res["kept"]
    assert res["q_spec"] == "(Replicate(), Shard(dim=2))"
    assert any("Shard" in p for p in res["placements"])


@pytest.mark.parametrize("entry", ["align", "longform", "train"])
def test_one_row_on_a_mesh_whose_data_axis_is_1(mesh_world, entry):
    """One row at (1×8): the batch stays whole on 'data' (a Shard of a
    one-row batch fails DTensor's view rules) and each entry point gives
    the unsharded result."""
    from wav2vec2_tpu_torch.align.longform import align_longform
    from wav2vec2_tpu_torch.parallel.train import (
        init_train_state,
        make_optimizer,
        make_train_step,
    )

    got = _same_on_every_rank(mesh_world, "one row")[entry]
    cfg = TorchCfg.from_dict(_config(ONE_ROW))
    params = torch_params.params_from_jax(_jax_params(ONE_ROW, 2))
    audio, text, train = _one_row_inputs()
    if entry == "align":
        want = _words(BatchAligner(cfg, params, VOCAB, compute_dtype="float32",
                                   device="cpu").align_utterances([audio], [text]))
    elif entry == "longform":
        want = _words([align_longform(audio, text, params, cfg, VOCAB, device="cpu")])
    else:
        tx = make_optimizer()
        _, loss = make_train_step(cfg, tx, compute_dtype=torch.float32)(
            init_train_state(params, tx), *train)
        assert abs(got - float(loss)) <= 1e-5 * abs(float(loss)), (got, float(loss))
        return
    assert got == want
    assert [w[0] for w in got[0]] == text.split()


@pytest.mark.parametrize("tree", INT8_TREES)
def test_int8_serving_over_the_mesh(mesh_world, tree):
    """int8 under (4×2) gives the unsharded int8 aligner's outputs: the
    int32 products' partial sums are exact, so paths, lengths and evidence
    are equal."""
    got = _same_on_every_rank(mesh_world, f"int8 {tree}")
    want = BatchAligner(TorchCfg.from_dict(_config(TINY)),
                        torch_params.params_from_jax(_jax_params(TINY, 1)), VOCAB,
                        compute_dtype="float32", device="cpu",
                        quantize_int8=True).align_padded_batch(*UNEVEN_BATCH)
    assert [x.shape for x in got] == [x.shape for x in want]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def flash_world(tmp_path_factory):
    rng = np.random.default_rng(11)
    b, nh, t, hd = 4, 4, 37, 16
    q, k, v, q_pos = (rng.normal(size=(b, nh, t, hd)).astype(np.float32) for _ in range(4))
    from wav2vec2_tpu_torch.ops.flash_attention import pad_len

    rel_r = rng.normal(size=(nh, 2 * pad_len(t), hd)).astype(np.float32)
    mask = np.zeros((b, t), np.float32)
    mask[1, 30:] = -np.inf
    mask[3, 20:] = -np.inf
    inputs = (q, k, v, q_pos, rel_r, mask)
    ranks = _spawn(tmp_path_factory.mktemp("mesh4"), 4, {"flash": ("flash", {"inputs": inputs})})
    return inputs, ranks


def test_k5_under_a_2x2_mesh(flash_world):
    from wav2vec2_tpu_torch.ops.flash_attention import flash_attention

    inputs, ranks = flash_world
    got = _same_on_every_rank(ranks, "flash")
    q, k, v, q_pos, rel_r, mask = (torch.from_numpy(a) for a in inputs)
    want = flash_attention(q, k, v, mask, q_pos=q_pos, rel_r=rel_r, scale=0.125).numpy()
    assert got["placements"] == "(Shard(dim=0), Shard(dim=1))"
    np.testing.assert_allclose(got["sharded"], want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["plain_under_mesh"], want, rtol=0, atol=1e-5)


def test_k5_and_k1_refuse_what_the_mesh_cannot_take(flash_world):
    _, ranks = flash_world
    got = _same_on_every_rank(ranks, "flash")
    assert got["batch"] == ("flash_attention under mesh: batch 3 must divide over "
                            "'data'=2 and heads 4 over 'model'=2 — disable "
                            "use_flash_attention for this (mesh, model) combination")
    assert got["heads"].startswith("flash_attention under mesh: batch 4 must divide over "
                                   "'data'=2 and heads 3 over 'model'=2")
    assert "not DTensors" in got["k1_dtensor"]
