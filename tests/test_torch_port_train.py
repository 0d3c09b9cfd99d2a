"""PyTorch port vs the JAX package: CTC training (`parallel/train.py`) and
parameter checkpoints (`utils/checkpoint.save_params` / `restore_params`).

Same seeded weights and batches on both sides (the JAX tree carried across
by `params_from_jax`), on the CPU, at the 2-layer config of
`tests/test_train.py`:

- `ctc_loss_from_logits` against optax's on rows that can be aligned and
  on a row that cannot (optax's finite ~1e5 where torch's ctc_loss gives
  inf), value within 1e-5 relative and gradient within 1e-5;
- one f32 step's loss within 1e-5 relative and every leaf's gradient
  within 1e-4 of that leaf's largest JAX gradient (`jax.value_and_grad`;
  a floor for the leaf whose exact gradient is 0); at bf16 compute within
  the looser bounds stated there;
- one AdamW step on the same gradients within 1e-6 of optax.adamw's;
- the inference forward bit-equal with the leaves requiring grad or not,
  at f32 and bf16, and the bf16 GELU's backward equal to autograd through
  the A&S expression;
- ports of `test_ctc_loss_decreases` and
  `test_train_step_wavlm_adapter_family` (the `mesh=` step is in
  tests/test_torch_port_mesh.py); the step never
  reaches K5, even forced, and `flash_attention` refuses inputs that
  require grad;
- `save_params` / `restore_params`: bit-exact round trips of f32, bf16
  and int8 trees, and `like=` refusing a shape or a dtype that differs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from wav2vec2_tpu.config import Wav2Vec2ModelConfig as JaxCfg
from wav2vec2_tpu.models.ctc_model import frame_lengths as jax_frame_lengths
from wav2vec2_tpu.models.ctc_model import wav2vec2_forward as jax_forward
from wav2vec2_tpu.models.params import init_params as jax_init_params
from wav2vec2_tpu.parallel import train as jax_train
from wav2vec2_tpu_torch.config import Wav2Vec2ModelConfig as TorchCfg
from wav2vec2_tpu_torch.models import layers
from wav2vec2_tpu_torch.models.ctc_model import wav2vec2_forward
from wav2vec2_tpu_torch.models.params import cast_compute_weights_bf16, params_from_jax
from wav2vec2_tpu_torch.models.quantize import quantize_encoder_int8
from wav2vec2_tpu_torch.ops import flash_attention as fa
from wav2vec2_tpu_torch.parallel import train
from wav2vec2_tpu_torch.utils.checkpoint import restore_params, save_params

CFG_KW = dict(
    hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
    intermediate_size=64, conv_dim=[16, 16], conv_kernel=[10, 3],
    conv_stride=[5, 2], num_conv_pos_embeddings=16,
    num_conv_pos_embedding_groups=4, pad_token_id=0, vocab_size=16,
    feat_extract_norm="group", conv_bias=False,
)
WAVLM_KW = dict(CFG_KW, attention_style="wavlm", num_buckets=16,
                max_bucket_distance=50, adapter_attn_dim=4)


def make_batch(rng, b=4, n=800, l=6, vocab=16):
    audio = rng.normal(size=(b, n)).astype(np.float32)
    audio_lens = np.full(b, n, np.int32)
    labels = rng.integers(1, vocab, size=(b, l)).astype(np.int32)
    label_lens = np.full(b, l, np.int32)
    return audio, audio_lens, labels, label_lens


def padded_batch(rng):
    """Ragged audio and label lengths, one row that cannot be aligned (30
    labels for its 22 frames)."""
    audio, _, _, _ = make_batch(rng, b=4, n=800)
    audio_lens = np.asarray([800, 640, 720, 500], np.int32)
    for i, n in enumerate(audio_lens):
        audio[i, n:] = 0.0
    labels = rng.integers(1, 16, size=(4, 30)).astype(np.int32)
    label_lens = np.asarray([6, 3, 5, 30], np.int32)
    return audio, audio_lens, labels, label_lens


def flat(tree, prefix=""):
    """{path: leaf} of a nested dict/list tree."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in flat(sub, f"{prefix}{key}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in flat(sub, f"{prefix}{i}/").items()}
    return {prefix[:-1]: tree}


def jax_loss_fn(cfg, compute_dtype):
    def loss_fn(params, audio, audio_lens, labels, label_lens):
        logits = jax_forward(params, audio, cfg, audio_lens=audio_lens,
                             compute_dtype=compute_dtype)
        t_lens = jax_frame_lengths(cfg, audio_lens)
        return jax_train.ctc_loss_from_logits(logits, t_lens, labels, label_lens,
                                              cfg.pad_token_id)
    return loss_fn


def jax_tree(cfg_kw, seed=0):
    return jax.tree.map(np.asarray, jax_init_params(JaxCfg(**cfg_kw), jax.random.PRNGKey(seed)))


# --- the loss -------------------------------------------------------------

def _table_case():
    """The hazard's case: B=3, T=6, V=5; row 1 needs 7 frames."""
    logits = np.random.default_rng(0).normal(size=(3, 6, 5)).astype(np.float32)
    labels = np.zeros((3, 5), np.int32)
    labels[0, :3] = [1, 2, 3]
    labels[1, :4] = [1, 1, 1, 1]
    labels[2, :5] = [1, 2, 3, 4, 1]
    return logits, np.full(3, 6, np.int32), labels, np.asarray([3, 4, 5], np.int32)


def _ragged_case():
    """B=5, T=40, V=12: padded frames and labels, a repeat-only infeasible
    row and an empty transcript."""
    rng = np.random.default_rng(1)
    logits = (rng.normal(size=(5, 40, 12)) * 3).astype(np.float32)
    labels = rng.integers(1, 12, size=(5, 9)).astype(np.int32)
    labels[2, :8] = 7  # 8 labels with 7 repeats need 15 frames, it has 10
    t_lens = np.asarray([40, 31, 10, 25, 17], np.int32)
    label_lens = np.asarray([9, 4, 8, 0, 9], np.int32)
    return logits, t_lens, labels, label_lens


@pytest.mark.parametrize("case", [_table_case, _ragged_case], ids=["table", "ragged"])
def test_ctc_loss_matches_optax_on_feasible_and_infeasible_rows(case):
    logits, t_lens, labels, label_lens = case()
    feasible = train.ctc_feasible(t_lens, labels, label_lens)
    assert not feasible.all() and feasible.any()

    def jf(lg):
        return jax_train.ctc_loss_from_logits(lg, jnp.asarray(t_lens), jnp.asarray(labels),
                                              jnp.asarray(label_lens), 0)

    want, want_grad = jax.jit(jax.value_and_grad(jf))(jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    got = train.ctc_loss_from_logits(x, torch.tensor(t_lens), torch.tensor(labels),
                                     torch.tensor(label_lens), 0)
    got.backward()
    assert np.isfinite(got.item()) and got.item() > 1e4 / len(logits)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), atol=1e-5)
    # per row too: torch's own loss where it can align, optax's where not
    lp = torch.log_softmax(torch.tensor(logits), -1)
    per_row = train.optax_ctc_loss(lp, torch.tensor(t_lens), torch.tensor(labels),
                                   torch.tensor(label_lens), 0)
    paddings = [(np.arange(n)[None, :] >= lens[:, None]).astype(np.float32)
                for n, lens in ((logits.shape[1], t_lens), (labels.shape[1], label_lens))]
    optax_rows = optax.ctc_loss(jnp.asarray(logits), paddings[0], jnp.asarray(labels), paddings[1])
    np.testing.assert_allclose(per_row.numpy(), np.asarray(optax_rows), rtol=1e-5)


# --- the step against jax.value_and_grad ---------------------------------

# (loss relative, gradient, gradient floor): each leaf's largest gradient
# error within `gradient` × max(that leaf's largest JAX gradient, `floor` ×
# the tree's largest). A leaf whose gradient is 0 in exact arithmetic
# (k_proj's bias: the softmax ignores a constant added to a row) holds
# rounding noise only, of the size of the other gradients: hence the floor.
# bf16 compute rounds activations to 8 bits at every op in both packages,
# at different places (PyTorch's softmax and norms read bf16 in f32), so
# its noise is about 2^-8 of the gradients it comes from.
_BOUNDS = {"float32": (1e-5, 1e-4, 1e-3), "bfloat16": (1e-3, 5e-2, 1e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_loss_and_grads_match_jax(dtype):
    tree = jax_tree(CFG_KW)
    batch = padded_batch(np.random.default_rng(0))
    loss_fn = jax_loss_fn(JaxCfg(**CFG_KW), getattr(jnp, dtype))
    want, want_grads = jax.jit(jax.value_and_grad(loss_fn))(tree, *map(jnp.asarray, batch))

    state = train.init_train_state(params_from_jax(tree), train.make_optimizer())
    step = train.make_train_step(TorchCfg(**CFG_KW), None, compute_dtype=getattr(torch, dtype))
    state, loss = step(state, *batch)
    assert state.step == 1
    loss_tol, grad_tol, floor = _BOUNDS[dtype]
    np.testing.assert_allclose(float(loss), float(want), rtol=loss_tol)
    got = flat(state.params)
    want_flat = {k: np.asarray(g, np.float64) for k, g in flat(want_grads).items()}
    assert set(got) == set(want_flat)
    floor *= max(float(np.abs(g).max()) for g in want_flat.values())
    for key, g_want in want_flat.items():
        err = np.abs(got[key].grad.double().numpy() - g_want).max()
        assert err <= grad_tol * max(np.abs(g_want).max(), floor), (key, err)


def test_adamw_step_matches_optax():
    """make_optimizer's AdamW and optax.adamw, two steps on the same
    gradients (gradients that differ in the last bits could move Adam's
    g/(|g|+eps) far for the smallest ones)."""
    tree = jax_tree(CFG_KW)
    rng = np.random.default_rng(3)
    grads = [jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32) * 1e-2, tree)
             for _ in range(2)]
    tx = optax.adamw(1e-4, weight_decay=0.01)
    opt_state = tx.init(tree)
    want = tree
    state = train.init_train_state(params_from_jax(tree), train.make_optimizer())
    leaves = flat(state.params)
    for g in grads:
        updates, opt_state = tx.update(g, opt_state, want)
        want = optax.apply_updates(want, updates)
        for key, leaf in leaves.items():
            leaf.grad = torch.from_numpy(np.asarray(flat(g)[key]))
        state.opt_state.step()
    for key, w in flat(want).items():
        np.testing.assert_allclose(leaves[key].detach().numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6, err_msg=key)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_inference_forward_is_bit_equal_with_grad_on_and_off(dtype):
    """The train step's out-of-place branch computes the inference forward's
    values exactly (group-norm and layer-norm frontends, padded batch)."""
    rng = np.random.default_rng(5)
    audio, audio_lens, _, _ = padded_batch(rng)
    audio, audio_lens = torch.from_numpy(audio), torch.from_numpy(audio_lens)
    for kw in (CFG_KW, dict(CFG_KW, feat_extract_norm="layer", conv_bias=True,
                            do_stable_layer_norm=True)):
        cfg = TorchCfg(**kw)
        params = params_from_jax(jax_tree(kw))
        with torch.inference_mode():
            want = wav2vec2_forward(params, audio, cfg, audio_lens=audio_lens,
                                    compute_dtype=dtype)
        trainable = train.init_train_state(params, train.make_optimizer()).params
        got = wav2vec2_forward(trainable, audio, cfg, audio_lens=audio_lens, compute_dtype=dtype)
        assert got.requires_grad
        assert torch.equal(got.detach(), want)


def test_bf16_gelu_backward_is_autograd_of_the_as_expression():
    x = torch.cat([(torch.randn(20000, generator=torch.Generator().manual_seed(0)) * 3),
                   torch.zeros(1)]).to(torch.bfloat16)
    gy = torch.randn(x.shape, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    xg = x.clone().requires_grad_(True)
    y = layers.gelu(xg)
    assert torch.equal(y.detach(), layers.gelu(x))
    (gx,) = torch.autograd.grad(y, xg, gy)
    xf = x.float().requires_grad_(True)  # the JAX form, out of place
    z = xf * 0.7071067811865476
    za = z.abs()
    u = 1.0 / (1.0 + 0.3275911 * za)
    poly = ((((1.061405429 * u - 1.453152027) * u + 1.421413741) * u
             - 0.284496736) * u + 0.254829592) * u
    yr = 0.5 * xf * (1.0 + torch.sign(z) * (1.0 - poly * torch.exp(-za * za)))
    (want,) = torch.autograd.grad(yr, xf, gy.float())
    assert gx.dtype == torch.bfloat16
    np.testing.assert_allclose(gx.float().numpy(), want.to(torch.bfloat16).float().numpy(),
                               rtol=0, atol=1e-2 * float(want.abs().max()))


# --- ports of tests/test_train.py ------------------------------------------

def test_ctc_loss_decreases():
    params = params_from_jax(jax_tree(CFG_KW))
    state = train.init_train_state(params, train.make_optimizer(learning_rate=3e-3))
    step = train.make_train_step(TorchCfg(**CFG_KW), None, compute_dtype=torch.float32)
    batch = make_batch(np.random.default_rng(0))
    losses = []
    for _ in range(8):
        state, loss = step(state, *batch)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses


def test_train_step_wavlm_adapter_family():
    """Gradients flow through the WavLM gated bias and the MMS adapters."""
    params = params_from_jax(jax_tree(WAVLM_KW))
    state = train.init_train_state(params, train.make_optimizer(learning_rate=3e-3))
    step = train.make_train_step(TorchCfg(**WAVLM_KW), None, compute_dtype=torch.float32)
    batch = make_batch(np.random.default_rng(0))
    gate = state.params["encoder"]["layers"]["attention"]["gru_rel_pos_linear"]["kernel"]
    before = gate.detach().clone()
    adapter = state.params["encoder"]["layers"]["adapter_layer"]["linear_2"]["kernel"]
    adapter_before = adapter.detach().clone()
    losses = []
    for _ in range(4):
        state, loss = step(state, *batch)
        losses.append(float(loss))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert not torch.allclose(before, gate.detach()), "gate params did not update"
    assert not torch.allclose(adapter_before, adapter.detach()), "adapter did not update"
    assert "rel_attn_embed" in state.params["encoder"]


def test_train_step_never_reaches_k5(monkeypatch):
    """The step clears use_flash_attention, so even forced the kernel (which
    has no backward) is never called; flash_attention itself refuses inputs
    that require grad."""
    monkeypatch.setenv(fa.FORCE_ENV, "1")

    def refuse(*a, **k):
        raise AssertionError("the train step called flash_attention")

    cfg = dataclasses.replace(TorchCfg(**CFG_KW), use_flash_attention=True)
    assert fa.use_flash(cfg.hidden_size // cfg.num_attention_heads, dtype=torch.float32)
    monkeypatch.setattr(fa, "flash_attention", refuse)
    state = train.init_train_state(params_from_jax(jax_tree(CFG_KW)), train.make_optimizer())
    state, loss = train.make_train_step(cfg, None, compute_dtype=torch.float32)(
        state, *make_batch(np.random.default_rng(0)))
    assert np.isfinite(float(loss))
    assert cfg.use_flash_attention  # the caller's config is left as it was
    monkeypatch.undo()
    q = torch.randn(1, 2, 8, 16, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        fa.flash_attention(q, q.detach(), q.detach())
    with torch.no_grad():
        assert fa.flash_attention(q, q, q).shape == q.shape


def test_init_train_state_refuses_an_int8_tree():
    params = quantize_encoder_int8(params_from_jax(jax_tree(CFG_KW)))
    with pytest.raises(ValueError, match="int8"):
        train.init_train_state(params, train.make_optimizer())


# --- checkpoints (tests/test_checkpoint.py::test_orbax_roundtrip) ---------

def _trees():
    params = params_from_jax(jax_tree(CFG_KW))
    return {"f32": params, "bf16": cast_compute_weights_bf16(params),
            "int8": quantize_encoder_int8(params)}


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_save_restore_params_round_trip_bit_exact(kind, tmp_path):
    tree = _trees()[kind]
    save_params(tmp_path / "ckpt", tree)
    for like in (None, tree):
        restored = restore_params(tmp_path / "ckpt", like=like)
        got, want = flat(restored), flat(tree)
        assert list(got) == list(want)
        for key, leaf in want.items():
            assert got[key].dtype == leaf.dtype, key
            assert torch.equal(got[key], leaf), key
    dtypes = {leaf.dtype for leaf in flat(tree).values()}
    assert dtypes == {"f32": {torch.float32}, "bf16": {torch.float32, torch.bfloat16},
                      "int8": {torch.float32, torch.int8}}[kind]


@pytest.mark.parametrize("change", ["shape", "dtype"])
def test_restore_params_like_refuses_a_mismatch(change, tmp_path):
    tree = _trees()["f32"]
    save_params(tmp_path / "ckpt", tree)
    like = flat(tree)
    lm = tree["lm_head"]["kernel"]
    other = lm[:, :-1] if change == "shape" else lm.double()
    bad = {**tree, "lm_head": {**tree["lm_head"], "kernel": other}}
    assert set(flat(bad)) == set(like)
    with pytest.raises(ValueError, match="lm_head/kernel"):
        restore_params(tmp_path / "ckpt", like=bad)
