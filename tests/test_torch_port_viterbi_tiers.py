"""PyTorch port vs the JAX package: the blocked Viterbi tiers K2, K3, K4.

- `select_tier`, the Hopper tier rule, on the shapes each path sends: the
  serving shape, long batch buckets, 10 and 60 min long-form with char and
  phoneme vocabularies, a wide vocabulary with a short transcript, and
  past 16 384 states K4 on a thread-block cluster, with the cluster size
  and slices each shape gets pinned.
- The plain versions: `viterbi_emissions_batch` (K2, K3) and
  `viterbi_batch` (K1, K4) bit-identical to `viterbi_numpy`.
- The port's plain version of each tier bit-identical to the JAX tier it
  replaces, run in interpret mode and forced by monkeypatching
  `VMEM_BUDGET_BYTES` as tests/test_viterbi_pallas.py does: tolerance 0.
The CUDA kernels themselves are held to these plain versions on the card
(tests/test_torch_port_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import wav2vec2_tpu.ops.viterbi_pallas as vp
from wav2vec2_tpu.ops.viterbi_ref import viterbi_numpy as jax_viterbi_numpy
from wav2vec2_tpu_torch.ops import viterbi_cuda, viterbi_ref


def _log_probs(rng, b, t, v):
    x = rng.normal(size=(b, t, v)).astype(np.float32) * 3
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


def _batch(seed, b, t_pad, v, s_pad):
    """Ragged batch: t_len < T_pad and s_len < S_pad on some rows."""
    rng = np.random.default_rng(seed)
    lp = _log_probs(rng, b, t_pad, v)
    tok = rng.integers(0, v, size=(b, s_pad)).astype(np.int32)
    t_lens = np.array([t_pad] + list(rng.integers(max(t_pad // 3, 1), t_pad + 1, size=b - 1)),
                      np.int32)
    s_lens = np.minimum(rng.integers(1, s_pad + 1, size=b), 2 * t_lens).astype(np.int32)
    s_lens[0] = min(s_pad, 2 * t_pad)
    return lp, tok, t_lens, s_lens


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _check_oracle(paths, lp, tok, t_lens, s_lens):
    for j, (t_i, s_i) in enumerate(zip(t_lens, s_lens)):
        want = [s for s, _ in jax_viterbi_numpy(lp[j, :t_i], tok[j, :s_i])]
        assert list(paths[j, :t_i]) == want, f"row {j}"
        assert (paths[j, t_i:] == want[-1]).all(), f"row {j}: frozen frames"


@pytest.mark.parametrize("t_pad,s_pad,v,want", [
    (499, 256, 32, "k1"),            # 10 s serving shape
    (512, 256, 32, "k1"),            # K1_MAX_FRAMES itself
    (513, 256, 32, "k2"),            # just past it: K2's on-chip bp fits
    (2400, 128, 32, "k2"),           # long batch bucket, short transcripts
    (7000, 128, 32, "k4"),           # K2's packed bp no longer fits
    (1499, 768, 32, "k4"),           # 30 s, long transcript
    (30000, 12032, 32, "k4"),        # 10 min char long-form
    (180000, 11136, 32, "k4"),       # 60 min char long-form
    (180000, 12672, 392, "k4"),      # 60 min phoneme long-form
    (30000, 128, 392, "k3"),         # wide vocab, short transcript
    (5000, 3700, 8000, "k1"),        # neither window fits: K1 reads no window
    (5000, 3500, 8000, "k3"),        # K3's window fits now that rows live in registers
    (1000, 16_384, 32, "k4"),        # K4's widest strips: 512 threads of 32 states
    (1000, 16_388, 32, "k4"),        # past one block's strips: K4 on a cluster of 2
    (10_500, 20_004, 32, "k4"),      # long-form at 17.5 min of the JAX example's rate
    (48_000, 19_200, 32, "k4"),      # 16 min: off K1's device mode
    (60_000, 24_064, 32, "k4"),      # 20 min
    (180_000, 99_072, 32, "k4"),     # an hour at 150 words a minute
    (180_000, 86_400, 392, "k4"),    # an hour at 12 phones a second
])
def test_select_tier_table(t_pad, s_pad, v, want):
    assert viterbi_cuda.select_tier(t_pad, s_pad, v) == want
    viterbi_cuda.check_fits(want, t_pad, s_pad, v)


def test_select_tier_raises_past_shared_memory():
    """K2 and K3 stop at one block's MAX_STRIP_STATES (16 384); K4 runs
    past it on a cluster of up to 8 blocks, and past 131 072 states no tier
    serves: the error names the cluster's limit. Where K4's window and K1's
    rows both exceed shared memory, the error says so."""
    assert viterbi_cuda.MAX_STRIP_STATES == 16_384
    assert viterbi_cuda.MAX_CLUSTER_STATES == 131_072
    viterbi_cuda.check_fits("k4", 100, 16_384, 32)
    viterbi_cuda.check_fits("k4", 100, 131_072, 32)
    with pytest.raises(ValueError, match="cluster of 8 blocks"):
        viterbi_cuda.select_tier(1000, 131_076, 32)
    with pytest.raises(ValueError, match="shared memory"):
        viterbi_cuda.select_tier(100, 20_000, 8000)
    with pytest.raises(ValueError, match="states"):
        viterbi_cuda.check_fits("k3", 100, 16_388, 32)
    with pytest.raises(ValueError, match="states"):
        viterbi_cuda.check_fits("k4", 100, 131_076, 32)


@pytest.mark.parametrize("t_pad,s_pad,v,n,r,threads,first_slices", [
    (1000, 16_384, 32, 1, 32, 512, [(0, 16_384)]),
    (1000, 16_388, 32, 2, 32, 288, [(0, 8_192), (8_192, 16_388)]),
    (10_500, 20_004, 32, 2, 32, 320, [(0, 10_016), (10_016, 20_004)]),
    (48_000, 19_200, 32, 2, 32, 320, [(0, 9_600), (9_600, 19_200)]),
    (60_000, 24_064, 32, 2, 32, 384, [(0, 12_032), (12_032, 24_064)]),
    (20_000, 40_064, 32, 3, 32, 448, [(0, 13_344), (13_344, 26_688), (26_688, 40_064)]),
    (180_000, 86_400, 392, 6, 32, 480, [(0, 14_400), (14_400, 28_800)]),
    (180_000, 99_072, 32, 7, 32, 448, [(0, 14_144), (14_144, 28_288)]),
    (100, 131_072, 32, 8, 32, 512, [(0, 16_384), (16_384, 32_768)]),
])
def test_cluster_shape_is_pinned(t_pad, s_pad, v, n, r, threads, first_slices):
    """K4's cluster at each width: ceil(W / 16 384) blocks, 32-state strips,
    block k taking strips [k N / n, (k + 1) N / n); the slices tile [0, W)
    in whole strips but the last. K1 keeps its device mode at 16 388."""
    assert viterbi_cuda.select_tier(t_pad, s_pad, v) == "k4"
    assert viterbi_cuda.cluster_size(s_pad) == n
    assert viterbi_cuda.cluster_shape(s_pad) == (n, r, threads)
    slices = viterbi_cuda.cluster_slices(s_pad)
    assert slices[:len(first_slices)] == first_slices and len(slices) == n
    w = -(-s_pad // 4) * 4
    assert slices[-1][1] == w and all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
    assert max(b - a for a, b in slices) <= viterbi_cuda.MAX_STRIP_STATES
    assert viterbi_cuda.bp_scratch_shape("k4", 1, t_pad, s_pad, v) == (1, t_pad, w // 4)


@pytest.mark.parametrize("s_pad,cluster,want", [
    (99_072, 8, (8, 32, 416)),     # chip_smoke's (w2): the least cluster against 8
    (20_480, 3, (3, 16, 448)),     # a larger cluster takes narrower strips
    (20_480, 8, (8, 8, 320)),
    (1_024, 2, (2, 4, 128)),
    (16_384, 1, (1, 32, 512)),     # a cluster of 1 is the one-block launch
])
def test_forced_cluster_shapes(s_pad, cluster, want):
    assert viterbi_cuda.cluster_shape(s_pad, cluster) == want
    viterbi_cuda.check_fits("k4", 1000, s_pad, 32, cluster)


def test_forced_cluster_on_cpu_runs_the_plain_version():
    """`cluster=` is checked on the CPU too, then the plain version runs (it
    has no partition); only K4 takes it."""
    lp, tok, t_lens, s_lens = _torch(*_batch(4, 2, 40, 5, 64))
    want = viterbi_ref.viterbi_batch(lp, tok, t_lens, s_lens).numpy()
    got = viterbi_cuda.viterbi_batch(lp, tok, t_lens, s_lens, tier="k4", cluster=3).numpy()
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="only k4"):
        viterbi_cuda.viterbi_batch(lp, tok, t_lens, s_lens, tier="k2", cluster=2)
    with pytest.raises(ValueError, match="cluster"):
        viterbi_cuda.viterbi_batch(lp, tok, t_lens, s_lens, tier="k4", cluster=9)


@pytest.mark.parametrize("t_pad,s_pad,v,want", [
    (499, 256, 32, "k1"),            # the serving batch
    (1511, 128, 32, "k2"),           # the long bucket
    (8999, 128, 392, "k3"),          # 3 min long-form, phoneme vocab
    (29999, 12032, 32, "k4"),        # 10 min long-form
])
def test_select_tier_routes_the_smoke_shapes(t_pad, s_pad, v, want):
    """The shapes chip_smoke.py's paths send keep their tiers."""
    assert viterbi_cuda.select_tier(t_pad, s_pad, v) == want


@pytest.mark.parametrize("tier,shape,want", [
    # K1 resident: 4 mbarriers, a ring of 4 x 16 rows of V f32, the 528 B
    # halo and final scores, the int32 path row and the [T_pad, 64] planes
    ("k1", (499, 256, 32), 32 + 4 * 2048 + 528 + 2000 + 499 * 64),
    ("k1", (1499, 768, 32), 12 * 768),  # device mode: two f32 rows, int32 tokens
    ("k2", (1511, 128, 32), 64 * 128 + 528 + 1511 * 32),
    ("k3", (8999, 128, 392), 64 * 128 + 528 + 128),
    ("k4", (29999, 12032, 32), 64 * 32 + 528 + 128),
    ("k4", (37, 61, 397), 64 * 400 + 528 + 128),
    # K4 on a cluster adds a [16, 2] f32 ring and 18 mbarriers (272 B)
    ("k4", (10_500, 20_004, 32), 64 * 32 + 528 + 128 + 272),
    ("k4", (180_000, 99_072, 32), 64 * 32 + 528 + 128 + 272),
    ("k4", (180_000, 86_400, 392), 64 * 392 + 528 + 128 + 272),
])
def test_shared_memory_sizes_are_pinned(tier, shape, want):
    """K1's resident mode: its ring, halo, path row and 2-bit planes; its
    device mode: two DP rows and the tokens. K2–K4: the f32 window, halo
    and final scores, and K2's packed bp or K3/K4's backtrace window; no DP
    row in shared memory."""
    assert viterbi_cuda.smem_bytes(tier, *shape) == want


@pytest.mark.parametrize("tier,want", [
    ("k1", (0,)), ("k2", (0,)), ("k3", (3, 101, 16)), ("k4", (3, 101, 16)),
])
def test_backpointer_scratch_is_two_bits_a_cell(tier, want):
    """K3/K4 keep 2-bit backpointers in device memory: [B, T_pad, W/4]
    uint8 with W = S_pad rounded up to 4; K2 and K1's resident mode keep
    theirs in shared memory."""
    assert viterbi_cuda.bp_scratch_shape(tier, 3, 101, 61, 32) == want


@pytest.mark.parametrize("shape,mode", [
    ((499, 256, 32), "resident"),     # the serving shape
    ((101, 61, 29), "resident"),      # V * 4 not a multiple of 16: 4-byte ring copies
    ((2400, 256, 32), "resident"),    # past 512 frames the ring refills
    ((512, 4096, 32), "device"),      # its planes (512 KB) do not fit
    ((1000, 16_388, 32), "device"),   # past the resident strips
    ((5000, 3700, 8000), "device"),   # 4.6 MB of planes
    ((1499, 768, 32), "device"),      # the large case: 288 KB of planes
])
def test_k1_mode_is_a_shape_rule(shape, mode):
    """K1 runs resident where its ring and 2-bit planes fit in shared
    memory, else in device memory; the scratch and the shared-memory size
    follow the mode."""
    t_pad, s_pad, v = shape
    assert viterbi_cuda.k1_mode(*shape) == mode
    scratch = viterbi_cuda.bp_scratch_shape("k1", 2, t_pad, s_pad, v)
    assert scratch == ((0,) if mode == "resident" else (2, t_pad, s_pad))
    need = viterbi_cuda.smem_bytes("k1", *shape)
    assert need <= viterbi_cuda.MAX_SMEM_BYTES
    if mode == "device":
        assert need == 12 * s_pad


def test_k1_serving_shape_leaves_room_for_two_blocks_an_sm():
    """At B=128, T=499, S_pad=256 a resident block takes under 113 KB, so
    two fit an SM's 228 KB and B up to 264 runs in one wave."""
    assert viterbi_cuda.smem_bytes("k1", 499, 256, 32) < 113 * 1024


@pytest.mark.parametrize("kwargs,match", [
    (dict(mode="cache"), "mode"),
    (dict(mode="device", strip=2), "strip"),
    (dict(mode="resident", strip=3), "strip"),
    (dict(mode="resident", strip=2), "CUDA"),
])
def test_k1_batch_checks_its_arguments(kwargs, match):
    """`k1_batch` (a mode and strip width forced, for measuring) takes CUDA
    tensors only and refuses modes and strips K1 does not have."""
    args = _torch(*_batch(2, 2, 16, 4, 12))
    with pytest.raises(ValueError, match=match):
        viterbi_cuda.k1_batch(*args, **kwargs)


@pytest.mark.parametrize("tier,shape", [
    ("k2", (100_000, 128, 32)), ("k3", (100, 4096, 32)), ("k4", (100, 128, 4096)),
    ("k1", (100, 20_000, 32)),
])
def test_forced_tier_that_does_not_fit_raises(tier, shape):
    with pytest.raises(ValueError, match="shared memory"):
        viterbi_cuda.check_fits(tier, *shape)


def test_raw_gather_rule_is_the_traffic_half_of_the_jax_rule():
    """K4 over K3 where the raw [T, V_pad] read beats writing and reading a
    gathered [T, S_pad] array; agrees with `_use_onehot_gather` on the
    shapes its tests pin, except where the TPU's one-hot VMEM budget binds."""
    for v, s_len in ((32, 5000), (392, 301), (392, 17), (392, 8000), (397, 12599)):
        s_pad = -(-s_len // 128) * 128
        assert viterbi_cuda.use_raw_gather(v, s_pad) == vp._use_onehot_gather(v, s_len)
    assert viterbi_cuda.use_raw_gather(392, 21000 // 128 * 128 + 128)  # no VMEM cap here
    assert not vp._use_onehot_gather(392, 21000)


@pytest.mark.parametrize("seed", range(4))
def test_plain_emissions_and_batch_match_numpy_oracle(seed):
    lp, tok, t_lens, s_lens = _batch(seed, 4, 37 + 9 * seed, 5 + seed, 30)
    args = _torch(lp, tok, t_lens, s_lens)
    emit = viterbi_ref.gather_emissions(args[0], args[1])
    assert emit.shape == (4, lp.shape[1], 30) and emit.is_contiguous()
    np.testing.assert_array_equal(
        emit.numpy(), np.take_along_axis(lp, tok[:, None, :].repeat(lp.shape[1], 1), 2))
    from_emit = viterbi_ref.viterbi_emissions_batch(emit, *args[1:]).numpy()
    _check_oracle(from_emit, lp, tok, t_lens, s_lens)
    np.testing.assert_array_equal(viterbi_ref.viterbi_batch(*args).numpy(), from_emit)


def _jax_batch(lp, tok, t_lens, s_lens):
    return np.asarray(vp.viterbi_pallas_batch(
        jnp.asarray(lp), jnp.asarray(tok), jnp.asarray(t_lens), jnp.asarray(s_lens),
        interpret=True))


# (tier, b, T_pad, V, S_pad): ragged batches at the shapes that route the
# JAX batch dispatch to each blocked kernel once VMEM_BUDGET_BYTES is patched
BATCH_TIERS = [
    ("k2", 3, 40, 9, 30),          # _KERNEL_BP_VMEM_BATCH
    ("k3", 2, 48, 392, 17),        # _KERNEL_BP_HBM_BATCH: v_pad >= 2 * s_pad
    ("k4", 2, 72, 392, 261),       # _KERNEL_BP_HBM_GATHER_BATCH, phoneme V
    ("k4", 3, 41, 32, 60),         # _KERNEL_BP_HBM_GATHER_BATCH, char V
]


@pytest.mark.parametrize("tier,b,t_pad,v,s_pad", BATCH_TIERS)
def test_plain_tier_matches_jax_blocked_batch_kernel(monkeypatch, tier, b, t_pad, v, s_pad):
    """The JAX grid-over-batch tier (interpret mode) and the port's plain
    version of the same tier give identical paths on every frame."""
    t8 = -(-t_pad // 8) * 8
    s128 = -(-s_pad // 128) * 128
    # K2: emissions + bp exceed the budget, bp alone fits; K3/K4: nothing fits
    monkeypatch.setattr(vp, "VMEM_BUDGET_BYTES", 6 * t8 * s128 if tier == "k2" else 1)
    if tier != "k2":  # the gather rule decides only once bp leaves VMEM
        assert vp._use_onehot_gather(v, s_pad) == (tier == "k4")
    lp, tok, t_lens, s_lens = _batch(31 + t_pad, b, t_pad, v, s_pad)
    want = _jax_batch(lp, tok, t_lens, s_lens)
    got = viterbi_cuda.viterbi_batch(*_torch(lp, tok, t_lens, s_lens), tier=tier).numpy()
    np.testing.assert_array_equal(got, want)
    _check_oracle(got, lp, tok, t_lens, s_lens)


@pytest.mark.parametrize("tier,v,s_len", [("k3", 392, 17), ("k4", 392, 301)])
def test_plain_tier_matches_jax_single_hbm_kernel(tier, v, s_len):
    """`viterbi_pallas_single_hbm` (K3 `_KERNEL_BP_HBM`, or K4
    `_viterbi_hbm_gather`) against the port's plain version, one utterance
    with t_len < T."""
    assert vp._use_onehot_gather(v, s_len) == (tier == "k4")
    rng = np.random.default_rng(s_len)
    t, t_len = 90, 83
    lp = _log_probs(rng, 1, t, v)[0]
    tok = rng.integers(0, v, size=s_len).astype(np.int32)
    want = np.asarray(vp.viterbi_pallas_single_hbm(
        jnp.asarray(lp), jnp.asarray(tok), jnp.int32(t_len), jnp.int32(s_len),
        interpret=True))
    tok_pad = np.zeros(128 * -(-s_len // 128), np.int32)
    tok_pad[:s_len] = tok
    got = viterbi_cuda.viterbi_single(torch.from_numpy(lp), torch.from_numpy(tok_pad),
                                      t_len, s_len, tier=tier).numpy()
    np.testing.assert_array_equal(got, want)


def test_plain_tier_matches_jax_single_bp_vmem_kernel(monkeypatch):
    """`viterbi_pallas_single`'s middle tier (K2 `_KERNEL_BP_VMEM`)."""
    rng = np.random.default_rng(3)
    t, v, s_len = 56, 7, 40
    monkeypatch.setattr(vp, "VMEM_BUDGET_BYTES", 6 * t * 128)
    lp = _log_probs(rng, 1, t, v)[0]
    tok = rng.integers(0, v, size=s_len).astype(np.int32)
    want = np.asarray(vp.viterbi_pallas_single(
        jnp.asarray(lp), jnp.asarray(tok), jnp.int32(t), jnp.int32(s_len), interpret=True))
    got = viterbi_cuda.viterbi_single(torch.from_numpy(lp), torch.from_numpy(tok), t, s_len,
                                      tier="k2").numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tier", viterbi_cuda.TIERS)
def test_forced_tier_on_cpu_runs_the_plain_version_without_counting(tier):
    lp, tok, t_lens, s_lens = _batch(9, 3, 33, 6, 20)
    before = dict(viterbi_cuda.launches), dict(viterbi_cuda.k1_launches)
    got = viterbi_cuda.viterbi_batch(*_torch(lp, tok, t_lens, s_lens), tier=tier).numpy()
    assert (viterbi_cuda.launches, viterbi_cuda.k1_launches) == before
    _check_oracle(got, lp, tok, t_lens, s_lens)


def test_wrapper_rejects_unknown_tiers():
    lp, tok, t_lens, s_lens = _torch(*_batch(1, 2, 8, 4, 5))
    with pytest.raises(ValueError, match="tier"):
        viterbi_cuda.viterbi_batch(lp, tok, t_lens, s_lens, tier="k5")
    emit = viterbi_ref.gather_emissions(lp, tok)
    with pytest.raises(ValueError, match="pre-gathered"):
        viterbi_cuda.viterbi_emissions_batch(emit, tok, t_lens, s_lens, tier="k4")
    np.testing.assert_array_equal(
        viterbi_cuda.viterbi_emissions_batch(emit, tok, t_lens, s_lens, tier="k2").numpy(),
        viterbi_ref.viterbi_batch(lp, tok, t_lens, s_lens).numpy())
