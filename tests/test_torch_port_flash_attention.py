"""PyTorch port vs the JAX package: the fused rel-pos attention K5.

On the CPU the port's `flash_attention` runs the kernel's plain version
(`ops.flash_attention_ref`); the JAX `flash_attention` runs its Pallas
kernel in interpret mode, as the JAX package's own tests run it. Same numpy
inputs on both sides. Bounds, relative to the largest output: 2e-5 at f32
(the kernel's own bound in `tests/test_flash_attention.py`; sums taken in
another order), 3e-2 at bf16 (bf16 operand and probability rounding). The
table `rel_table_rev` is held within 1e-6 relative at f32, its sinusoid
`_pe_table` bit for bit.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from wav2vec2_tpu.ops import flash_attention as jax_fa
from wav2vec2_tpu_torch.ops import flash_attention as fa
from wav2vec2_tpu_torch.ops import flash_attention_ref

F32_REL = 2e-5
BF16_REL = 3e-2


def _inputs(b, nh, t, hd, rel, masked, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, nh, t, hd)).astype(np.float32) for _ in range(3))
    mask = None
    if masked:
        lens = rng.integers(t // 2, t + 1, size=b)
        lens[0] = t
        mask = np.where(np.arange(t)[None] < lens[:, None], 0.0, -np.inf).astype(np.float32)
    q_pos = w_pos = None
    if rel:
        h = nh * hd
        w_pos = (rng.normal(size=(h, h)) * 0.1).astype(np.float32)
        q_pos = rng.normal(size=(b, nh, t, hd)).astype(np.float32)
    return q, k, v, mask, q_pos, w_pos


def _jax_out(q, k, v, mask, q_pos, w_pos, dtype):
    nh, t = q.shape[1], q.shape[2]
    kw = {}
    if w_pos is not None:
        kw = dict(q_pos=jnp.asarray(q_pos, dtype),
                  rel_r=jax_fa.rel_table_rev(jnp.asarray(w_pos), nh, jax_fa.pad_len(t), dtype))
    out = jax_fa.flash_attention(
        jnp.asarray(q, dtype), jnp.asarray(k, dtype), jnp.asarray(v, dtype),
        None if mask is None else jnp.asarray(mask), scale=q.shape[3] ** -0.5, **kw)
    return np.asarray(out.astype(jnp.float32))


def _port_out(q, k, v, mask, q_pos, w_pos, dtype):
    nh, t = q.shape[1], q.shape[2]

    def tt(x):
        return torch.from_numpy(x).to(dtype)

    kw = {}
    if w_pos is not None:
        kw = dict(q_pos=tt(q_pos),
                  rel_r=fa.rel_table_rev(torch.from_numpy(w_pos), nh, fa.pad_len(t), dtype))
    out = fa.flash_attention(tt(q), tt(k), tt(v),
                             None if mask is None else torch.from_numpy(mask),
                             scale=q.shape[3] ** -0.5, **kw)
    assert out.dtype == dtype and out.shape == q.shape
    return out.float().numpy()


def _rel_err(got, want):
    return float(np.abs(got - want).max() / (np.abs(want).max() or 1.0))


@pytest.mark.parametrize("t", [37, 200, 257, 384])
@pytest.mark.parametrize("rel", [True, False])
@pytest.mark.parametrize("masked", [True, False])
def test_plain_version_matches_jax_kernel_f32(t, rel, masked):
    args = _inputs(2, 2, t, 32, rel, masked, seed=t)
    got = _port_out(*args, torch.float32)
    want = _jax_out(*args, jnp.float32)
    assert np.isfinite(got).all()
    assert _rel_err(got, want) < F32_REL


@pytest.mark.parametrize("hd", [80, 128])
@pytest.mark.parametrize("rel", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_jax_kernel_wide_head_dims(hd, rel, dtype):
    """The head dims the bf16 kernel serves in two column chunks (80 = 64 +
    16, 128 = 64 + 64): the plain version against the JAX kernel."""
    args = _inputs(1, 2, 100, hd, rel, True, seed=hd)
    got = _port_out(*args, getattr(torch, dtype))
    want = _jax_out(*args, getattr(jnp, dtype))
    assert np.isfinite(got).all()
    assert _rel_err(got, want) < (F32_REL if dtype == "float32" else BF16_REL)


@pytest.mark.parametrize("t,rel,masked", [(257, True, True), (200, False, False)])
def test_plain_version_matches_jax_kernel_bf16(t, rel, masked):
    args = _inputs(2, 2, t, 64, rel, masked, seed=1)
    got = _port_out(*args, torch.bfloat16)
    want = _jax_out(*args, jnp.bfloat16)
    assert _rel_err(got, want) < BF16_REL


def test_plain_version_is_the_per_diagonal_definition():
    """bd[i, k] = q_pos[i]·(pe_{i−k}·W_pos), with the table built in f64
    (the JAX tests' oracle), at T = 37 (padded to 256)."""
    b, nh, t, hd = 1, 2, 37, 16
    q, k, v, mask, q_pos, w_pos = _inputs(b, nh, t, hd, True, True, seed=3)
    h = nh * hd
    d = np.arange(t)[:, None] - np.arange(t)[None, :]
    inv = np.exp(np.arange(0, h, 2) * (-np.log(10000.0) / h))
    ang = d[..., None] * inv
    pe = np.stack([np.sin(ang), np.cos(ang)], -1).reshape(t, t, h)
    r = (pe @ w_pos.astype(np.float64)).reshape(t, t, nh, hd)
    s = np.einsum("bhqd,bhkd->bhqk", q, k) + np.einsum("bhid,ikhd->bhik", q_pos, r)
    s = s * hd ** -0.5 + mask[:, None, None, :]
    p = np.exp(s - s.max(-1, keepdims=True))
    want = np.einsum("bhqk,bhkd->bhqd", p / p.sum(-1, keepdims=True), v)
    got = _port_out(q, k, v, mask, q_pos, w_pos, torch.float32)
    assert _rel_err(got, want) < F32_REL


@pytest.mark.parametrize("t_pad,h", [(256, 32), (512, 64), (1536, 1024)])
def test_pe_table_is_the_jax_table_bit_for_bit(t_pad, h):
    np.testing.assert_array_equal(fa._pe_table(t_pad, h), jax_fa._pe_table(t_pad, h))


@pytest.mark.parametrize("t_pad,nh,h", [(256, 2, 32), (512, 4, 64)])
def test_rel_table_rev_matches_jax(t_pad, nh, h):
    w = (np.random.default_rng(h).normal(size=(h, h)) * 0.1).astype(np.float32)
    got = fa.rel_table_rev(torch.from_numpy(w), nh, t_pad, torch.float32).numpy()
    want = np.asarray(jax_fa.rel_table_rev(jnp.asarray(w), nh, t_pad, jnp.float32))
    assert got.shape == want.shape == (nh, 2 * t_pad, h // nh)
    assert _rel_err(got, want) < 1e-6


def test_rel_scores_read_the_diagonal_rows():
    """bd[i, k] reads row T_pad − i + k of the table: every row read lies
    in [1, 2·T_pad)."""
    t, hd = 256, 4
    rel_r = torch.arange(2 * t, dtype=torch.float32)[None, :, None].expand(1, 2 * t, hd)
    q_pos = torch.zeros((1, 1, t, hd))
    q_pos[..., 0] = 1.0
    bd = flash_attention_ref.rel_scores(q_pos, rel_r)[0, 0]
    i, k = torch.meshgrid(torch.arange(t), torch.arange(t), indexing="ij")
    torch.testing.assert_close(bd, (t - i + k).float(), rtol=0, atol=0)
    assert int(bd.min()) == 1 and int(bd.max()) == 2 * t - 1


def test_padding_masks_padded_keys_and_drops_padded_rows():
    """T = 37 pads to 256: the result equals attention over the 37 keys
    alone, computed at T_pad = T by the plain version."""
    q, k, v, mask, _, _ = _inputs(2, 2, 37, 8, False, True, seed=4)
    got = _port_out(q, k, v, mask, None, None, torch.float32)
    s = np.einsum("bhqd,bhkd->bhqk", q, k) * 8 ** -0.5 + mask[:, None, None, :]
    p = np.exp(s - s.max(-1, keepdims=True))
    want = np.einsum("bhqk,bhkd->bhqd", p / p.sum(-1, keepdims=True), v)
    assert _rel_err(got, want) < F32_REL


def test_use_flash_dispatch_rule(monkeypatch):
    monkeypatch.delenv(fa.FORCE_ENV, raising=False)
    assert fa.use_flash(64, rel=True)
    assert fa.use_flash(64, rel=True, dtype=torch.float32)
    assert fa.use_flash(128, rel=True, dtype=torch.float32)
    assert not fa.use_flash(64)  # plain attention: only when forced
    assert not fa.use_flash(256, rel=True)  # beyond the head_dim cap
    assert not fa.use_flash(64, rel=True, dtype=torch.float16)  # no kernel type
    monkeypatch.setenv(fa.FORCE_ENV, "1")
    assert fa.use_flash(64) and fa.use_flash(32, dtype=torch.float32)
    assert not fa.use_flash(200, rel=True)


@pytest.mark.parametrize("hd,dtype,rel", [
    (16, torch.float32, False), (32, torch.bfloat16, True), (64, torch.bfloat16, True),
    (100, torch.float32, True), (128, torch.float32, True),
])
def test_shared_memory_within_one_block(hd, dtype, rel):
    need = fa.smem_bytes(hd, dtype, rel)
    assert 0 < need <= fa.MAX_SMEM_BYTES
    fa.check_fits(hd, dtype, rel)


@pytest.mark.parametrize("hd,dtype,rel,want", [
    # bf16, wgmma: bf16 rows of hd * 2 bytes, nothing past hd (q[, q_pos],
    # two stages of K, V[, an R window of 128 + BK rows]); with rel eight
    # [16, BK + 8] f32 shear slabs; two BK-key f32 mask tiles, 5
    # mbarriers, 1 KiB of base alignment. BK = 128; with rel 64, and 32 at
    # hd 128
    (16, torch.bfloat16, True, (256 + 2 * (128 + 192)) * 32 + 8 * 4608 + 512 + 40 + 1024),
    (32, torch.bfloat16, False, (128 + 2 * 256) * 64 + 1024 + 40 + 1024),
    (64, torch.bfloat16, True, (256 + 2 * (128 + 192)) * 128 + 8 * 4608 + 512 + 40 + 1024),
    (64, torch.bfloat16, False, (128 + 2 * 256) * 128 + 1024 + 40 + 1024),
    (80, torch.bfloat16, True, (256 + 2 * (128 + 192)) * 160 + 8 * 4608 + 512 + 40 + 1024),
    (128, torch.bfloat16, True, (256 + 2 * (64 + 160)) * 256 + 8 * 2560 + 256 + 40 + 1024),
    (80, torch.bfloat16, False, (128 + 2 * 256) * 160 + 1024 + 40 + 1024),
    (128, torch.bfloat16, False, (128 + 2 * 256) * 256 + 1024 + 40 + 1024),
    # f32, FMAs fed by TMA: f32 rows of the width's columns, nothing past
    # it (q[, q_pos], two stages of K, V[, the R ring]); two BK-key f32
    # mask tiles, 5 mbarriers, 1 KiB of base alignment. 128 query rows, 64
    # keys, a ring of 256 rows; with rel at hd 128 64 rows, 32 keys, a ring
    # of 128
    (64, torch.float32, True, (256 + 2 * 128 + 256) * 256 + 512 + 40 + 1024),
    (128, torch.float32, True, (128 + 2 * 64 + 128) * 512 + 256 + 40 + 1024),
    (16, torch.float32, False, (128 + 2 * 128) * 64 + 512 + 40 + 1024),
])
def test_shared_memory_sizes_are_pinned(hd, dtype, rel, want):
    assert fa.smem_bytes(hd, dtype, rel) == want <= fa.MAX_SMEM_BYTES


@pytest.mark.parametrize("hd", [16, 32, 64, 80, 128])
@pytest.mark.parametrize("rel", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_served_head_dims_fit(hd, rel, dtype):
    """Every head dim the bf16 kernel serves fits one block in both kernels,
    rel on and off."""
    need = fa.smem_bytes(hd, dtype, rel)
    assert 0 < need <= fa.MAX_SMEM_BYTES and fa.fits(hd, dtype, rel)
    fa.check_fits(hd, dtype, rel)


@pytest.mark.parametrize("rel", [True, False])
def test_head_dim_80_is_not_the_128_template(rel):
    """hd 80 is two bf16 column chunks, 64 + 16, and three f32 ones, 32 +
    32 + 16: the tiles of both kernels hold 80 columns a row, not the 128
    of a zero-filled template."""
    bk, stages = fa.wgmma_key_tile(80, rel), fa.WGMMA_STAGES
    rows = fa.WGMMA_BQ * (2 if rel else 1) + stages * (2 * bk + (fa.WGMMA_BQ + bk if rel else 0))
    fixed = fa.smem_bytes(80, torch.bfloat16, rel) - rows * 80 * 2
    assert fixed == (8 * 16 * (bk + 8) * 4 if rel else 0) + stages * (bk * 4 + 16) + 8 + 1024
    if not rel:  # one key tile for both: the 128-wide tiles are larger
        assert fa.smem_bytes(80, torch.bfloat16, rel) < fa.smem_bytes(128, torch.bfloat16, rel)
    bq, bk, ring = fa.f32_tiles(80, rel)
    rows = bq * (2 if rel else 1) + 2 * 2 * bk + (ring if rel else 0)
    fixed = fa.smem_bytes(80, torch.float32, rel) - rows * 80 * 4
    assert fixed == 2 * (bk * 4 + 16) + 8 + 1024
    if not rel:
        assert fa.smem_bytes(80, torch.float32, rel) < fa.smem_bytes(128, torch.float32, rel)


@pytest.mark.parametrize("rel", [True, False])
def test_f32_serves_every_head_dim_to_128(rel):
    """The f32 kernel takes head dims 1..128: each runs the first width of
    16, 32, 64, 80, 96, 128 that holds it (so every column chunk of 32
    starts below hd), within one block's shared memory."""
    for hd in range(1, fa.HEAD_DIM_CAP + 1):
        width = fa._template_width(hd)
        assert width == min(w for w in fa.F32_WIDTHS if w >= hd)
        assert 32 * ((width - 1) // 32) < hd  # the last chunk starts below hd
        assert fa.fits(hd, torch.float32, rel)
        fa.check_fits(hd, torch.float32, rel)


@pytest.mark.parametrize("hd,rel,want", [
    (64, True, (128, 64, 256)), (64, False, (128, 64, 256)), (80, True, (128, 32, 256)),
    (80, False, (128, 64, 256)), (96, True, (64, 32, 128)), (128, True, (64, 32, 128)),
    (128, False, (128, 64, 256)), (16, True, (128, 64, 256)),
])
def test_f32_tiles_are_pinned(hd, rel, want):
    """The f32 kernel's (query rows, keys, R ring rows): 4 x 8 scores a
    thread at 128 x 64 wherever they fit; the ring holds a tile's BQ + BK −
    1 window rows and the next tile's BK."""
    bq, bk, ring = fa.f32_tiles(hd, rel)
    assert (bq, bk, ring) == want
    assert ring >= bq + 2 * bk and ring % bk == 0 and fa.pad_len(1) % bq == 0


def test_check_tma_aligned_raises_on_a_misaligned_base():
    buf = torch.zeros(2 * 256 * 64 + 8, dtype=torch.bfloat16)
    aligned = buf[:2 * 256 * 64].view(2, 256, 64)
    assert aligned.data_ptr() % 16 == 0
    fa.check_tma_aligned(q=aligned, mask=None)
    shifted = buf[1:1 + 2 * 256 * 64].view(2, 256, 64)  # 2 bytes past the base
    assert shifted.is_contiguous()
    with pytest.raises(ValueError, match="k starts at .* 16-byte alignment"):
        fa.check_tma_aligned(q=aligned, k=shifted)


@pytest.mark.parametrize("dtype,want", [
    (torch.bfloat16, "wgmma"), (torch.float32, "fma"), (torch.float16, None),
])
def test_dtype_picks_the_kernel(dtype, want):
    """bf16 launches the wgmma kernel, f32 the exact FMA kernel fed by TMA
    (the TPU's HIGHEST path); no other dtype has a kernel."""
    assert fa.kernel_for(dtype) == want
    assert fa.fits(64, dtype, True) == (want is not None)


@pytest.mark.parametrize("hd,dtype", [(0, torch.float32), (129, torch.float32),
                                      (64, torch.float16), (48, torch.bfloat16),
                                      (100, torch.bfloat16), (8, torch.bfloat16)])
def test_check_fits_refuses_what_no_template_serves(hd, dtype):
    with pytest.raises(ValueError, match="K5"):
        fa.check_fits(hd, dtype, True)


def test_wrapper_refuses_bad_arguments():
    q = torch.zeros((1, 2, 40, 8))
    with pytest.raises(ValueError, match="together"):
        fa.flash_attention(q, q, q, q_pos=q)
    with pytest.raises(ValueError, match="rel_r"):
        fa.flash_attention(q, q, q, q_pos=q, rel_r=torch.zeros((2, 80, 8)))
    with pytest.raises(ValueError, match="no attention kernel"):
        fa.flash_attention(q.to("meta"), q.to("meta"), q.to("meta"))
