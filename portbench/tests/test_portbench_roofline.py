"""The operation and byte counts against hand counts at small shapes."""

from __future__ import annotations

import pytest

from portbench import roofline


def test_band_cells_by_hand():
    # T 3, S 3: the init row holds 2 states; frame 1 states 0..2 (3: the
    # band's end is min(2t+1, S-1) = 2, its start max(S-2 - 2(T-1-t), 0) = 0);
    # frame 2 states 1..2 (start max(1 - 0, 0) = 1)
    assert roofline.band_cells([3], [3]) == 2 + 3 + 2
    # T 1: the init row alone
    assert roofline.band_cells([1], [5]) == 2
    # T 4, S 3: frames 1..3; frame 1 states 0..2 (start max(1 - 4, 0)),
    # frame 2 states 0..2 (start max(1 - 2, 0)), frame 3 states 1..2
    assert roofline.band_cells([4, 3], [3, 3]) == (2 + 3 + 3 + 2) + (2 + 3 + 2)


def test_dp_bound_by_hand():
    # one row of T 3, S 3, V 32: bytes 4·(3·32 + 3 + 2 + 3) = 416; ops 4 · 7 cells
    want = max(416 / roofline.PEAK_BYTES_PER_S, 28 / roofline.PEAK_F32_OPS_PER_S)
    assert roofline.dp_bound_s("k1", 32, [3], [3]) == pytest.approx(want)
    # K2 reads gathered emissions [T, S]
    want = 4 * (3 * 3 + 3 + 2 + 3) / roofline.PEAK_BYTES_PER_S
    assert roofline.dp_bound_s("k2", 32, [3], [3]) == pytest.approx(want)
    # two rows: the sum of each alone (nothing counted for padding)
    assert roofline.dp_bound_s("k1", 32, [300, 20], [41, 9]) == pytest.approx(max(
        4 * (300 * 32 + 41 + 2 + 300 + 20 * 32 + 9 + 2 + 20) / roofline.PEAK_BYTES_PER_S,
        4 * roofline.band_cells([300, 20], [41, 9]) / roofline.PEAK_F32_OPS_PER_S))


def test_flash_bound_counts_real_lengths():
    # rows of 10 and 20 frames, 2 heads of 4: ops 6·(100 + 400)·4·2 = 24 000;
    # bytes 2·(5·30·2·4 + 2·(2·20 − 1)·4) + 4·30 = 3 144
    t = roofline.flash_bound_s([10, 20], 2, 4, 2, 1e12)
    assert t == pytest.approx(max(3144 / roofline.PEAK_BYTES_PER_S, 24_000 / 1e12))
    assert roofline.flash_bound_s([10, 20], 2, 4, 2, 1.0) == pytest.approx(24_000.0)
    # padding a row does not add work: only its real length counts
    assert roofline.flash_bound_s([20], 2, 4, 2, 1.0) == pytest.approx(6 * 400 * 8)


def _cfg(model_type):
    cfg = dict(model_type=model_type, conv_dim=[2, 2], conv_kernel=[2, 2], conv_stride=[1, 1],
               hidden_size=4, intermediate_size=8, num_hidden_layers=1, vocab_size=3,
               num_attention_heads=2, num_conv_pos_embeddings=2, num_conv_pos_embedding_groups=2,
               conv_depthwise_kernel_size=3)
    return cfg


def test_forward_flops_by_hand():
    # 5 samples → frames 4, 3. convs 2·4·2·1·2 + 2·3·2·2·2 = 32 + 48 = 80;
    # projection 2·3·2·4 = 48; pos conv 2·3·4·(4/2)·2 = 96; layer: projections
    # 2·3·4·16 = 384, attention 4·9·4 = 144, FFN 2·3·2·4·8 = 384; head 2·3·4·3 = 72
    assert roofline.forward_flops(_cfg("wav2vec2"), 5) == 80 + 48 + 96 + 384 + 144 + 384 + 72
    # the conformer: no pos conv; two FFNs 768; the position term 2·5·16 +
    # 2·9·4 = 232; the conv module 2·3·4·8 + 2·3·4·3 + 2·3·4·4 = 360
    assert roofline.forward_flops(_cfg("wav2vec2-conformer"), 5) == (
        80 + 48 + 384 + 144 + 768 + 232 + 360 + 72)
