"""The port's CUDA kernels on the card, marked `cuda`: they skip without an
NVIDIA GPU, since a CUDA kernel has no CPU mode (the CPU tests hold the
plain versions to the JAX package instead).

This file imports neither jax nor the JAX package, so it also runs on a GPU
machine that has only the port's dependencies; there, skip `conftest.py`
(it configures JAX):

    python -m pytest --noconftest tests/test_torch_port_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from chip_smoke import blocked_cases, check_flash, check_kernel, flash_cases, kernel_cases
from wav2vec2_tpu_torch.ops import flash_attention, viterbi_cuda, viterbi_ref


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_k1_kernel_matches_plain_on_the_card():
    """K1's paths are bit-identical to its plain PyTorch version (every row
    and frame) and to viterbi_numpy (a few rows) at the serving shape, a
    ragged-t_len batch, the band and skip-rule edge cases, the ring's
    4-byte copies and refills and a long utterance; one launch per case, in
    the mode `k1_mode` gives: resident at the serving shape, device memory
    at the large case."""
    device = _card()
    cases = kernel_cases(np.random.default_rng(0))
    before = viterbi_cuda.launches["k1"]
    modes = {}
    assert check_kernel(device, cases, modes=modes) == 0
    torch.cuda.synchronize()
    assert viterbi_cuda.launches["k1"] == before + len(cases)
    assert modes[cases[0][0]] == "resident"  # the serving shape
    assert modes[cases[-1][0]] == "device"  # the large case
    assert all(modes[name] == viterbi_cuda.k1_mode(lp.shape[1], tok.shape[1], lp.shape[2])
               for name, lp, tok, _, _ in cases)


@pytest.mark.cuda
@pytest.mark.parametrize("strip", viterbi_cuda.K1_STRIPS)
def test_k1_resident_strips_match_plain_on_the_card(strip):
    """Every strip width of K1's resident mode (forced with `k1_batch`)
    gives the plain version's paths on the resident cases."""
    device = _card()
    for name, lp, tok, t_lens, s_lens in kernel_cases(np.random.default_rng(0)):
        if viterbi_cuda.k1_mode(lp.shape[1], tok.shape[1], lp.shape[2]) != "resident":
            continue
        args = [torch.from_numpy(a).to(device) for a in (lp, tok, t_lens, s_lens)]
        got = viterbi_cuda.k1_batch(*args, mode="resident", strip=strip)
        assert torch.equal(got.cpu(), viterbi_ref.viterbi_batch(*[a.cpu() for a in args])), name


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["k2", "k3", "k4"])
def test_blocked_kernel_matches_plain_on_the_card(tier):
    """K2, K3 and K4, each forced by `tier=`: bit-identical to the plain
    version of the tier and to viterbi_numpy on ragged batches, the edge
    cases and odd widths; one launch per case."""
    device = _card()
    cases = blocked_cases(np.random.default_rng(8))[tier]
    before = viterbi_cuda.launches[tier]
    assert check_kernel(device, cases, tier) == 0
    torch.cuda.synchronize()
    assert viterbi_cuda.launches[tier] == before + len(cases)


@pytest.mark.cuda
@pytest.mark.parametrize("tier,t_pad,s_pad,v", [
    ("k2", 100_000, 128, 32), ("k3", 64, 4096, 32), ("k4", 64, 128, 4096),
])
def test_forced_tier_that_does_not_fit_raises_before_launching(tier, t_pad, s_pad, v):
    device = _card()
    lp = torch.zeros((1, t_pad, v), device=device)
    tok = torch.zeros((1, s_pad), dtype=torch.int32, device=device)
    lens = torch.ones(1, dtype=torch.int32, device=device)
    before = dict(viterbi_cuda.launches)
    with pytest.raises(ValueError, match="shared memory"):
        viterbi_cuda.viterbi_batch(lp, tok, lens, lens, tier=tier)
    assert viterbi_cuda.launches == before


@pytest.mark.cuda
def test_k5_kernel_matches_plain_on_the_card():
    """K5 against its plain version within 2e-5 (f32) and 3e-2 (bf16)
    relative: rel on and off, masked and unmasked, odd T (37 to 1 499), head
    dims 32, 64, 80, 128, and the conformer's shape with B cut; one launch
    per case."""
    device = _card()
    cases = flash_cases()
    before = flash_attention.launches["k5"]
    check_flash(device, cases)
    torch.cuda.synchronize()
    assert flash_attention.launches["k5"] == before + len(cases)


@pytest.mark.cuda
@pytest.mark.parametrize("hd,dtype", [(256, torch.float32), (64, torch.float16)])
def test_k5_size_it_does_not_take_raises_before_launching(hd, dtype):
    device = _card()
    q = torch.zeros((1, 1, 256, hd), dtype=dtype, device=device)
    before = dict(flash_attention.launches)
    with pytest.raises(ValueError, match="K5"):
        flash_attention.flash_attention(q, q, q)
    assert flash_attention.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1, 768, 3072), (16, 768, 768), (49, 768, 3072),
                                   (15968, 3072, 768), (5, 12, 20), (33, 8, 9)])
def test_int8_linear_on_the_card(m, k, n):
    """`torch._int_mm` behind `linear_int8` on the card, at the serving
    shapes and at rows, inner and output widths its shape rules refuse
    unpadded: the int32 product equals an f64 product of the same int8
    values (exact below 2**53), and the output is bit-equal to the same
    function on the CPU."""
    from wav2vec2_tpu_torch.models.quantize import (
        int8_matmul,
        linear_int8,
        quantize_linear_int8,
        quantize_rows,
    )

    device = _card()
    rng = np.random.default_rng(m + k + n)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(torch.bfloat16)
    q = quantize_linear_int8({
        "kernel": torch.from_numpy(rng.normal(0, 0.05, size=(k, n)).astype(np.float32)),
        "bias": torch.from_numpy(rng.normal(0, 0.1, size=n).astype(np.float32))})
    card = {name: t.to(device) for name, t in q.items()}
    xq, _ = quantize_rows(x.to(device))
    acc = int8_matmul(xq, card["kernel_q"])
    assert acc.dtype == torch.int32 and acc.shape == (m, n)
    assert torch.equal(acc.double(), xq.double() @ card["kernel_q"].double())
    got = linear_int8(x.to(device), card["kernel_q"], card["scale"], card["bias"])
    want = linear_int8(x, q["kernel_q"], q["scale"], q["bias"])
    assert torch.equal(got.cpu().view(torch.int16), want.view(torch.int16))
    w = torch.from_numpy(rng.normal(0, 0.05, size=(k, n)).astype(np.float32))
    on_card = quantize_linear_int8({"kernel": w.to(device)})
    on_host = quantize_linear_int8({"kernel": w})
    assert all(torch.equal(on_card[key].cpu(), on_host[key]) for key in ("kernel_q", "scale"))
