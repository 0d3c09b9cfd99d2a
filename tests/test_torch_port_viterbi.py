"""PyTorch port vs the JAX package: banded CTC Viterbi.

The port's plain PyTorch DP (ops.viterbi_ref.viterbi_batch, which the K1
kernel's wrapper runs for CPU tensors) must be BIT-IDENTICAL to the numpy
oracle and to the JAX K1 Pallas kernel (`viterbi_pallas_batch`, interpret
mode on the CPU, as tests/test_viterbi_pallas.py runs it): tolerance 0.
The CUDA kernel itself is held to the plain version on the card by
tests/test_torch_port_cuda.py (marked `cuda`) and by chip_smoke.py.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from wav2vec2_tpu.ops.viterbi_pallas import viterbi_pallas_batch
from wav2vec2_tpu.ops.viterbi_ref import viterbi_numpy as jax_viterbi_numpy
from wav2vec2_tpu_torch.ops import viterbi_cuda, viterbi_ref


def _log_probs(rng, b, t, v):
    x = rng.normal(size=(b, t, v)).astype(np.float32) * 3
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


def _oracle(lp, tok, t_len, s_len):
    return [s for s, _ in jax_viterbi_numpy(lp[:t_len], tok[:s_len])]


def _plain(lp, tok, t_lens, s_lens):
    return viterbi_ref.viterbi_batch(
        *(torch.from_numpy(a) for a in (lp, tok, t_lens, s_lens))).numpy()


def _check_rows(paths, lp, tok, t_lens, s_lens):
    for j, (t_i, s_i) in enumerate(zip(t_lens, s_lens)):
        want = _oracle(lp[j], tok[j], int(t_i), int(s_i))
        assert list(paths[j, :t_i]) == want, f"row {j}"
        assert (paths[j, t_i:] == want[-1]).all(), f"row {j}: frozen frames"


@pytest.mark.parametrize("seed", range(8))
def test_plain_batch_matches_numpy_oracle(seed):
    rng = np.random.default_rng(seed)
    b, t_pad, v, s_pad = 4, int(rng.integers(8, 70)), int(rng.integers(4, 12)), 40
    lp = _log_probs(rng, b, t_pad, v)
    tok = rng.integers(0, v, size=(b, s_pad)).astype(np.int32)
    t_lens = rng.integers(1, t_pad + 1, size=b).astype(np.int32)
    s_lens = np.minimum(rng.integers(1, s_pad + 1, size=b), 2 * t_lens).astype(np.int32)
    _check_rows(_plain(lp, tok, t_lens, s_lens), lp, tok, t_lens, s_lens)


def test_carried_numpy_oracle_is_the_jax_oracle():
    rng = np.random.default_rng(11)
    lp = _log_probs(rng, 1, 30, 7)[0]
    tok = rng.integers(0, 7, size=17)
    assert viterbi_ref.viterbi_numpy(lp, tok) == jax_viterbi_numpy(lp, tok)
    assert viterbi_ref.viterbi_numpy(lp[:0], tok) == []


def _edge_batch():
    """s_len=1; s_len=2*t_len (tightest band); repeated tokens
    [0,1,0,1,0] (skip rule); t_len < T_pad; -inf emissions (ties)."""
    rng = np.random.default_rng(5)
    t_pad, s_pad, v = 24, 48, 6
    lp = _log_probs(rng, 5, t_pad, v)
    lp[4, :, 2] = -np.inf
    tok = rng.integers(0, v, size=(5, s_pad)).astype(np.int32)
    tok[2, :5] = [0, 1, 0, 1, 0]
    tok[4, :20:2] = 2
    t_lens = np.array([24, 20, 12, 24, 16], np.int32)
    s_lens = np.array([1, 40, 5, 48, 20], np.int32)
    return lp, tok, t_lens, s_lens


def test_plain_edge_cases_match_numpy_oracle():
    lp, tok, t_lens, s_lens = _edge_batch()
    _check_rows(_plain(lp, tok, t_lens, s_lens), lp, tok, t_lens, s_lens)


@pytest.mark.parametrize("case", ["random", "edge"])
def test_plain_matches_jax_k1_interpret(case):
    """The JAX K1 kernel (vmapped `_viterbi_kernel_resident`, interpret
    mode) and the port's plain version give identical paths on every frame,
    padded frames included."""
    if case == "edge":
        lp, tok, t_lens, s_lens = _edge_batch()
    else:
        rng = np.random.default_rng(21)
        lp = _log_probs(rng, 3, 40, 9)
        tok = rng.integers(0, 9, size=(3, 30)).astype(np.int32)
        t_lens = np.array([40, 33, 9], np.int32)
        s_lens = np.array([30, 21, 11], np.int32)
    want = np.asarray(viterbi_pallas_batch(
        jnp.asarray(lp), jnp.asarray(tok), jnp.asarray(t_lens), jnp.asarray(s_lens),
        interpret=True))
    got = _plain(lp, tok, t_lens, s_lens)
    np.testing.assert_array_equal(got, want)


def test_wrapper_on_cpu_runs_the_plain_version_without_counting():
    lp, tok, t_lens, s_lens = _edge_batch()
    before = dict(viterbi_cuda.launches)
    got = viterbi_cuda.viterbi_batch(*(torch.from_numpy(a) for a in (lp, tok, t_lens, s_lens)))
    assert viterbi_cuda.launches == before
    np.testing.assert_array_equal(got.numpy(), _plain(lp, tok, t_lens, s_lens))
    one = viterbi_cuda.viterbi_single(torch.from_numpy(lp[2]), torch.from_numpy(tok[2]), 12, 5)
    assert list(one.numpy()[:12]) == _oracle(lp[2], tok[2], 12, 5)


def test_wrapper_raises_for_devices_without_a_kernel():
    lp = torch.zeros((1, 4, 3), device="meta")
    tok = torch.zeros((1, 4), dtype=torch.int32, device="meta")
    lens = torch.ones(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        viterbi_cuda.viterbi_batch(lp, tok, lens, lens)


@pytest.mark.parametrize("bad", ["dtype", "tokens_dtype", "shape", "contiguity", "lens"])
def test_wrapper_input_checks(bad):
    lp = torch.zeros((2, 6, 5))
    tok = torch.zeros((2, 4), dtype=torch.int32)
    t_lens = torch.full((2,), 6, dtype=torch.int32)
    s_lens = torch.full((2,), 4, dtype=torch.int32)
    if bad == "dtype":
        lp = lp.double()
    elif bad == "tokens_dtype":
        tok = tok.long()
    elif bad == "shape":
        lp = lp[0]
    elif bad == "contiguity":
        lp = torch.zeros((2, 5, 6)).transpose(1, 2)
    else:
        t_lens = t_lens[:1]
    with pytest.raises((TypeError, ValueError)):
        viterbi_cuda._check_inputs(lp, tok, t_lens, s_lens)
