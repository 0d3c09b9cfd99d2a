"""PyTorch port vs the JAX package: the Viterbi DP past one block's 16 384
states, where the port runs K4 on a thread-block cluster.

- The JAX package's K4 tier (`viterbi_pallas_single_hbm`, interpret mode
  on the CPU, as tests/test_viterbi_pallas.py runs it) against the port's
  plain version at S = 20 001 (V = 32, a ragged batch of 2) and S = 17 001
  (V = 392): the widths long-form sends past 14 minutes. Tolerance 0.
- A host emulation of K4 on a cluster (csrc/viterbi_blocked.cu): the DP
  run as n slices by the wrapper's own rule (`viterbi_cuda.cluster_shape`,
  `cluster_slices`), each block reading only its own states and the two
  scores its left neighbour handed over for the frame before, R-state
  strips skipped where they miss the band, 2-bit backpointers packed by
  strips into a row of random bytes (the scratch is never cleared), the
  final-state rule, and the kernel's blocked backtrace over the global
  rows. Held to `viterbi_numpy` bit for bit. The kernel itself is held to
  the plain version on the card (tests/test_torch_port_cuda.py,
  chip_smoke.py).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import wav2vec2_tpu.ops.viterbi_pallas as vp
from wav2vec2_tpu.ops.viterbi_ref import viterbi_numpy as jax_viterbi_numpy
from wav2vec2_tpu_torch.ops import viterbi_cuda

NEG = np.float32(-np.inf)


def _log_probs(rng, b, t, v):
    x = rng.normal(size=(b, t, v)).astype(np.float32) * 3
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


def _plain(lp, tok, t_lens, s_lens):
    return viterbi_cuda.viterbi_batch(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in (lp, tok, t_lens, s_lens))).numpy()


def test_plain_version_matches_jax_k4_at_20001_states():
    """A ragged batch of 2 through the port's plain version against
    `viterbi_pallas_single_hbm` on each row (its one-hot gather tier,
    `_viterbi_hbm_gather`: the tier `viterbi_pallas_batch` also takes at
    this width). The batch entry itself in interpret mode grows faster
    than T·S here (57 s at T = 4 000, S = 8 001 on a CPU), so it is held
    to the plain version at its own shapes in
    tests/test_torch_port_viterbi_tiers.py."""
    t, v, s = 10_500, 32, 20_001
    assert not 4 * t * s <= vp.VMEM_BUDGET_BYTES and vp._use_onehot_gather(v, s)
    s_pad = -(-s // 4) * 4
    assert viterbi_cuda.select_tier(t, s_pad, v) == "k4"
    assert viterbi_cuda.cluster_size(s_pad) == 2
    rng = np.random.default_rng(20_001)
    lp = _log_probs(rng, 2, t, v)
    tok = rng.integers(0, v, size=(2, s)).astype(np.int32)
    t_lens = np.array([t, 9_001], np.int32)
    s_lens = np.array([s, 15_002], np.int32)
    want = np.stack([np.asarray(vp.viterbi_pallas_single_hbm(
        jnp.asarray(lp[j]), jnp.asarray(tok[j]), jnp.int32(t_lens[j]), jnp.int32(s_lens[j]),
        interpret=True)) for j in range(2)])
    got = _plain(lp, tok, t_lens, s_lens)
    np.testing.assert_array_equal(got, want)
    assert (got[1, 9_001:] == got[1, 9_000]).all()


def test_plain_version_matches_jax_k4_single_at_phoneme_width():
    """`viterbi_pallas_single_hbm` at V = 392, S = 17 001 (its one-hot
    gather tier `_viterbi_hbm_gather`), one utterance with t_len < T."""
    t, t_len, v, s = 10_500, 10_321, 392, 17_001
    assert vp._use_onehot_gather(v, s)
    rng = np.random.default_rng(17_001)
    lp = _log_probs(rng, 1, t, v)[0]
    tok = rng.integers(0, v, size=s).astype(np.int32)
    want = np.asarray(vp.viterbi_pallas_single_hbm(
        jnp.asarray(lp), jnp.asarray(tok), jnp.int32(t_len), jnp.int32(s), interpret=True))
    s_pad = -(-s // 128) * 128
    assert viterbi_cuda.select_tier(t, s_pad, v) == "k4"
    assert viterbi_cuda.cluster_size(s_pad) == 2
    tok_pad = np.zeros(s_pad, np.int32)
    tok_pad[:s] = tok
    got = viterbi_cuda.viterbi_single(torch.from_numpy(lp), torch.from_numpy(tok_pad),
                                      t_len, s).numpy()
    np.testing.assert_array_equal(got, want)


# --- the host emulation of K4 on a cluster ---------------------------------

def _emulate_cluster(lp, tok, t_len, s_len, n, seed):
    """One utterance through K4 on a cluster of n blocks, as the kernel
    computes it: lp [T_pad, V] f32, tok [S_pad] → path [T_pad]."""
    t_pad, s_pad = lp.shape[0], tok.shape[0]
    w = -(-s_pad // 4) * 4
    n_got, r, _ = viterbi_cuda.cluster_shape(s_pad, n)
    assert n_got == n
    slices = viterbi_cuda.cluster_slices(s_pad, n)
    assert slices[0][0] == 0 and slices[-1][1] == w
    assert all(a[1] == b[0] and a[0] % r == 0 and a[1] > a[0]
               for a, b in zip(slices, slices[1:]))
    s_len = min(s_len, s_pad)
    states = np.arange(w)
    tk = np.where(states < s_pad, np.pad(tok, (0, w - s_pad)), 0)
    tk2 = np.where((states >= 2) & (states - 2 < s_pad), np.roll(tk, 2), 0)
    pen = np.where((states >= 2) & (tk != tk2), np.float32(0), NEG).astype(np.float32)
    emit = lp[:, tk]  # [T_pad, W]: window row i read at the strip's tokens
    n_quads = w // 4
    # the backpointer scratch is never cleared: start from random bytes
    bp = np.random.default_rng(seed).integers(0, 256, size=(t_pad, n_quads), dtype=np.uint8)

    t_end = max(min(t_len, t_pad), 0)
    t_run = max(t_end, 1)
    final_floor = max(s_len - 2, 0)
    # each block's own scores; what block k handed block k+1 last frame
    sc = [np.full(b - a, NEG, np.float32) for a, b in slices]
    handed = [(NEG, NEG)] * n
    sc[0][0] = emit[0, 0]  # the init row, on block 0's first strip
    if s_len > 1 and s_pad > 1:
        sc[0][1] = emit[0, 1]
    for t in range(1, t_run):
        band_lo = max(final_floor - 2 * (t_len - 1 - t), 0)
        band_hi = min(2 * t + 1, s_len - 1)
        new = []
        for k, (a, b) in enumerate(slices):
            left2, left1 = handed[k] if k else (NEG, NEG)
            ext = np.concatenate([np.array([left2, left1], np.float32), sc[k]])
            stay, c1 = sc[k], ext[1:-1]
            c2 = (ext[:-2] + pen[a:b]).astype(np.float32)
            m1 = c1 > stay
            best = np.where(m1, c1, stay)
            m2 = c2 > best
            best = np.where(m2, c2, best)
            row = (best + emit[t, a:b]).astype(np.float32)
            out = sc[k].copy()
            for s0 in range(a, b, r):  # strips meeting the band, whole
                if s0 <= band_hi and s0 + r - 1 >= band_lo:
                    e = min(s0 + r, b)
                    out[s0 - a:e - a] = row[s0 - a:e - a]
                    m = e - s0  # the strip's states inside W
                    bits = int(sum(int(x) << i for i, x in enumerate(m1[s0 - a:e - a])))
                    bits |= int(sum(int(x) << i for i, x in enumerate(m2[s0 - a:e - a]))) << m
                    bp[t, s0 // 4:s0 // 4 + m // 4] = np.frombuffer(
                        bits.to_bytes(m // 4, "little"), np.uint8)
            new.append(out)
        # each block hands its last two scores of this frame to the next
        handed = [(NEG, NEG)] + [(new[k][-2], new[k][-1]) for k in range(n - 1)]
        sc = new

    def score(s):
        k = next(i for i, (a, b) in enumerate(slices) if a <= s < b)
        return sc[k][s - slices[k][0]]

    idx_last, idx_prev = max(s_len - 1, 0), max(s_len - 2, 0)
    final_s = idx_prev if s_len >= 2 and score(idx_prev) > score(idx_last) else idx_last

    def step(s, row):
        q = s // r
        m = min(r, w - q * r)
        base, k = q * (r // 4), s % r
        m1 = (int(row[base + (k >> 3)]) >> (k & 7)) & 1
        m2 = (int(row[base + ((m + k) >> 3)]) >> ((m + k) & 7)) & 1
        return (2 if m2 else m1), {base + (k >> 3), base + ((m + k) >> 3)}

    path = np.full(t_pad, final_s, np.int32)
    s = final_s
    for hi in range(t_end - 1, -1, -8):  # the kernel's 8-frame windows
        c0 = (max(s - 14, 0) // r) * (r // 4)
        for t in range(hi, max(hi - 7, 0) - 1, -1):
            path[t] = s
            if t >= 1 and s <= 2 * t + 1:
                d, read = step(s, bp[t])
                assert all(c0 <= i < c0 + 16 for i in read), "read outside the 16-byte window"
                s -= d
    return path


def _cluster_case(kind, n, seed):
    """(lp, tok, t_len, s_len): `ties` rounds log-probs to 0.5 with t_len
    < T_pad and s_len < S_pad, `full` fills the band to s_len = S_pad,
    `no_path` has all -inf log-probs; the tokens repeat across every slice
    boundary a (tokens[a] == tokens[a-2], tokens[a+1] == tokens[a-1])."""
    rng = np.random.default_rng(seed)
    v = 6
    s_pad = int(rng.integers(230, 301))
    t_pad = int(rng.integers(s_pad // 2 + 20, 201))
    lp = _log_probs(rng, 1, t_pad, v)[0]
    tok = rng.integers(0, v, size=s_pad).astype(np.int32)
    for a, _ in viterbi_cuda.cluster_slices(s_pad, n)[1:]:
        tok[a] = tok[a - 2]
        if a + 1 < s_pad:
            tok[a + 1] = tok[a - 1]
    t_len, s_len = t_pad, s_pad
    if kind == "ties":
        lp = np.round(lp * 2) / 2
        t_len = t_pad - int(rng.integers(3, 12))
        s_len = min(s_pad - int(rng.integers(5, 40)), 2 * t_len)
    elif kind == "full":
        t_len = max(t_pad, -(-s_pad // 2))
    else:
        lp[:] = -np.inf
        s_len = s_pad - 7
    return lp.astype(np.float32), tok, t_len, s_len


@pytest.mark.parametrize("kind", ["ties", "full", "no_path"])
@pytest.mark.parametrize("n", [2, 3, 5, 8])
def test_cluster_emulation_matches_numpy_oracle(n, kind):
    lp, tok, t_len, s_len = _cluster_case(kind, n, seed=100 * n + len(kind))
    got = _emulate_cluster(lp, tok, t_len, s_len, n, seed=n)
    want = [s for s, _ in jax_viterbi_numpy(lp[:t_len], tok[:s_len])]
    assert list(got[:t_len]) == want
    assert (got[t_len:] == want[-1]).all()
    plain = _plain(lp[None], tok[None], np.array([t_len], np.int32),
                   np.array([s_len], np.int32))[0]
    np.testing.assert_array_equal(got, plain)


@pytest.mark.parametrize("s_pad,n", [(300, 9), (99_072, 6), (131_076, 0), (20, 8)])
def test_cluster_rule_refuses_what_no_launch_serves(s_pad, n):
    """More than 8 blocks, fewer blocks than 16 384-state slices need, more
    states than 8 blocks hold, or fewer strips than blocks."""
    assert viterbi_cuda.cluster_shape(s_pad, n) == (0, 0, 0)
    assert viterbi_cuda.cluster_slices(s_pad, n) == []
    with pytest.raises(ValueError, match="cluster|states"):
        viterbi_cuda.check_fits("k4", 100, s_pad, 32, n)
