"""The plain PyTorch version of K5, the fused rel-pos attention kernel.

A direct attention with the Transformer-XL position term in its
per-diagonal definition, on inputs already padded to T_pad by
`ops.flash_attention.flash_attention`:

    bd[b, h, i, k] = q_pos[b, h, i] · rel_r[h, T_pad − i + k]
    s = (q·kᵀ + bd) · scale + mask          (f32)
    out = softmax(s).to(v.dtype) · v       (f32 sum, rounded to q.dtype)

the oracle of `tests/test_flash_attention.py` over the kernel's own table.
The CPU tests run it for the kernel, and `chip_smoke.py` holds the kernel
to it on the card. It gathers an [NH, T_pad, T_pad, hd] f32 window of the
table, so it is a reference, not a serving path. Products are f32 matmuls:
on the card the caller keeps TF32 off (PyTorch's default for matmuls).
"""

from __future__ import annotations

import torch


def rel_scores(q_pos: torch.Tensor, rel_r: torch.Tensor) -> torch.Tensor:
    """bd [B, NH, T, T] f32 for q_pos [B, NH, T, hd] and rel_r
    [NH, 2·T, hd]: score (i, k) reads row T − i + k ∈ [1, 2·T)."""
    t = q_pos.shape[2]
    if rel_r.shape[1] != 2 * t:
        raise ValueError(f"rel_r has {rel_r.shape[1]} rows, want 2·T = {2 * t}")
    pos = torch.arange(t, device=q_pos.device)
    rows = t - pos[:, None] + pos[None, :]
    return torch.einsum("bhid,hikd->bhik", q_pos.float(), rel_r.float()[:, rows])


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask_bias: torch.Tensor | None = None,
    *,
    q_pos: torch.Tensor | None = None,
    rel_r: torch.Tensor | None = None,
    scale: float = 1.0,
) -> torch.Tensor:
    """q, k, v [B, NH, T, hd]; mask_bias [B, T] f32 or None; q_pos and
    rel_r both given (rel mode) or both None. Returns [B, NH, T, hd] in
    q.dtype."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if rel_r is not None:
        s = s + rel_scores(q_pos, rel_r)
    s = s * scale
    if mask_bias is not None:
        s = s + mask_bias.float()[:, None, None, :]
    attn = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(attn.float(), v.float()).to(q.dtype)
