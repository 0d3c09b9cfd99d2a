"""Normalization / activation / linear primitives of the wav2vec2 graph.

PyTorch counterparts of `wav2vec2_tpu.models.layers`. Norm statistics are
always taken in float32 whatever the compute dtype, and the result is cast
back to the input dtype, as in the JAX package.

The inference forward works in place on a few f32 temporaries (the
frontend's first activation is [B, 512, ~N/5]). Autograd cannot take in-place
steps whose inputs it saved, so where a gradient is wanted (`wants_grad`:
grad mode on and an operand requiring grad, as in the train step) the norms
and SiLU run the same operations out of place, and the bf16 GELU is an
autograd Function whose forward is the in-place code and whose backward
recomputes the derivative from its input alone. Either way the values are
the same, bit for bit.

Everything here is ATen operations. `ops.norm_gelu` runs the bf16/f16 GELU
and the conv frontend's norm + GELU in one hand-written kernel (K6) on the
card, and keeps these as its plain version.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch
import torch.nn.functional as F


_tf32_lock = threading.Lock()
_tf32_holders = 0  # blocks open in any thread
_tf32_saved: tuple[bool, bool] | None = None


@contextlib.contextmanager
def full_f32_precision():
    """TF32 off for matmuls and cuDNN convolutions inside the block.

    The flags are process-global, so the block is shared between threads:
    the first thread to enter saves the flags and turns TF32 off, TF32
    stays off while any thread (or a nested block) is inside, and the last
    one to leave restores the saved flags."""
    global _tf32_holders, _tf32_saved
    with _tf32_lock:
        if _tf32_holders == 0:
            _tf32_saved = (torch.backends.cuda.matmul.allow_tf32,
                           torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        _tf32_holders += 1
    try:
        yield
    finally:
        with _tf32_lock:
            _tf32_holders -= 1
            if _tf32_holders == 0:
                (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32) = _tf32_saved


def wants_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd records an operation on these tensors."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


# Abramowitz–Stegun 7.1.26: erf(a) ≈ 1 − P(u)·exp(−a²), u = 1 / (1 + p·a),
# P(u) = u·(a1 + u·(a2 + u·(a3 + u·(a4 + u·a5))))
_AS_P = 0.3275911
_AS_A = (0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429)
_INV_SQRT2 = 0.7071067811865476


def gelu_as(x: torch.Tensor) -> torch.Tensor:
    """The A&S GELU of a lower-precision x, in place on three f32
    temporaries: the frontend's first activation is [B, 512, ~N/5], and one
    f32 temporary per operation would not fit on the card at B=128."""
    xf = x.float()
    za = torch.abs(xf).mul_(_INV_SQRT2)  # |z|, z = x / sqrt(2)
    u = torch.reciprocal(za.mul(_AS_P).add_(1.0))
    poly = u.mul(_AS_A[4]).add_(_AS_A[3]).mul_(u).add_(_AS_A[2])
    poly = poly.mul_(u).add_(_AS_A[1]).mul_(u).add_(_AS_A[0]).mul_(u)
    del u
    erf = poly.mul_(za.mul_(za).neg_().exp_()).neg_().add_(1.0)  # erf(|z|)
    del za
    erf = erf.copysign_(xf)  # erf is odd: sign(z) * erf(|z|)
    return xf.mul_(0.5).mul_(erf.add_(1.0)).to(x.dtype)


class GeluAS(torch.autograd.Function):
    """The A&S GELU with a gradient. The forward is `gelu_as` and saves
    only x; the backward evaluates d/dx of the same expression in f32:
    0.5·(1 + E(z)) + 0.5·x·E'(z)/√2 with z = x/√2, a = |z|, E(z) =
    sign(z)·(1 − P(u)·e^(−a²)) and E'(z) = e^(−a²)·(2a·P(u) + p·u²·P'(u)),
    the derivative JAX's autodiff takes of its A&S form."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return gelu_as(x)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        xf = x.float()
        a = xf.abs() * _INV_SQRT2
        u = 1.0 / (1.0 + _AS_P * a)
        poly = dpoly = 0.0
        for k in range(len(_AS_A) - 1, -1, -1):  # Horner: P(u)/u and P'(u)
            dpoly = dpoly * u + (k + 1) * _AS_A[k]
            poly = poly * u + _AS_A[k]
        poly = poly * u
        e = torch.exp(-a * a)
        erf = torch.copysign(1.0 - poly * e, xf)
        derf = e * (2.0 * a * poly + _AS_P * u * u * dpoly)
        dy = 0.5 * (1.0 + erf) + (0.5 * _INV_SQRT2) * xf * derf
        return (grad.float() * dy).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Erf-GELU. f32 inputs use the exact erf; lower-precision inputs use
    the JAX package's Abramowitz–Stegun 7.1.26 erf evaluated in f32 (max
    GELU error 2.1e-7, below one bf16 ulp), so both packages round the same
    f32 value to bf16."""
    if x.dtype == torch.float32:
        return F.gelu(x)
    return GeluAS.apply(x) if wants_grad(x) else gelu_as(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    """SiLU / swish (x · sigmoid(x)), the activation of the conformer's FFN
    and conv module, evaluated in f32 and cast back to the input dtype."""
    if x.dtype == torch.float32:
        return F.silu(x)
    return F.silu(x.float(), inplace=not wants_grad(x)).to(x.dtype)


def act_fn(name: str):
    """The activation called `name` in config.json (transformers ACT2FN)."""
    try:
        return {"gelu": gelu, "swish": silu, "silu": silu,
                "relu": torch.relu}[name]
    except KeyError:
        raise NotImplementedError(
            f"hidden_act {name!r} is not supported (expected gelu/swish/relu)"
        ) from None


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float
) -> torch.Tensor:
    """LayerNorm over the last dim with biased variance; f32 statistics and
    affine, output in the input dtype."""
    out = F.layer_norm(
        x.float(), (x.shape[-1],), weight.float(), bias.float(), eps
    )
    return out.to(x.dtype)


def layer_norm_channels(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float
) -> torch.Tensor:
    """LayerNorm over the channels of a [B, C, T] tensor: the values of
    `layer_norm(x.transpose(1, 2), ...).transpose(1, 2)` (f32 statistics
    and affine, output in the input dtype) without the transposes, in place
    on one f32 temporary (the frontend's first activation is [B, 512,
    ~N/5]; a literal port makes one f32 copy per operation)."""
    c = x.shape[1]
    w, b = weight.float().reshape(1, c, 1), bias.float().reshape(1, c, 1)
    xf = x.to(torch.float32, copy=True)
    var, mean = torch.var_mean(xf, dim=1, keepdim=True, correction=0)
    if wants_grad(x, weight, bias):
        return ((xf - mean) * torch.rsqrt(var + eps) * w + b).to(x.dtype)
    xf.sub_(mean).mul_(torch.rsqrt(var.add_(eps)))
    xf.mul_(w).add_(b)
    return xf.to(x.dtype)


def group_norm_1d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int,
    eps: float,
    time_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """GroupNorm over a [B, C, T] tensor, normalizing over
    (channels_per_group, time).

    `time_mask` [B, T] (True = valid) restricts the statistics to valid
    frames, so a padded batch matches unpadded execution; padded positions
    are zeroed on output. One-pass statistics (var = E[x²] − E[x]²) in f32,
    as the JAX package computes them."""
    b, c, t = x.shape
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    cpg = c // num_groups
    # in place on at most two f32 temporaries (the input is [B, 512, ~N/5]),
    # out of place where autograd records the steps
    inplace = not wants_grad(x, weight, bias)

    def mul(a, b_):
        return a.mul_(b_) if inplace else a * b_

    xf = x.to(torch.float32, copy=True).reshape(b, num_groups, cpg, t)
    if time_mask is None:
        mean = xf.mean(dim=(2, 3), keepdim=True)
        s2 = (xf * xf).mean(dim=(2, 3), keepdim=True)
        var = torch.clamp(s2 - mean * mean, min=0.0)
        out = xf.sub_(mean) if inplace else xf - mean
    else:
        m = time_mask.float().reshape(b, 1, 1, t)
        denom = torch.clamp(m.sum(dim=(2, 3), keepdim=True) * cpg, min=1.0)
        xm = xf * m
        mean = xm.sum(dim=(2, 3), keepdim=True) / denom
        s2 = mul(xm, xf).sum(dim=(2, 3), keepdim=True) / denom
        del xm
        var = torch.clamp(s2 - mean * mean, min=0.0)
        out = mul(xf.sub_(mean) if inplace else xf - mean, m)
    out = mul(out, torch.rsqrt(var + eps)).reshape(b, c, t)
    out = mul(out, weight.float().reshape(1, c, 1))
    out = out.add_(bias.float().reshape(1, c, 1)) if inplace else out + bias.float().reshape(1, c, 1)
    if time_mask is not None:
        out = mul(out, time_mask.float().reshape(b, 1, t))
    return out.to(x.dtype)


def linear(
    x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor | None
) -> torch.Tensor:
    """Dense layer with the kernel stored [in, out] (the JAX layout). The
    product is taken in the input dtype (f32 accumulation inside the GEMM),
    then the bias is added in that dtype, as `jnp.dot(...) + bias` does."""
    out = settle(torch.matmul(x, kernel.to(x.dtype)))
    if bias is not None:
        out = out + bias.to(x.dtype)
    return out


def settle(x: torch.Tensor) -> torch.Tensor:
    """A DTensor that holds partial sums (a product whose contracted axis
    is sharded over 'model') made whole by one all-reduce; any other
    tensor as it is."""
    placements = getattr(x, "placements", None)
    if placements is None or not any(p.is_partial() for p in placements):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(placements=[Replicate() if p.is_partial() else p
                                      for p in placements])


def fold_weight_norm(weight_g: np.ndarray, weight_v: np.ndarray) -> np.ndarray:
    """Reconstruct a weight-normalized conv weight from (weight_g, weight_v).

    Both layouts: `(1, 1, K)` (torch weight_norm dim=2, the HF pos-conv)
    normalizes per kernel position over (out, in); `(out, 1, 1)` normalizes
    per output channel over (in, K). Host-side numpy: a load-time
    transform."""
    wv = np.asarray(weight_v, dtype=np.float32)
    wg = np.asarray(weight_g, dtype=np.float32)
    if wg.shape == (1, 1, wv.shape[2]):
        norm = np.sqrt(np.sum(wv * wv, axis=(0, 1), keepdims=True))
        return wv / norm * wg
    if wg.shape == (wv.shape[0], 1, 1):
        norm = np.sqrt(np.sum(wv * wv, axis=(1, 2), keepdims=True))
        return wv / norm * wg
    raise ValueError(f"unsupported weight_g shape {wg.shape} for weight_v {wv.shape}")
