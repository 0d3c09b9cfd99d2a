"""Normalization / activation / linear primitives of the wav2vec2 graph.

PyTorch counterparts of `wav2vec2_tpu.models.layers`. Norm statistics are
always taken in float32 whatever the compute dtype, and the result is cast
back to the input dtype, as in the JAX package.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F


@contextlib.contextmanager
def full_f32_precision():
    """TF32 off for matmuls and cuDNN convolutions inside the block."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Erf-GELU. f32 inputs use the exact erf; lower-precision inputs use
    the JAX package's Abramowitz–Stegun 7.1.26 erf evaluated in f32 (max
    GELU error 2.1e-7, below one bf16 ulp), so both packages round the same
    f32 value to bf16."""
    if x.dtype == torch.float32:
        return F.gelu(x)
    # the same f32 operations as the JAX form, in place on three f32
    # temporaries: the frontend's first activation is [B, 512, ~N/5], and
    # one f32 temporary per operation would not fit on the card at B=128
    xf = x.float()
    za = torch.abs(xf).mul_(0.7071067811865476)  # |z|, z = x / sqrt(2)
    u = torch.reciprocal(za.mul(0.3275911).add_(1.0))
    poly = u.mul(1.061405429).add_(-1.453152027).mul_(u).add_(1.421413741)
    poly = poly.mul_(u).add_(-0.284496736).mul_(u).add_(0.254829592).mul_(u)
    del u
    erf = poly.mul_(za.mul_(za).neg_().exp_()).neg_().add_(1.0)  # erf(|z|)
    del za
    erf = erf.copysign_(xf)  # erf is odd: sign(z) * erf(|z|)
    return xf.mul_(0.5).mul_(erf.add_(1.0)).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """SiLU / swish (x · sigmoid(x)), the activation of the conformer's FFN
    and conv module, evaluated in f32 and cast back to the input dtype."""
    if x.dtype == torch.float32:
        return F.silu(x)
    return F.silu(x.float(), inplace=True).to(x.dtype)


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
    xf = x.to(torch.float32, copy=True)
    var, mean = torch.var_mean(xf, dim=1, keepdim=True, correction=0)
    xf.sub_(mean).mul_(torch.rsqrt(var.add_(eps)))
    xf.mul_(weight.float().reshape(1, c, 1)).add_(bias.float().reshape(1, c, 1))
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
    # in place on at most two f32 temporaries (the input is [B, 512, ~N/5])
    xf = x.to(torch.float32, copy=True).reshape(b, num_groups, cpg, t)
    if time_mask is None:
        mean = xf.mean(dim=(2, 3), keepdim=True)
        s2 = (xf * xf).mean(dim=(2, 3), keepdim=True)
        var = torch.clamp(s2 - mean * mean, min=0.0)
        out = xf.sub_(mean)
    else:
        m = time_mask.float().reshape(b, 1, 1, t)
        denom = torch.clamp(m.sum(dim=(2, 3), keepdim=True) * cpg, min=1.0)
        xm = xf * m
        mean = xm.sum(dim=(2, 3), keepdim=True) / denom
        s2 = xm.mul_(xf).sum(dim=(2, 3), keepdim=True) / denom
        del xm
        var = torch.clamp(s2 - mean * mean, min=0.0)
        out = xf.sub_(mean).mul_(m)
    out = out.mul_(torch.rsqrt(var + eps)).reshape(b, c, t)
    out = out.mul_(weight.float().reshape(1, c, 1)).add_(bias.float().reshape(1, c, 1))
    if time_mask is not None:
        out = out.mul_(time_mask.float().reshape(b, 1, t))
    return out.to(x.dtype)


def linear(
    x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor | None
) -> torch.Tensor:
    """Dense layer with the kernel stored [in, out] (the JAX layout). The
    product is taken in the input dtype (f32 accumulation inside the GEMM),
    then the bias is added in that dtype, as `jnp.dot(...) + bias` does."""
    out = torch.matmul(x, kernel.to(x.dtype))
    if bias is not None:
        out = out + bias.to(x.dtype)
    return out


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
