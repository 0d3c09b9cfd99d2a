"""Norm + GELU (K6): the bf16 and f16 forward's normalization and erf-GELU
chains of `models.layers`, each in one pass of a hand-written kernel
(`csrc/norm_gelu.cu`).

`norm_gelu(x, norm, weight, bias, eps, lens)` is the GELU of x after `norm`:
- None: `layers.gelu(x)`, x of any shape;
- "group": `layers.group_norm_1d` with groups = channels over x [B, C, T],
  its statistics over the first lens[b] frames of each row (every frame
  where lens is None) and the frames past them 0, as the conv frontend's
  layer 0 of wav2vec2-base;
- "channel": `layers.layer_norm_channels` over x [B, C, T] (C up to
  `MAX_CHANNELS`), as after every conv of the layer-norm frontends.

It is the port's one choice between K6 and the plain version `reference`
(`layers.gelu` of `layers`' norm, ATen operations only):
- a CPU tensor, or an f32 one (the f32 forward's exact-erf GELU and f32
  norms), runs `reference`;
- a bf16 or f16 tensor off the CPU launches K6 or raises (on a device
  without the kernel, or on arguments it does not take): nothing falls
  back. Where autograd records the step (grad mode on and an operand
  requiring grad: the train step) the norm is `layers`' out-of-place code
  and the GELU K6's, with `layers.GeluAS`'s backward. A DTensor (the mesh
  encoder's FFN) launches on its local tensor and comes back at the same
  placements.

K6's GELU equals `layers.gelu_as` on the card bit for bit; its norms agree
with `layers`' to 1 bf16 ulp (their statistics are summed in another
order), so on the card a forward with grad on and one with grad off agree
to that ulp in the frontend.

`launches` counts the launches of each mode, and each launch adds the
elements it wrote to the count `elems_fused` of the innermost span open on
its thread (`utils.spans`). The kernel is built with the port's other
kernels by `ops.cuda_build`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..models.layers import GeluAS, gelu, group_norm_1d, layer_norm_channels, wants_grad
from ..utils import spans
from .cuda_build import library

MODES = (None, "group", "channel")
MAX_CHANNELS = 1024  # csrc/norm_gelu.cu's kMaxChannels: a [C, 32-frame] slab in shared memory
# dtype -> the launchers' `half` flag
_HALF = {torch.bfloat16: 0, torch.float16: 1}
# per mode (None is "gelu")
launches = {"gelu": 0, "group": 0, "channel": 0}


@functools.cache
def _library() -> ctypes.CDLL:
    lib = library()
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.norm_gelu_gelu_launch.argtypes = [p, p, ctypes.c_longlong, i, p]
    lib.norm_gelu_group_launch.argtypes = [p, p, p, p, p, i, i, i, f, i, p]
    lib.norm_gelu_channel_launch.argtypes = [p, p, p, p, i, i, i, f, i, p]
    for fn in (lib.norm_gelu_gelu_launch, lib.norm_gelu_group_launch,
               lib.norm_gelu_channel_launch):
        fn.restype = ctypes.c_int
    return lib


def time_mask(lens: torch.Tensor | None, t_len: int) -> torch.Tensor | None:
    """[B, T] True on the first lens[b] frames of each row (None for None)."""
    if lens is None:
        return None
    return torch.arange(t_len, device=lens.device)[None, :] < lens[:, None]


def _norm(x, norm, weight, bias, eps, lens):
    """`layers`' norm of x (x itself for None)."""
    if norm == "group":
        return group_norm_1d(x, weight, bias, num_groups=x.shape[1], eps=eps,
                             time_mask=time_mask(lens, x.shape[2]))
    if norm == "channel":
        return layer_norm_channels(x, weight, bias, eps)
    if norm is not None:
        raise ValueError(f"norm must be one of {MODES}, got {norm!r}")
    return x


def reference(x: torch.Tensor, norm: str | None = None, weight: torch.Tensor | None = None,
              bias: torch.Tensor | None = None, eps: float = 1e-5,
              lens: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version of `norm_gelu`: `layers.gelu` of `layers`' norm,
    ATen operations only, on the card as on the CPU."""
    return gelu(_norm(x, norm, weight, bias, eps, lens))


def check_args(x: torch.Tensor, norm: str | None, weight: torch.Tensor | None = None,
               bias: torch.Tensor | None = None, lens: torch.Tensor | None = None) -> None:
    """Raise ValueError on what K6 does not take: a mode outside `MODES`, a
    dtype other than bf16/f16; for a norm, x not [B, C, T], a weight or
    bias not [C] on x's device, the channel mode past `MAX_CHANNELS`, lens
    not [B] integers on x's device or given to another mode."""
    if norm not in MODES:
        raise ValueError(f"norm must be one of {MODES}, got {norm!r}")
    if x.dtype not in _HALF:
        raise ValueError(f"K6 takes bfloat16 or float16 tensors, got {x.dtype}")
    if lens is not None and norm != "group":
        raise ValueError("lens is the group mode's frame counts")
    if norm is None:
        return
    if x.dim() != 3:
        raise ValueError(f"the {norm} mode takes x [B, C, T], got shape {tuple(x.shape)}")
    b, c, _ = x.shape
    for name, p in (("weight", weight), ("bias", bias)):
        if p is None or tuple(p.shape) != (c,) or p.device != x.device:
            raise ValueError(f"{name} must be a [{c}] tensor on {x.device}")
    if norm == "channel" and c > MAX_CHANNELS:
        raise ValueError(f"the channel mode takes C up to {MAX_CHANNELS}, got {c}")
    if lens is not None and (tuple(lens.shape) != (b,) or lens.device != x.device
                             or lens.dtype.is_floating_point or lens.dtype.is_complex):
        raise ValueError(f"lens must be [{b}] integers on {x.device}")


def _launch(x, norm, weight, bias, eps, lens) -> torch.Tensor:
    """One launch on the current stream, after `check_args`."""
    check_args(x, norm, weight, bias, lens)
    if x.device.type != "cuda":
        raise ValueError(f"no K6 kernel for device {x.device}")
    x = x.contiguous()
    out = torch.empty_like(x)
    half = _HALF[x.dtype]
    lib = _library()
    mode = norm or "gelu"
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if norm is None:
            err = lib.norm_gelu_gelu_launch(x.data_ptr(), out.data_ptr(), x.numel(), half,
                                            stream)
        else:
            w, b = weight.float().contiguous(), bias.float().contiguous()
            batch, c, t = x.shape
            if norm == "group":
                lens = None if lens is None else lens.to(torch.int64).contiguous()
                err = lib.norm_gelu_group_launch(
                    x.data_ptr(), w.data_ptr(), b.data_ptr(),
                    None if lens is None else lens.data_ptr(), out.data_ptr(), batch, c, t,
                    float(eps), half, stream)
            else:
                err = lib.norm_gelu_channel_launch(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                                                   out.data_ptr(), batch, c, t, float(eps),
                                                   half, stream)
    if err != 0:
        raise RuntimeError(f"norm_gelu ({mode}) launch failed: cudaError {err}")
    launches[mode] += 1
    spans.tally(elems_fused=out.numel())
    return out


class _KernelGelu(GeluAS):
    """K6's GELU with `GeluAS`'s backward: the train step's GELU on the card
    (its forward runs with grad off, so `norm_gelu` launches there)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return norm_gelu(x)


def norm_gelu(x: torch.Tensor, norm: str | None = None, weight: torch.Tensor | None = None,
              bias: torch.Tensor | None = None, eps: float = 1e-5,
              lens: torch.Tensor | None = None) -> torch.Tensor:
    """gelu(norm(x)) in x's dtype: K6 for a bf16 or f16 tensor off the CPU,
    `reference` otherwise (see the module's docstring)."""
    if x.device.type == "cpu" or x.dtype not in _HALF:
        return reference(x, norm, weight, bias, eps, lens)
    if wants_grad(x, *(() if norm is None else (weight, bias))):
        return _KernelGelu.apply(_norm(x, norm, weight, bias, eps, lens))
    if getattr(x, "placements", None) is not None:  # a DTensor
        if norm is not None:
            raise ValueError("K6 takes a DTensor in the GELU mode only")
        from torch.distributed.tensor import DTensor

        local = norm_gelu(x.to_local())
        return DTensor.from_local(local, x.device_mesh, x.placements, run_check=False,
                                  shape=x.shape,
                                  stride=torch.empty(x.shape, device="meta").stride())
    return _launch(x, norm, weight, bias, eps, lens)
