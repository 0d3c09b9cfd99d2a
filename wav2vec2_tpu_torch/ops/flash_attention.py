"""Fused attention with the Transformer-XL relative-position term: K5.

Counterpart of `wav2vec2_tpu.ops.flash_attention`. `flash_attention` pads
T to `pad_len(T)` (padded keys masked with −inf, padded query rows sliced
off on return), then, for CUDA tensors, launches a hand-written kernel of
`csrc/flash_attention.cu` (the port of `_attn_kernel`) or raises; for CPU
tensors it runs the plain version `ops.flash_attention_ref.attention`.
There is no fallback from the kernel to the plain version. K5 has no
backward, so `flash_attention` raises where autograd would record it (grad
mode on and an input requiring grad), on either device. The kernel
follows the dtype (`kernel_for`); both are fed by a TMA ring (one producer
thread, full and empty mbarriers, consumers at 240 registers by
`setmaxnreg`) and cut a row into column chunks, so no head dim that a
preset uses is zero-filled:
- bf16 runs on the tensor cores (`flash_attention_wgmma_kernel`: wgmma,
  bf16 operands, f32 accumulation, as the TPU's bf16 path; head dims 16,
  32, 64, 80 and 128);
- f32 runs as exact FMAs on the CUDA cores (`flash_attention_f32_kernel`,
  launched as "fma": the TPU's Precision.HIGHEST path of the f32 forwards,
  which the single-utterance runtime, long-form, online and the CLI use
  by default). Its bound is the 6·T_pad²·hd operations at 67 TFLOP/s. A
  consumer thread owns 4 x 8 scores (rows and keys 8 apart), reads its
  operands 16 bytes along d a load and keeps scores, p and O in registers
  (softmax and P·V across the eight lanes of a row by shuffles); the R
  window is a ring that takes only BK new rows a key tile. Head dims
  1..128 by the widths 16, 32, 64, 80, 96 and 128 (`f32_tiles`): hd 64 is
  32 + 32 columns, 80 is 32 + 32 + 16; another head dim runs the next
  width with TMA's zeros past hd, and one that is not a multiple of 4 is
  padded to one here (TMA's row stride is a multiple of 16 bytes).
`launches["k5"]` counts the launches of both, `kernel_launches` each.

The relative table is `rel_table_rev`: R_rev[h, m] = (pe_{T_pad−m} ·
W_pos)[h·hd : (h+1)·hd] for m ∈ [0, 2·T_pad), over the Transformer-XL
sinusoid `_pe_table` built on the host in f64. Its [2·T_pad, H] × [H, H]
product is a plain matmul in the compute dtype (outside the kernel, as in
the JAX package), with TF32 off.

Dispatch (`use_flash`): the JAX rule — the rel-pos style, or any style
under WAV2VEC2_FLASH_FORCE=1 — with the head_dim ≤ 128 cap. The TPU's
VMEM byte budget becomes the kernel's own shared-memory check (`fits`;
`check_fits` raises before a launch), which does not depend on T: the
kernel streams key tiles.

Under a device mesh (`spmd_mesh`, or inputs that are DTensors) the launch
runs inside `local_map`, the counterpart of the JAX launch inside
`jax.shard_map`: q, k, v and q_pos at (Shard(0), Shard(1)) (batch over
'data', heads over 'model'), rel_r at Shard(0) over 'model' (heads come
first), the mask rows over 'data'; the output at (Shard(0), Shard(1)). Each
rank's kernel sees only its [B/dp, NH/tp, T_pad, hd] tile and no
collective runs. A batch or head count the mesh does not divide raises the
JAX package's ValueError.

The kernel is built with the port's other kernels by `ops.cuda_build`.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os

import numpy as np
import torch
import torch.nn.functional as F

from ..models.layers import full_f32_precision
from . import flash_attention_ref
from .cuda_build import MAX_SMEM_BYTES, library

BLOCK_Q = 256  # T is padded to a multiple of this, as in the JAX package
HEAD_DIM_CAP = 128
FORCE_ENV = "WAV2VEC2_FLASH_FORCE"
# the f32 kernel's widths (csrc/flash_attention.cu, f32_k5): a head dim runs
# the first that holds it
F32_WIDTHS = (16, 32, 64, 80, 96, HEAD_DIM_CAP)
# the wgmma kernel's: 128 query rows (two consumer warpgroups of 64), a
# two-stage ring of key tiles, the head dims it serves
WGMMA_BQ = 128
WGMMA_STAGES = 2
WGMMA_HEAD_DIMS = (16, 32, 64, 80, 128)
TMA_ALIGN = 16  # bytes: TMA's and the bulk copy's base alignment
_ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2}
# dtype -> kernel: "wgmma" on the tensor cores, "fma" (exact f32 FMAs) on the
# CUDA cores
_KERNELS = {torch.bfloat16: "wgmma", torch.float32: "fma"}
launches = {"k5": 0}
# the same launches by kernel (`kernel_for`)
kernel_launches = {kernel: 0 for kernel in _KERNELS.values()}


def pad_len(t: int) -> int:
    return -(-max(t, BLOCK_Q) // BLOCK_Q) * BLOCK_Q


@functools.lru_cache(maxsize=8)
def _pe_table(t_pad: int, h: int) -> np.ndarray:
    """[2·T_pad, H] f32 sinusoid for distances d = T_pad − m, computed in
    f64 (an f32 sin at |angle| ≈ T would cost ~3e-4 absolute)."""
    d_vec = (t_pad - np.arange(2 * t_pad, dtype=np.float64))[:, None]
    inv = np.exp(np.arange(0, h, 2, dtype=np.float64)
                 * (-math.log(10000.0) / h))
    ang = d_vec * inv[None, :]  # [2·T_pad, H/2]
    return np.stack([np.sin(ang), np.cos(ang)], axis=-1).reshape(
        2 * t_pad, h
    ).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _pe_on(t_pad: int, h: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """`_pe_table` on `device` in `dtype`, copied there once."""
    return torch.from_numpy(_pe_table(t_pad, h)).to(device=device, dtype=dtype)


def rel_table_rev(w_pos_kernel: torch.Tensor, nh: int, t_pad: int,
                  dtype: torch.dtype) -> torch.Tensor:
    """Reversed projected relative-position table [NH, 2·T_pad, hd] in
    `dtype`. w_pos_kernel: [H (pe component), H (nh·hd)], the [in, out]
    kernel of linear_pos. Row m holds distance T_pad − m."""
    h = w_pos_kernel.shape[0]
    pe = _pe_on(t_pad, h, w_pos_kernel.device, dtype)
    with full_f32_precision():
        r = torch.matmul(pe, w_pos_kernel.to(dtype))
    return r.reshape(2 * t_pad, nh, h // nh).transpose(0, 1).contiguous()


def flash_forced() -> bool:
    """WAV2VEC2_FLASH_FORCE=1 forces the kernel for every attention style
    (A/B measurement); never set in production."""
    return os.environ.get(FORCE_ENV, "") == "1"


def _template_width(head_dim: int) -> int:
    """The f32 kernel's width that serves `head_dim` (0 if none does)."""
    return next((w for w in F32_WIDTHS if 1 <= head_dim <= w), 0)


def f32_tiles(head_dim: int, rel: bool) -> tuple[int, int, int]:
    """(query rows a block, keys a tile, rows of the R ring) of the f32
    kernel at `head_dim`'s width: a consumer thread owns 4 x 8 scores of
    128 x 64; with rel 4 x 4 (64 keys) past width 64 and 2 x 4 (64 rows)
    past width 80, where q, q_pos, two stages of K and V and the ring would
    not fit. The ring holds a tile's BQ + BK − 1 window rows and one tile
    ahead, rounded up to a power of 2."""
    width = _template_width(head_dim)
    tr = 2 if rel and width > 80 else 4
    tk = 4 if rel and width > 64 else 8
    bq, bk = 32 * tr, 8 * tk
    return bq, bk, 1 << (bq + 2 * bk - 1).bit_length()


def wgmma_key_tile(head_dim: int, rel: bool) -> int:
    """Keys a stage of the wgmma kernel's ring holds: 128 for plain
    attention; with the R window 64 (at 128 the score, position and output
    accumulators would spill), 32 at head dim 128 (two stages would not
    fit)."""
    if not rel:
        return 128
    return 64 if head_dim <= 80 else 32


def kernel_for(dtype: torch.dtype) -> str | None:
    """The kernel a CUDA tensor of `dtype` launches: "wgmma" (bf16, tensor
    cores), "fma" (f32, exact FMAs on the CUDA cores), or None (no kernel
    takes the dtype)."""
    return _KERNELS.get(dtype)


def smem_bytes(head_dim: int, dtype: torch.dtype, rel: bool) -> int:
    """Shared memory one block of `kernel_for(dtype)` needs:
    `flash_attention_smem_bytes` of the CUDA source (chip_smoke.py holds the
    two equal); 0 if the kernel does not serve `head_dim`, or no kernel
    takes the dtype."""
    kernel = kernel_for(dtype)
    if kernel == "wgmma":
        if head_dim not in WGMMA_HEAD_DIMS:
            return 0
        # bf16 rows of hd columns, nothing past hd: q[, q_pos], then per
        # stage K, V[, an R window of 128 + BK rows]; with rel, one
        # [16, BK + 8] f32 shear slab for each of the 8 consumer warps; the
        # stages' f32 key masks; 2·stages + 1 mbarriers; 1 KiB to align the
        # base for the 128-byte swizzle
        bk, row = wgmma_key_tile(head_dim, rel), 2 * head_dim
        tiles = (WGMMA_BQ * (2 if rel else 1)
                 + WGMMA_STAGES * (2 * bk + (WGMMA_BQ + bk if rel else 0))) * row
        slab = 8 * 16 * (bk + 8) * 4 if rel else 0
        return tiles + slab + WGMMA_STAGES * bk * 4 + (2 * WGMMA_STAGES + 1) * 8 + 1024
    width = _template_width(head_dim)
    if kernel != "fma" or not width:
        return 0
    # f32 rows of `width` columns (chunks of 32 and 16, no padding): q[,
    # q_pos], two stages of K and V[, the R ring]; the stages' f32 key
    # masks; 5 mbarriers; 1 KiB to align the base for the 128-byte swizzle
    bq, bk, ring = f32_tiles(head_dim, rel)
    row = 4 * width
    tiles = (bq * (2 if rel else 1) + 2 * 2 * bk + (ring if rel else 0)) * row
    return tiles + 2 * bk * 4 + 5 * 8 + 1024


def library_smem_bytes(head_dim: int, dtype: torch.dtype, rel: bool) -> int:
    """`smem_bytes` as the compiled kernel computes it."""
    return _library().flash_attention_smem_bytes(head_dim, _ELEM_BYTES.get(dtype, 0),
                                                 int(rel))


def fits(head_dim: int, dtype: torch.dtype, rel: bool) -> bool:
    need = smem_bytes(head_dim, dtype, rel)
    return 0 < need <= MAX_SMEM_BYTES


def check_fits(head_dim: int, dtype: torch.dtype, rel: bool) -> None:
    """Raise ValueError where the kernel would be refused: a head_dim the
    dtype's kernel does not serve (f32: 1..128; bf16: 16, 32, 64, 80, 128),
    a dtype other than f32/bf16, or more shared memory than a block can
    have."""
    if not fits(head_dim, dtype, rel):
        raise ValueError(
            f"the K5 kernel takes head_dim 1..{HEAD_DIM_CAP} in float32 or "
            f"{'/'.join(map(str, WGMMA_HEAD_DIMS))} in bfloat16 within {MAX_SMEM_BYTES} B "
            f"of shared memory per block; got head_dim={head_dim}, {dtype}, rel={rel} "
            f"({smem_bytes(head_dim, dtype, rel)} B)"
        )


def check_tma_aligned(**tensors: torch.Tensor | None) -> None:
    """Raise ValueError unless every tensor given starts on TMA's 16-byte
    alignment (both kernels' maps and mask copy; their row strides, hd·2
    bytes at a bf16 head dim, hd·4 at an f32 one padded to a multiple of 4,
    always are)."""
    for name, x in tensors.items():
        if x is not None and x.data_ptr() % TMA_ALIGN:
            raise ValueError(f"{name} starts at {x.data_ptr():#x}, not on the "
                             f"{TMA_ALIGN}-byte alignment the K5 kernel's TMA loads need")


def use_flash(head_dim: int, rel: bool = False,
              dtype: torch.dtype = torch.bfloat16) -> bool:
    """The JAX dispatch rule on this card: rel-pos attention, or any style
    when forced; head_dim within the cap and the kernel's shared memory."""
    return fits(head_dim, dtype, rel) and (rel or flash_forced())


@functools.cache
def _library() -> ctypes.CDLL:
    lib = library()
    for kernel in _KERNELS.values():
        launch = getattr(lib, f"flash_attention_{kernel}_launch")
        launch.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p])
        launch.restype = ctypes.c_int
    lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.flash_attention_smem_bytes.restype = ctypes.c_size_t
    return lib


def _launch(q, k, v, mask, q_pos, rel_r, scale: float) -> torch.Tensor:
    """One launch on the current stream over padded, contiguous inputs."""
    b, nh, t_pad, hd = q.shape
    rel = rel_r is not None
    named = {"q": q, "k": k, "v": v, "q_pos": q_pos, "rel_r": rel_r}
    for name, x in named.items():
        if x is None:
            continue
        if x.device != q.device or x.dtype != q.dtype or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {q.dtype} tensor on {q.device}")
        if name != "rel_r" and x.shape != q.shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, q {tuple(q.shape)}")
    if mask is not None and (mask.dtype != torch.float32 or mask.shape != (b, t_pad)
                             or mask.device != q.device or not mask.is_contiguous()):
        raise ValueError(f"mask must be a contiguous float32 [{b}, {t_pad}] tensor "
                         f"on {q.device}")
    check_fits(hd, q.dtype, rel)
    kernel = kernel_for(q.dtype)
    if kernel == "fma" and hd % 4:
        # TMA's rows are a multiple of 16 bytes: zero columns up to one
        pad = (0, -hd % 4)
        out = _launch(F.pad(q, pad), F.pad(k, pad), F.pad(v, pad), mask,
                      None if q_pos is None else F.pad(q_pos, pad),
                      None if rel_r is None else F.pad(rel_r, pad), scale)
        return out[..., :hd].contiguous()
    out = torch.empty_like(q)
    check_tma_aligned(q=q, k=k, v=v, q_pos=q_pos, rel_r=rel_r, mask=mask, out=out)
    lib = _library()

    def ptr(x):
        return None if x is None else x.data_ptr()

    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, f"flash_attention_{kernel}_launch")(
            q.data_ptr(), ptr(q_pos), k.data_ptr(), v.data_ptr(), ptr(rel_r), ptr(mask),
            out.data_ptr(), b, nh, t_pad, hd, float(scale), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_{kernel} launch failed: cudaError {err}")
    launches["k5"] += 1
    kernel_launches[kernel] += 1
    return out


def pad_inputs(q, k, v, mask_bias, q_pos, rel_r):
    """What `flash_attention` hands the kernel or its plain version: q, k, v
    (and q_pos) padded with zeros to T_pad = pad_len(T), and the f32 key
    mask padded with −inf (None when there is no mask and no padding).
    Checks that q_pos and rel_r come together and rel_r's shape."""
    b, nh, t, hd = q.shape
    rel = rel_r is not None
    if (q_pos is None) == rel:
        raise ValueError("pass q_pos and rel_r together, or neither")
    t_pad = pad_len(t)
    if rel and tuple(rel_r.shape) != (nh, 2 * t_pad, hd):
        raise ValueError(f"rel_r has shape {tuple(rel_r.shape)}, want "
                         f"{(nh, 2 * t_pad, hd)} (built at pad_len(T) = {t_pad})")
    mask = None if mask_bias is None else mask_bias.float()
    if t_pad != t:
        pad = (0, 0, 0, t_pad - t)
        q, k, v = F.pad(q, pad), F.pad(k, pad), F.pad(v, pad)
        if rel:
            q_pos = F.pad(q_pos, pad)
        valid = (torch.zeros((b, t), dtype=torch.float32, device=q.device)
                 if mask is None else mask)
        mask = F.pad(valid, (0, t_pad - t), value=float("-inf"))
    return q, k, v, mask, q_pos


def _flash_attention_spmd(mesh, q, k, v, mask_bias, q_pos, rel_r, scale):
    """`flash_attention` on each rank's (batch, heads) tile under `mesh`."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from ..parallel.mesh import batch_sharding

    b, nh = q.shape[:2]
    dp, tp = mesh.size(0), mesh.size(1)
    if mesh.size() > 1 and (b % dp or nh % tp):
        raise ValueError(
            f"flash_attention under mesh: batch {b} must divide over "
            f"'data'={dp} and heads {nh} over 'model'={tp} — disable "
            "use_flash_attention for this (mesh, model) combination"
        )
    rows = batch_sharding(mesh)
    tile = (rows[0], Shard(1))
    specs = {"q": tile, "k": tile, "v": tile, "mask": rows,
             "q_pos": tile, "rel_r": (Replicate(), Shard(0))}
    args = {"q": q, "k": k, "v": v, "mask": mask_bias, "q_pos": q_pos, "rel_r": rel_r}
    args = {name: x for name, x in args.items() if x is not None}

    def local(*xs):
        named = dict(zip(args, xs))
        return flash_attention(named["q"], named["k"], named["v"], named.get("mask"),
                               q_pos=named.get("q_pos"), rel_r=named.get("rel_r"),
                               scale=scale)

    return local_map(local, out_placements=(tile,), device_mesh=mesh,
                     in_placements=tuple(specs[name] for name in args),
                     redistribute_inputs=True)(*args.values())


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask_bias: torch.Tensor | None = None,
    *,
    q_pos: torch.Tensor | None = None,
    rel_r: torch.Tensor | None = None,
    scale: float = 1.0,
    spmd_mesh=None,
) -> torch.Tensor:
    """Fused attention. q, k, v: [B, NH, T, hd]; `scale` multiplies the
    summed scores before the mask (the conformer's (ac + bd)/sqrt(hd) op
    order). mask_bias: [B, T] additive f32 key mask (0 / −inf). For the
    Transformer-XL term pass q_pos (q + pos_bias_v, shaped as q) and rel_r
    from `rel_table_rev` at T_pad = pad_len(T). Returns [B, NH, T, hd] in
    q.dtype. `spmd_mesh` (or DTensor inputs) launches per shard."""
    mesh = spmd_mesh if spmd_mesh is not None else getattr(q, "device_mesh", None)
    if mesh is not None:
        return _flash_attention_spmd(mesh, q, k, v, mask_bias, q_pos, rel_r, scale)
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad for x in (q, k, v, mask_bias, q_pos, rel_r)):
        # the kernel writes its output through a raw pointer, so a gradient
        # through it would be lost without a word; neither package has a
        # backward kernel, and the train step runs attention without it
        raise RuntimeError("flash_attention (K5) has no backward: call it under "
                           "torch.no_grad() or with inputs that do not require grad")
    t = q.shape[2]
    q, k, v, mask, q_pos = pad_inputs(q, k, v, mask_bias, q_pos, rel_r)
    if q.device.type == "cpu":
        out = flash_attention_ref.attention(q, k, v, mask, q_pos=q_pos, rel_r=rel_r,
                                            scale=scale)
    elif q.device.type == "cuda":
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        q_pos = None if q_pos is None else q_pos.contiguous()
        out = _launch(q, k, v, None if mask is None else mask.contiguous(), q_pos,
                      rel_r, scale)
    else:
        raise ValueError(f"no attention kernel for device {q.device}")
    return out[:, :, :t] if out.shape[2] != t else out
