"""Int8 serving mode for the encoder's projection matmuls (counterpart of
`wav2vec2_tpu.models.quantize`).

- `quantize_encoder_int8(params)`: offline per-output-channel symmetric
  quantization of the stacked encoder layers' six projections (q/k/v/out
  and the FFN pair). A projection becomes {kernel_q: int8 [.., in, out],
  scale: f32 [.., out], bias}; everything else is the same tensor as
  before. Like the JAX function it knows the wav2vec2 encoder's layer keys
  (`attention`, `feed_forward`) only: it takes the wav2vec2-encoder
  families and SEW, and refuses the conformers, w2v-BERT and SEW-D (here
  with an InvalidInputError naming the family).
- `linear_maybe_quantized(x, p)`: the encoder's dispatch. An int8 entry
  runs `linear_int8`: dynamic per-row symmetric activation quantization
  (abs-max → int8), an int8 × int8 → int32 product, and the dequantize
  epilogue, in the JAX function's order of operations. Otherwise the plain
  `layers.linear`.

The int32 product is a plain matrix product that the JAX package leaves
to XLA (`lax.dot_general`), so here it is one library call,
`torch._int_mm` (cuBLASLt's int8 GEMM on the card), with the operands
zero-padded to the card's shape rules where they fall short; zero rows and
columns add nothing to an integer sum, so the product stays exact. There
is no f32 stand-in: without `_int_mm` the mode raises.

It is an opt-in serving mode (`BatchAligner(quantize_int8=True)`, `serve
--quantize-int8`): the rest of the graph stays bf16, and the int8 forward
is held to the JAX package's own bound against the bf16 one.
"""

from __future__ import annotations

import torch

from ..errors import InvalidInputError
from .layers import linear

# projections quantized inside each encoder layer
_LAYER_PROJ_KEYS = (
    ("attention", "q_proj"),
    ("attention", "k_proj"),
    ("attention", "v_proj"),
    ("attention", "out_proj"),
    ("feed_forward", "intermediate_dense"),
    ("feed_forward", "output_dense"),
)
# cuBLASLt's int8 GEMM behind torch._int_mm on the card: more than 16 rows,
# inner and output widths multiples of 8
_INT_MM_MIN_ROWS = 17
_INT_MM_MULTIPLE = 8


def _div127(amax: torch.Tensor) -> torch.Tensor:
    """amax / 127 as an IEEE division on every device: PyTorch's CUDA
    division by a Python scalar multiplies by the scalar's reciprocal,
    which can differ from the quotient in the last bit (and so move a
    scale, and every int8 value rounded against it, off the JAX
    package's)."""
    return amax / torch.full((), 127.0, dtype=amax.dtype, device=amax.device)


def quantize_linear_int8(p: dict) -> dict:
    """{kernel: f32/bf16 [.., in, out], bias} → {kernel_q, scale, bias}.

    Per-output-channel symmetric: scale[o] = max(amax(|W[:, o]|) / 127,
    1e-12) in f32, kernel_q = round(W / scale) (half to even) clipped to
    [-127, 127]. Works on stacked kernels ([L, in, out]): the reduction is
    over the `in` axis only."""
    w = p["kernel"].float()
    amax = torch.amax(torch.abs(w), dim=-2, keepdim=True)  # [.., 1, out]
    scale = torch.clamp(_div127(amax), min=1e-12)
    kernel_q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    out = {"kernel_q": kernel_q, "scale": scale.squeeze(-2)}
    if "bias" in p:
        out["bias"] = p["bias"]
    return out


def _family(layers: dict) -> str:
    if "self_attn" in layers:
        bert = "depthwise_layer_norm" in layers.get("conv_module", {})
        return "w2v-BERT conformer" if bert else "wav2vec2-conformer"
    if "query_proj" in layers.get("attention", {}):
        return "SEW-D (DeBERTa)"
    return "unknown"


def quantize_encoder_int8(params: dict) -> dict:
    """A new parameter tree with the encoder layers' projections quantized
    to int8 (every other entry is the same tensor). Raises
    InvalidInputError for an encoder whose layers are not the wav2vec2
    encoder's."""
    params = dict(params)
    enc = dict(params["encoder"])
    layers = {k: dict(v) if isinstance(v, dict) else v
              for k, v in enc["layers"].items()}
    missing = [f"{g}.{n}" for g, n in _LAYER_PROJ_KEYS
               if not isinstance(layers.get(g), dict) or n not in layers[g]]
    if missing:
        raise InvalidInputError(
            f"int8 serving quantizes the wav2vec2 encoder's layer projections; the "
            f"{_family(layers)} encoder has no {', '.join(missing)}"
        )
    for group, name in _LAYER_PROJ_KEYS:
        layers[group] = dict(layers[group])
        layers[group][name] = quantize_linear_int8(layers[group][name])
    enc["layers"] = layers
    params["encoder"] = enc
    return params


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] int8 · b [K, N] int8 → [M, N] int32, exact, through
    `torch._int_mm`; on the card the operands are zero-padded to more than
    16 rows and to widths that are multiples of 8 where they fall short."""
    if not hasattr(torch, "_int_mm"):
        raise RuntimeError("this PyTorch has no torch._int_mm: int8 serving needs it")
    m, k = a.shape
    n = b.shape[1]
    if not _on_card(a):
        return torch._int_mm(a.contiguous(), b.contiguous())
    m_pad = max(m, _INT_MM_MIN_ROWS)
    k_pad, n_pad = _round_up(k, _INT_MM_MULTIPLE), _round_up(n, _INT_MM_MULTIPLE)
    if (m_pad, k_pad) != (m, k):
        a = torch.nn.functional.pad(a, (0, k_pad - k, 0, m_pad - m))
    if (k_pad, n_pad) != (k, n):
        b = torch.nn.functional.pad(b, (0, n_pad - n, 0, k_pad - k))
    out = torch._int_mm(a.contiguous(), b.contiguous())
    return out[:m, :n] if (m_pad, n_pad) != (m, n) else out


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric quantization of x [..., in]: (xq int8, xscale f32
    [..., 1]) with xscale = max(amax(|x|) / 127, 1e-12), in f32."""
    xf = x.float()
    amax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)  # [..., 1]
    xscale = torch.clamp(_div127(amax), min=1e-12)
    return torch.clamp(torch.round(xf / xscale), -127, 127).to(torch.int8), xscale


def linear_int8(x: torch.Tensor, kernel_q: torch.Tensor, scale: torch.Tensor,
                bias: torch.Tensor | None) -> torch.Tensor:
    """Dynamic-activation int8 linear: per-row abs-max quantization of x,
    int8 × int8 → int32, f32 dequant epilogue, output in x.dtype.

    x: [..., in]; kernel_q: [in, out] int8; scale: [out] f32."""
    out_dtype = x.dtype
    xq, xscale = quantize_rows(x)
    y32 = int8_matmul(xq.reshape(-1, xq.shape[-1]), kernel_q)
    y = y32.reshape(*x.shape[:-1], kernel_q.shape[-1]).float() * xscale * scale
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def linear_maybe_quantized(x: torch.Tensor, p: dict) -> torch.Tensor:
    """Dispatch: the int8 path when the entry carries quantized weights,
    else the plain linear."""
    if "kernel_q" in p:
        return linear_int8(x, p["kernel_q"], p["scale"], p.get("bias"))
    return linear(x, p["kernel"], p.get("bias"))
