"""Embedded ONNX session: the exported graph run as torch operations on a
torch device, with onnxruntime's InferenceSession surface.

Counterpart of `wav2vec2_tpu.onnx.reference_runtime`. The JAX package runs
exported graphs under onnxruntime where it is installed and under a numpy
evaluator elsewhere; onnxruntime's CUDA provider is its card runtime. The
card's machine has no onnxruntime, and a numpy evaluator would run
`--runtime onnx --device cuda` on the CPU. So the port's session executes
the same op set (`SUPPORTED_OPS`) as torch operations on the device the
caller names, the card by default, and never moves the forward elsewhere.

Where the values live:
- float activations and float initializers stay on the device;
- integer tensors (the int64 shape machinery: `Shape`, `Gather`,
  `Concat`, `Range`, and the operands of `Reshape`, `Slice`, `Unsqueeze`)
  stay on the host, so a `Reshape` never waits on the card. A binary op
  that meets a host tensor and a device tensor moves the host one over.

`MatMul`, `Gemm` and `Conv` run in full f32: a run holds
`models.layers.full_f32_precision` (TF32 off for matmuls and cuDNN
convolutions). `Conv` takes ONNX's `[begin, end]` pads, padding explicitly
where the two differ. Outputs come back as host numpy arrays, as
onnxruntime returns them.

Scope: the primitive-op subset `onnx/export.py` emits, plus the dynamic-
shape ops torch.onnx commonly emits for the same graphs. Single-threaded
topological execution; no shape inference.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ..errors import RuntimeBackendError
from ..models.layers import full_f32_precision
from . import proto
from .proto import Model, Node, load_model

# numpy dtype of an ONNX tensor type (proto._ONNX_TO_NP) -> torch dtype
_TORCH_DTYPES = {
    np.dtype(np.float32): torch.float32, np.dtype(np.float16): torch.float16,
    np.dtype(np.float64): torch.float64, np.dtype(np.int64): torch.int64,
    np.dtype(np.int32): torch.int32, np.dtype(np.int16): torch.int16,
    np.dtype(np.int8): torch.int8, np.dtype(np.uint8): torch.uint8,
    np.dtype(np.bool_): torch.bool,
}


@dataclass
class _IoSpec:
    name: str


def _ints(t: torch.Tensor | None) -> list[int] | None:
    """A host int tensor (or an attribute list) as Python ints."""
    if t is None:
        return None
    if isinstance(t, torch.Tensor):
        return [int(v) for v in t.reshape(-1).tolist()]
    return [int(v) for v in np.atleast_1d(t)]


def _conv(x, w, b, strides, pads, group: int) -> torch.Tensor:
    """1-D grouped Conv, NCL layout, ONNX pads [begin, end]."""
    if x.ndim != 3:
        raise NotImplementedError("embedded ONNX Conv supports 1-D only")
    stride = int(strides[0]) if strides else 1
    lo, hi = (int(pads[0]), int(pads[1])) if pads else (0, 0)
    padding = lo
    if lo != hi:
        x = F.pad(x, (lo, hi))
        padding = 0
    out_len = (x.shape[2] + 2 * padding - w.shape[2]) // stride + 1
    if out_len <= 0:
        raise ValueError(f"Conv output length {out_len} <= 0")
    return F.conv1d(x, w, b, stride=stride, padding=padding, groups=group)


def _layer_norm(x, scale, bias, axis: int, eps: float) -> torch.Tensor:
    axis = axis if axis >= 0 else x.ndim + axis
    shape = tuple(x.shape[axis:])
    y = F.layer_norm(x.float(), shape, scale.float().expand(shape),
                     bias.float().expand(shape), eps)
    return y.to(x.dtype)


def _instance_norm(x, scale, bias, eps: float) -> torch.Tensor:
    y = F.instance_norm(x.float(), weight=scale.float(), bias=bias.float(), eps=eps)
    return y.to(x.dtype)


def _slice(data, starts, ends, axes, steps) -> torch.Tensor:
    starts, ends = _ints(starts), _ints(ends)
    axes = (list(range(len(starts))) if axes is None
            else [a % data.ndim for a in _ints(axes)])
    steps = [1] * len(starts) if steps is None else _ints(steps)
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        idx = range(*slice(st, en, sp).indices(data.shape[ax]))
        if sp == 1:
            data = data.narrow(ax, idx.start, len(idx))
        else:
            data = data.index_select(ax, torch.tensor(list(idx), device=data.device))
    return data


def _together(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Both operands on one device: a host tensor moves to the other's."""
    if a.device != b.device:
        if a.device.type == "cpu":
            a = a.to(b.device)
        else:
            b = b.to(a.device)
    return a, b


class EmbeddedOnnxSession:
    """onnxruntime.InferenceSession drop-in for exported wav2vec2 graphs,
    on a torch device ("cuda" by default, or "cpu").

    Implements: run(None, feeds), get_inputs(), get_outputs(),
    get_providers() (`Embedded{CUDA,CPU}ExecutionProvider`)."""

    SUPPORTED_OPS = {
        "Add", "Sub", "Mul", "Div", "MatMul", "Erf", "Sqrt", "Relu",
        "Tanh", "Pow", "Conv", "Transpose", "Reshape", "Unsqueeze",
        "Squeeze", "Slice", "Softmax", "LayerNormalization",
        "InstanceNormalization", "Identity", "Cast",
        "LogSoftmax",
        "Shape", "Gather", "Concat", "ConstantOfShape", "Expand", "Range",
        "Equal", "Where", "Gemm", "ReduceMean", "Neg", "Min", "Max",
        "Clip", "Sigmoid", "Exp", "Log",
    }

    def __init__(self, model_path: str | Path | bytes,
                 device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeBackendError(
                "onnx runtime", "CUDA device requested but none is available")
        if self.device.type not in ("cuda", "cpu"):
            raise RuntimeBackendError(
                "onnx runtime", f"unsupported device {device!r}, expected cuda or cpu")
        if isinstance(model_path, bytes):
            self._model = Model.decode(model_path)
        else:
            self._model = load_model(model_path)
        g = self._model.graph
        unsupported = sorted(
            {n.op_type for n in g.nodes} - self.SUPPORTED_OPS
        )
        if unsupported:
            raise ValueError(
                f"embedded ONNX session: unsupported ops {unsupported} "
                f"(install onnxruntime for full-op coverage)"
            )
        self._graph = g
        self._initializers = {k: self._to_torch(v)
                              for k, v in g.initializers.items()}

    def _to_torch(self, array) -> torch.Tensor:
        """An array or tensor with floats on the device and the rest on the
        host."""
        t = array if isinstance(array, torch.Tensor) else torch.from_numpy(
            np.array(array, copy=True))
        return t.to(self.device) if t.is_floating_point() else t.cpu()

    # -- ORT-compatible surface ------------------------------------------

    def get_inputs(self):
        return [_IoSpec(n) for n in self._graph.input_names
                if n not in self._graph.initializers]

    def get_outputs(self):
        return [_IoSpec(n) for n in self._graph.output_names]

    def get_providers(self):
        return [f"Embedded{self.device.type.upper()}ExecutionProvider"]

    def run(self, output_names, feeds: dict):
        values: dict[str, torch.Tensor] = dict(self._initializers)
        for k, v in feeds.items():
            values[k] = self._to_torch(v)
        with torch.inference_mode(), full_f32_precision():
            for node in self._graph.nodes:
                self._exec(node, values)
        names = output_names or self._graph.output_names
        return [values[n].cpu().numpy() for n in names]

    # -- op dispatch ------------------------------------------------------

    def _exec(self, node: Node, values: dict) -> None:
        def inp(i, default=None):
            if i >= len(node.inputs) or not node.inputs[i]:
                return default
            return values[node.inputs[i]]

        op = node.op_type
        a = inp(0)
        if op in ("Add", "Sub", "Mul", "Div", "Pow", "Equal", "Min", "Max"):
            x, y = _together(a, inp(1))
            if op == "Add":
                out = x + y
            elif op == "Sub":
                out = x - y
            elif op == "Mul":
                out = x * y
            elif op == "Div":
                out = (x / y if x.is_floating_point() or y.is_floating_point()
                       else torch.div(x, y, rounding_mode="trunc"))
            elif op == "Pow":
                out = torch.pow(x, y)
            elif op == "Equal":
                out = x == y
            elif op == "Min":
                out = torch.minimum(x, y)
            else:
                out = torch.maximum(x, y)
        elif op == "MatMul":
            out = torch.matmul(*_together(a, inp(1)))
        elif op == "Erf":
            out = torch.erf(a)
        elif op == "Sqrt":
            out = torch.sqrt(a)
        elif op == "Relu":
            out = torch.relu(a)
        elif op == "Tanh":
            out = torch.tanh(a)
        elif op == "Conv":
            out = _conv(
                a, inp(1), inp(2),
                node.attr("strides"), node.attr("pads"),
                int(node.attr("group", 1)),
            )
        elif op == "Transpose":
            perm = node.attr("perm")
            out = a.permute(*(perm if perm else range(a.ndim - 1, -1, -1)))
        elif op == "Reshape":
            shape = _ints(inp(1))
            if not int(node.attr("allowzero", 0)):
                shape = [a.shape[i] if v == 0 else v for i, v in enumerate(shape)]
            out = a.reshape(shape)
        elif op == "Unsqueeze":
            axes = inp(1)
            if axes is None:  # opset < 13 attribute form
                axes = node.attr("axes")
            out = a
            for ax in sorted(_ints(axes)):
                out = out.unsqueeze(ax)
        elif op == "Squeeze":
            axes = inp(1)
            if axes is None:
                axes = node.attr("axes")
            out = a.squeeze(tuple(_ints(axes)))
        elif op == "Slice":
            out = _slice(a, inp(1), inp(2), inp(3), inp(4))
        elif op == "Softmax":
            out = torch.softmax(a, dim=int(node.attr("axis", -1)))
        elif op == "LogSoftmax":
            out = torch.log_softmax(a, dim=int(node.attr("axis", -1)))
        elif op == "LayerNormalization":
            out = _layer_norm(a, inp(1), inp(2),
                              int(node.attr("axis", -1)),
                              float(node.attr("epsilon", 1e-5)))
        elif op == "InstanceNormalization":
            out = _instance_norm(a, inp(1), inp(2),
                                 float(node.attr("epsilon", 1e-5)))
        elif op == "Shape":
            out = torch.tensor(list(a.shape), dtype=torch.int64)
        elif op == "Gather":
            axis = int(node.attr("axis", 0)) % a.ndim
            idx = inp(1).to(a.device)
            idx = torch.where(idx < 0, idx + a.shape[axis], idx)
            out = a.index_select(axis, idx.reshape(-1)).reshape(
                a.shape[:axis] + idx.shape + a.shape[axis + 1:])
        elif op == "Concat":
            parts = [values[n] for n in node.inputs]
            if len({p.device for p in parts}) > 1:
                parts = [p.to(self.device) for p in parts]
            out = torch.cat(parts, dim=int(node.attr("axis", 0)))
        elif op == "ConstantOfShape":
            fill = node.attributes.get("value")
            if fill is not None:
                raise NotImplementedError(
                    "ConstantOfShape with tensor value attribute"
                )
            out = torch.zeros(_ints(a), dtype=torch.float32, device=self.device)
        elif op == "Expand":
            shape = torch.broadcast_shapes(a.shape, tuple(_ints(inp(1))))
            out = a.expand(shape)
        elif op == "Range":
            out = torch.arange(a.item(), inp(1).item(), inp(2).item(),
                               dtype=a.dtype, device=a.device)
        elif op == "Where":
            cond, x = _together(a, inp(1))
            cond, y = _together(cond, inp(2))
            x, y = _together(x, y)
            out = torch.where(cond, x, y)
        elif op == "Gemm":
            alpha = float(node.attr("alpha", 1.0))
            beta = float(node.attr("beta", 1.0))
            A = a.T if node.attr("transA", 0) else a
            Bm = inp(1)
            Bm = Bm.T if node.attr("transB", 0) else Bm
            out = alpha * torch.matmul(A, Bm)
            c = inp(2)
            if c is not None:
                out = out + beta * c
        elif op == "ReduceMean":
            axes = inp(1)
            if axes is None:
                axes = node.attr("axes")
            keep = bool(node.attr("keepdims", 1))
            out = (a.mean(dim=tuple(_ints(axes)), keepdim=keep) if axes is not None
                   else a.mean().reshape([1] * a.ndim if keep else []))
        elif op == "Neg":
            out = -a
        elif op == "Clip":
            lo, hi = inp(1), inp(2)
            out = torch.clamp(a, None if lo is None else lo.item(),
                              None if hi is None else hi.item())
        elif op == "Sigmoid":
            out = torch.sigmoid(a)
        elif op == "Exp":
            out = torch.exp(a)
        elif op == "Log":
            out = torch.log(a)
        elif op == "Identity":
            out = a
        elif op == "Cast":
            to = int(node.attr("to", proto.FLOAT))
            np_dtype = proto._ONNX_TO_NP.get(to)
            if np_dtype is None or np.dtype(np_dtype) not in _TORCH_DTYPES:
                raise NotImplementedError(f"Cast to ONNX dtype {to}")
            out = a.to(_TORCH_DTYPES[np.dtype(np_dtype)])
        else:  # pragma: no cover — guarded in __init__
            raise NotImplementedError(op)
        values[node.outputs[0]] = out
