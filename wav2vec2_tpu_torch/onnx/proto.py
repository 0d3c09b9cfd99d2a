"""Minimal ONNX protobuf wire-format codec (no `onnx` dependency).

The reference exports its acoustic model to ONNX and serves it through a
second runtime (scripts/export_ctc_model_to_onnx.py + the `ort` backend,
model_runtime.rs:198-339). This environment has neither the `onnx` package
nor `onnxruntime`, so the TPU framework carries its own self-contained
codec: a generic protobuf wire reader/writer plus typed views of the ONNX
message subset the exporter emits (ModelProto, GraphProto, NodeProto,
TensorProto, AttributeProto, ValueInfoProto). Field numbers follow the
public onnx.proto3 schema; files written here load in stock onnxruntime,
and files produced by standard exporters parse here (subset of fields).

Wire format: each field is a (field_number << 3 | wire_type) varint key
followed by a varint (type 0), 64-bit (type 1), length-delimited bytes
(type 2), or 32-bit (type 5) payload.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# -- low-level wire helpers -------------------------------------------------


def _write_varint(buf: bytearray, value: int) -> None:
    if value < 0:
        value &= (1 << 64) - 1  # two's-complement 64-bit, per proto3
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            buf.append(b | 0x80)
        else:
            buf.append(b)
            return


def _read_varint(data: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise ValueError("malformed varint")


def _signed64(value: int) -> int:
    return value - (1 << 64) if value >= (1 << 63) else value


def _ints_from(value, wire_type: int) -> list[int]:
    """Repeated scalar int field: one varint (wire type 0) or a PACKED
    length-delimited run of varints (wire type 2 — what proto3 serializers
    like onnx/torch.onnx emit for repeated int64)."""
    if wire_type == 0:
        return [_signed64(value)]
    out = []
    pos = 0
    while pos < len(value):
        v, pos = _read_varint(value, pos)
        out.append(_signed64(v))
    return out


def _floats_from(value, wire_type: int) -> list[float]:
    """Repeated float field: one fixed32 (wire type 5) or packed (2)."""
    return [float(v) for v in np.frombuffer(value, np.float32)]


def write_tag(buf: bytearray, field_num: int, wire_type: int) -> None:
    _write_varint(buf, (field_num << 3) | wire_type)


def write_len_delimited(buf: bytearray, field_num: int, payload: bytes) -> None:
    write_tag(buf, field_num, 2)
    _write_varint(buf, len(payload))
    buf.extend(payload)


def write_string(buf: bytearray, field_num: int, s: str) -> None:
    write_len_delimited(buf, field_num, s.encode("utf-8"))


def write_int(buf: bytearray, field_num: int, value: int) -> None:
    write_tag(buf, field_num, 0)
    _write_varint(buf, value)


def write_float(buf: bytearray, field_num: int, value: float) -> None:
    write_tag(buf, field_num, 5)
    buf.extend(np.float32(value).tobytes())


def iter_fields(data: bytes):
    """Yield (field_number, wire_type, value) over a message's fields.
    Length-delimited values are bytes; varints are ints (unsigned —
    callers apply _signed64 where the schema says int64)."""
    pos = 0
    end = len(data)
    while pos < end:
        key, pos = _read_varint(data, pos)
        field_num, wire_type = key >> 3, key & 0x7
        if wire_type == 0:
            value, pos = _read_varint(data, pos)
        elif wire_type == 1:
            value = data[pos : pos + 8]
            pos += 8
        elif wire_type == 2:
            length, pos = _read_varint(data, pos)
            value = data[pos : pos + length]
            pos += length
        elif wire_type == 5:
            value = data[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire_type}")
        yield field_num, wire_type, value


# -- ONNX data types (onnx.proto3 TensorProto.DataType) ---------------------

FLOAT = 1
INT32 = 6
INT64 = 7
FLOAT16 = 10
DOUBLE = 11
BFLOAT16 = 16

_NP_TO_ONNX = {
    np.dtype(np.float32): FLOAT,
    np.dtype(np.int32): INT32,
    np.dtype(np.int64): INT64,
    np.dtype(np.float16): FLOAT16,
    np.dtype(np.float64): DOUBLE,
}
_ONNX_TO_NP = {v: k for k, v in _NP_TO_ONNX.items()}

# AttributeProto.AttributeType
ATTR_FLOAT = 1
ATTR_INT = 2
ATTR_STRING = 3
ATTR_TENSOR = 4
ATTR_FLOATS = 6
ATTR_INTS = 7


# -- typed message views ----------------------------------------------------


@dataclass
class Attribute:
    name: str
    # exactly one of these is meaningful, per `type`
    type: int = ATTR_INT
    f: float = 0.0
    i: int = 0
    s: bytes = b""
    floats: list[float] = field(default_factory=list)
    ints: list[int] = field(default_factory=list)

    def encode(self) -> bytes:
        buf = bytearray()
        write_string(buf, 1, self.name)
        if self.type == ATTR_FLOAT:
            write_float(buf, 2, self.f)
        elif self.type == ATTR_INT:
            write_int(buf, 3, self.i)
        elif self.type == ATTR_STRING:
            write_len_delimited(buf, 4, self.s)
        elif self.type == ATTR_FLOATS:
            for v in self.floats:
                write_float(buf, 7, v)
        elif self.type == ATTR_INTS:
            for v in self.ints:
                write_int(buf, 8, v)
        else:
            raise ValueError(f"unsupported attribute type {self.type}")
        write_int(buf, 20, self.type)
        return bytes(buf)

    @classmethod
    def decode(cls, data: bytes) -> "Attribute":
        a = cls(name="", type=0)
        for num, _wt, val in iter_fields(data):
            if num == 1:
                a.name = val.decode("utf-8")
            elif num == 2:
                a.f = float(np.frombuffer(val, np.float32)[0])
                a.type = a.type or ATTR_FLOAT
            elif num == 3:
                a.i = _signed64(val)
                a.type = a.type or ATTR_INT
            elif num == 4:
                a.s = val
                a.type = a.type or ATTR_STRING
            elif num == 7:
                a.floats.extend(_floats_from(val, _wt))
                a.type = a.type or ATTR_FLOATS
            elif num == 8:
                a.ints.extend(_ints_from(val, _wt))
                a.type = a.type or ATTR_INTS
            elif num == 20:
                a.type = val
        return a

    @property
    def value(self):
        return {
            ATTR_FLOAT: self.f, ATTR_INT: self.i, ATTR_STRING: self.s,
            ATTR_FLOATS: self.floats, ATTR_INTS: self.ints,
        }[self.type]


@dataclass
class Node:
    op_type: str
    inputs: list[str]
    outputs: list[str]
    name: str = ""
    attributes: dict[str, Attribute] = field(default_factory=dict)

    def attr(self, name: str, default=None):
        a = self.attributes.get(name)
        return default if a is None else a.value

    def encode(self) -> bytes:
        buf = bytearray()
        for s in self.inputs:
            write_string(buf, 1, s)
        for s in self.outputs:
            write_string(buf, 2, s)
        if self.name:
            write_string(buf, 3, self.name)
        write_string(buf, 4, self.op_type)
        for a in self.attributes.values():
            write_len_delimited(buf, 5, a.encode())
        return bytes(buf)

    @classmethod
    def decode(cls, data: bytes) -> "Node":
        n = cls(op_type="", inputs=[], outputs=[])
        for num, _wt, val in iter_fields(data):
            if num == 1:
                n.inputs.append(val.decode("utf-8"))
            elif num == 2:
                n.outputs.append(val.decode("utf-8"))
            elif num == 3:
                n.name = val.decode("utf-8")
            elif num == 4:
                n.op_type = val.decode("utf-8")
            elif num == 5:
                a = Attribute.decode(val)
                n.attributes[a.name] = a
        return n


def encode_tensor(name: str, array: np.ndarray) -> bytes:
    """TensorProto with raw_data payload."""
    arr = np.ascontiguousarray(array)
    onnx_type = _NP_TO_ONNX.get(arr.dtype)
    if onnx_type is None:
        raise ValueError(f"unsupported tensor dtype {arr.dtype}")
    buf = bytearray()
    for d in arr.shape:
        write_int(buf, 1, d)
    write_int(buf, 2, onnx_type)
    write_string(buf, 8, name)
    write_len_delimited(buf, 9, arr.tobytes())  # little-endian raw
    return bytes(buf)


def decode_tensor(data: bytes) -> tuple[str, np.ndarray]:
    dims: list[int] = []
    dtype = FLOAT
    name = ""
    raw: bytes | None = None
    float_data: list[float] = []
    int32_data: list[int] = []
    int64_data: list[int] = []
    for num, _wt, val in iter_fields(data):
        if num == 1:
            dims.extend(_ints_from(val, _wt))
        elif num == 2:
            dtype = val
        elif num == 4:
            float_data.extend(_floats_from(val, _wt))
        elif num == 5:
            int32_data.extend(_ints_from(val, _wt))
        elif num == 7:
            int64_data.extend(_ints_from(val, _wt))
        elif num == 8:
            name = val.decode("utf-8")
        elif num == 9:
            raw = val
    np_dtype = _ONNX_TO_NP.get(dtype)
    if np_dtype is None:
        raise ValueError(f"unsupported ONNX tensor data_type {dtype}")
    if raw is not None:
        arr = np.frombuffer(raw, np_dtype).reshape(dims)
    elif float_data:
        arr = np.asarray(float_data, np_dtype).reshape(dims)
    elif int64_data:
        arr = np.asarray(int64_data, np_dtype).reshape(dims)
    elif int32_data:
        arr = np.asarray(int32_data, np_dtype).reshape(dims)
    else:
        arr = np.zeros(dims, np_dtype)
    return name, arr


def encode_value_info(name: str, elem_type: int, shape) -> bytes:
    """ValueInfoProto; shape entries are int dims or strings (dynamic)."""
    shape_buf = bytearray()
    for d in shape:
        dim = bytearray()
        if isinstance(d, str):
            write_string(dim, 2, d)  # dim_param
        else:
            write_int(dim, 1, int(d))  # dim_value
        write_len_delimited(shape_buf, 1, bytes(dim))
    tensor_type = bytearray()
    write_int(tensor_type, 1, elem_type)
    write_len_delimited(tensor_type, 2, bytes(shape_buf))
    type_proto = bytearray()
    write_len_delimited(type_proto, 1, bytes(tensor_type))
    buf = bytearray()
    write_string(buf, 1, name)
    write_len_delimited(buf, 2, bytes(type_proto))
    return bytes(buf)


def decode_value_info(data: bytes) -> str:
    for num, _wt, val in iter_fields(data):
        if num == 1:
            return val.decode("utf-8")
    return ""


@dataclass
class Graph:
    nodes: list[Node] = field(default_factory=list)
    name: str = "graph"
    initializers: dict[str, np.ndarray] = field(default_factory=dict)
    inputs: list[bytes] = field(default_factory=list)   # encoded ValueInfo
    outputs: list[bytes] = field(default_factory=list)
    input_names: list[str] = field(default_factory=list)
    output_names: list[str] = field(default_factory=list)

    def add_input(self, name: str, elem_type: int, shape) -> None:
        self.inputs.append(encode_value_info(name, elem_type, shape))
        self.input_names.append(name)

    def add_output(self, name: str, elem_type: int, shape) -> None:
        self.outputs.append(encode_value_info(name, elem_type, shape))
        self.output_names.append(name)

    def encode(self) -> bytes:
        buf = bytearray()
        for n in self.nodes:
            write_len_delimited(buf, 1, n.encode())
        write_string(buf, 2, self.name)
        for name, arr in self.initializers.items():
            write_len_delimited(buf, 5, encode_tensor(name, arr))
        for vi in self.inputs:
            write_len_delimited(buf, 11, vi)
        for vi in self.outputs:
            write_len_delimited(buf, 12, vi)
        return bytes(buf)

    @classmethod
    def decode(cls, data: bytes) -> "Graph":
        g = cls()
        for num, _wt, val in iter_fields(data):
            if num == 1:
                g.nodes.append(Node.decode(val))
            elif num == 2:
                g.name = val.decode("utf-8")
            elif num == 5:
                name, arr = decode_tensor(val)
                g.initializers[name] = arr
            elif num == 11:
                g.inputs.append(val)
                g.input_names.append(decode_value_info(val))
            elif num == 12:
                g.outputs.append(val)
                g.output_names.append(decode_value_info(val))
        return g


@dataclass
class Model:
    graph: Graph
    ir_version: int = 8
    opset_version: int = 17
    producer_name: str = "wav2vec2_tpu"

    def encode(self) -> bytes:
        buf = bytearray()
        write_int(buf, 1, self.ir_version)
        write_string(buf, 2, self.producer_name)
        write_len_delimited(buf, 7, self.graph.encode())
        opset = bytearray()
        write_string(opset, 1, "")  # default ONNX domain
        write_int(opset, 2, self.opset_version)
        write_len_delimited(buf, 8, bytes(opset))
        return bytes(buf)

    @classmethod
    def decode(cls, data: bytes) -> "Model":
        graph = None
        ir_version = 8
        opset_version = 17
        producer = ""
        for num, _wt, val in iter_fields(data):
            if num == 1:
                ir_version = val
            elif num == 2:
                producer = val.decode("utf-8")
            elif num == 7:
                graph = Graph.decode(val)
            elif num == 8:
                for onum, _owt, oval in iter_fields(val):
                    if onum == 2:
                        opset_version = oval
        if graph is None:
            raise ValueError("no GraphProto in model")
        return cls(graph=graph, ir_version=ir_version,
                   opset_version=opset_version, producer_name=producer)


def save_model(path, model: Model) -> None:
    from pathlib import Path

    Path(path).write_bytes(model.encode())


def load_model(path) -> Model:
    from pathlib import Path

    return Model.decode(Path(path).read_bytes())
