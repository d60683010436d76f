"""Minimal ONNX protobuf layer: hand-rolled wire-format writer + reader.

The port's own copy of edgeyolo_tpu/export/onnx_proto.py: for the same
nodes, tensors, attributes and producer it writes the same bytes.

The ONNX serialization is plain protobuf (onnx/onnx.proto, public schema).
This image has no `onnx` package, but protobuf's wire format is simple and
stable, so the exporter emits `ModelProto` bytes directly and the in-tree
runtime parses them back — no third-party dependency, and the artifacts are
standard ONNX files loadable by onnxruntime/netron outside this image.

Behavioral spec: ultralytics/engine/exporter.py:487-540 (export_onnx) emits
ModelProto via the onnx package; the field numbers below are the onnx.proto3
schema (ModelProto ir_version=1/graph=7/opset_import=8, GraphProto node=1/
initializer=5/input=11/output=12, NodeProto input=1/output=2/op_type=4/
attribute=5, AttributeProto name=1/f=2/i=3/s=4/t=5/floats=7/ints=8/type=20,
TensorProto dims=1/data_type=2/name=8/raw_data=9).
"""

from __future__ import annotations

import struct

import numpy as np

# TensorProto.DataType codes
DTYPE_CODE = {
    np.dtype(np.float32): 1,
    np.dtype(np.uint8): 2,
    np.dtype(np.int8): 3,
    np.dtype(np.int32): 6,
    np.dtype(np.int64): 7,
    np.dtype(np.bool_): 9,
    np.dtype(np.float16): 10,
    np.dtype(np.float64): 11,
}
CODE_DTYPE = {v: k for k, v in DTYPE_CODE.items()}

# ---------------------------------------------------------------- writer ---


def _varint(v: int) -> bytes:
    if v < 0:
        v += 1 << 64
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def fint(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(int(v))


def fbytes(field: int, b: bytes) -> bytes:
    return _key(field, 2) + _varint(len(b)) + b


def fstr(field: int, s: str) -> bytes:
    return fbytes(field, s.encode("utf-8"))


def ffloat(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", float(v))


def tensor_proto(name: str, arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr)
    if arr.dtype not in DTYPE_CODE:
        raise NotImplementedError(f"onnx: unsupported dtype {arr.dtype}")
    b = b"".join(fint(1, d) for d in arr.shape)
    b += fint(2, DTYPE_CODE[arr.dtype])
    b += fstr(8, name)
    b += fbytes(9, arr.tobytes())
    return b


def attribute_proto(name: str, v) -> bytes:
    b = fstr(1, name)
    if isinstance(v, bool):
        v = int(v)
    if isinstance(v, float):
        b += ffloat(2, v) + fint(20, 1)  # FLOAT
    elif isinstance(v, int):
        b += fint(3, v) + fint(20, 2)  # INT
    elif isinstance(v, str):
        b += fstr(4, v) + fint(20, 3)  # STRING
    elif isinstance(v, np.ndarray):
        b += fbytes(5, tensor_proto(name, v)) + fint(20, 4)  # TENSOR
    elif isinstance(v, (list, tuple)) and all(isinstance(x, float) for x in v):
        b += b"".join(ffloat(7, x) for x in v) + fint(20, 6)  # FLOATS
    elif isinstance(v, (list, tuple)):
        b += b"".join(fint(8, int(x)) for x in v) + fint(20, 7)  # INTS
    else:
        raise TypeError(f"onnx attribute {name}: unsupported value {v!r}")
    return b


def node_proto(op_type: str, inputs, outputs, name: str = "", **attrs) -> bytes:
    b = b"".join(fstr(1, i) for i in inputs)
    b += b"".join(fstr(2, o) for o in outputs)
    b += fstr(3, name or outputs[0])
    b += fstr(4, op_type)
    b += b"".join(fbytes(5, attribute_proto(k, v)) for k, v in attrs.items())
    return b


def value_info_proto(name: str, dtype: np.dtype, shape) -> bytes:
    dims = b"".join(fbytes(1, fint(1, int(d))) for d in shape)
    tensor_type = fint(1, DTYPE_CODE[np.dtype(dtype)]) + fbytes(2, dims)
    return fstr(1, name) + fbytes(2, fbytes(1, tensor_type))


def graph_proto(nodes, name, initializers, inputs, outputs) -> bytes:
    b = b"".join(fbytes(1, n) for n in nodes)
    b += fstr(2, name)
    b += b"".join(fbytes(5, t) for t in initializers)
    b += b"".join(fbytes(11, v) for v in inputs)
    b += b"".join(fbytes(12, v) for v in outputs)
    return b


def model_proto(graph: bytes, opset: int = 17, doc: str = "",
                metadata: dict | None = None, producer: str = "edgeyolo_tpu_torch") -> bytes:
    b = fint(1, 8)  # ir_version 8
    b += fstr(2, producer)  # producer_name
    b += fstr(3, "1.0")  # producer_version
    if doc:
        b += fstr(6, doc)
    b += fbytes(7, graph)
    b += fbytes(8, fstr(1, "") + fint(2, opset))  # opset_import
    # metadata_props (field 14, repeated StringStringEntryProto key=1/value=2)
    # — what ultralytics-style AutoBackends read (ref exporter.py ~540)
    for k, v in (metadata or {}).items():
        b += fbytes(14, fstr(1, str(k)) + fstr(2, str(v)))
    return b


# ---------------------------------------------------------------- reader ---


def _read_varint(buf: bytes, i: int):
    v = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, i
        shift += 7


def parse_message(buf: bytes) -> dict[int, list]:
    """Parse one protobuf message into {field_number: [raw values]}.

    wire 0 -> int, wire 2 -> bytes, wire 5 -> 4 raw bytes, wire 1 -> 8 raw.
    """
    i, fields = 0, {}
    n = len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        f, w = key >> 3, key & 7
        if w == 0:
            v, i = _read_varint(buf, i)
        elif w == 2:
            ln, i = _read_varint(buf, i)
            v = bytes(buf[i:i + ln])
            i += ln
        elif w == 5:
            v = bytes(buf[i:i + 4])
            i += 4
        elif w == 1:
            v = bytes(buf[i:i + 8])
            i += 8
        else:  # pragma: no cover - groups unused by onnx
            raise ValueError(f"unsupported wire type {w}")
        fields.setdefault(f, []).append(v)
    return fields


def _as_str(b: bytes) -> str:
    return b.decode("utf-8")


def parse_tensor(buf: bytes) -> tuple[str, np.ndarray]:
    f = parse_message(buf)
    dims = [int(d) for d in f.get(1, [])]
    code = int(f[2][0])
    name = _as_str(f.get(8, [b""])[0])
    dt = CODE_DTYPE[code]
    if 9 in f:  # raw_data
        arr = np.frombuffer(f[9][0], dtype=dt)
    elif 4 in f:  # float_data (repeated fixed32)
        arr = np.array([struct.unpack("<f", x)[0] for x in f[4]], np.float32)
    elif 7 in f:  # int64_data
        arr = np.array([int(x) for x in f[7]], np.int64)
    elif 5 in f:  # int32_data
        arr = np.array([int(x) for x in f[5]], np.int32)
    else:
        arr = np.zeros(0, dt)
    return name, arr.reshape(dims).astype(dt, copy=False)


def parse_attribute(buf: bytes):
    f = parse_message(buf)
    name = _as_str(f[1][0])
    atype = int(f.get(20, [0])[0])
    if atype == 1:
        return name, struct.unpack("<f", f[2][0])[0]
    if atype == 2:
        v = int(f[3][0])
        return name, v - (1 << 64) if v >= 1 << 63 else v
    if atype == 3:
        return name, _as_str(f[4][0])
    if atype == 4:
        return name, parse_tensor(f[5][0])[1]
    if atype == 6:
        return name, [struct.unpack("<f", x)[0] for x in f.get(7, [])]
    if atype == 7:
        ints = [int(x) for x in f.get(8, [])]
        return name, [v - (1 << 64) if v >= 1 << 63 else v for v in ints]
    raise NotImplementedError(f"onnx attribute type {atype}")


def parse_node(buf: bytes) -> dict:
    f = parse_message(buf)
    return {
        "inputs": [_as_str(x) for x in f.get(1, [])],
        "outputs": [_as_str(x) for x in f.get(2, [])],
        "name": _as_str(f.get(3, [b""])[0]),
        "op": _as_str(f[4][0]),
        "attrs": dict(parse_attribute(a) for a in f.get(5, [])),
    }


def parse_value_info(buf: bytes) -> dict:
    f = parse_message(buf)
    name = _as_str(f[1][0])
    out = {"name": name, "dtype": None, "shape": None}
    if 2 in f:
        tt = parse_message(f[2][0])
        if 1 in tt:  # tensor_type
            t = parse_message(tt[1][0])
            out["dtype"] = CODE_DTYPE.get(int(t.get(1, [1])[0]))
            if 2 in t:
                dims = []
                for d in parse_message(t[2][0]).get(1, []):
                    dm = parse_message(d)
                    dims.append(int(dm[1][0]) if 1 in dm else -1)
                out["shape"] = dims
    return out


def parse_model(buf: bytes) -> dict:
    """Parse ModelProto bytes -> {graph fields}. Raises on missing graph."""
    m = parse_message(bytes(buf))
    opsets = []
    for o in m.get(8, []):
        of = parse_message(o)
        opsets.append((_as_str(of.get(1, [b""])[0]), int(of.get(2, [0])[0])))
    g = parse_message(m[7][0])
    meta = {}
    for e in m.get(14, []):
        ef = parse_message(e)
        meta[_as_str(ef.get(1, [b""])[0])] = _as_str(ef.get(2, [b""])[0])
    return {
        "ir_version": int(m.get(1, [0])[0]),
        "producer": _as_str(m.get(2, [b""])[0]),
        "opsets": opsets,
        "doc": _as_str(m.get(6, [b""])[0]),
        "metadata_props": meta,
        "name": _as_str(g.get(2, [b""])[0]),
        "nodes": [parse_node(n) for n in g.get(1, [])],
        "initializers": dict(parse_tensor(t) for t in g.get(5, [])),
        "inputs": [parse_value_info(v) for v in g.get(11, [])],
        "outputs": [parse_value_info(v) for v in g.get(12, [])],
    }
