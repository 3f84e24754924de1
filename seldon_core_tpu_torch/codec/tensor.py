"""Tensor payload codecs: SeldonMessage protos <-> numpy arrays.

Covers the payload kinds of the wire contract that this port serves:

* ``tensor``    — packed float64 `Tensor` (shape + values)
* ``ndarray``   — JSON-style nested lists (`google.protobuf.ListValue`)
* ``rawTensor`` — dtype + shape + raw little-endian bytes; decodes with
                  ``np.frombuffer`` (no copy, no float64 widening), so a
                  uint8 image batch reaches the device as uint8.  numpy
                  has no bfloat16 or narrower floats: a bfloat16 payload
                  is read as uint16 and widened exactly to float32
                  (``u16 << 16``); the float8 / float6 / float4 names
                  (one byte an element, as ``ml_dtypes`` stores them)
                  widen exactly to float32 and int4 / uint4 / int2 /
                  uint2 to int8 / uint8, each by a table lookup of the
                  byte's bits: the values the JAX codec's ``ml_dtypes``
                  array upcasts to
* ``tftensor``  — ``tensorflow.TensorProto``, decoded without TensorFlow
                  (``codec/tftensor.py``; gRPC only, it has no JSON form)
* ``binData`` / ``strData`` / ``jsonData`` — passed through as
  bytes / str / python objects
"""

from __future__ import annotations

import sys
from typing import Any, Optional, Sequence

import numpy as np
from google.protobuf import json_format
from google.protobuf.struct_pb2 import ListValue

from seldon_core_tpu_torch.codec.tftensor import array_to_tftensor, tftensor_to_array
from seldon_core_tpu_torch.proto import pb


class PayloadError(ValueError):
    """Raised when a message payload cannot be decoded."""


def _float_table(exp_bits: int, man_bits: int, bias: int, special: str) -> np.ndarray:
    """float32 value of every code of a narrow float format, from its bit
    fields: sign (absent for ``e8m0``), ``exp_bits`` exponent bits with
    ``bias``, ``man_bits`` mantissa bits; subnormals below the smallest
    exponent.  ``special`` names the format's non-finite codes:
    ``"ieee"`` inf / NaN at the top exponent; ``"fn"`` NaN where every
    exponent and mantissa bit is set, no inf; ``"fnuz"`` NaN at the one
    negative-zero code, no inf and no -0; ``"none"`` every code finite;
    ``"e8m0"`` unsigned powers of two 2**(e - bias), NaN at all ones."""
    signed = special != "e8m0"
    n = 1 << (exp_bits + man_bits + signed)
    codes = np.arange(n, dtype=np.int64)
    man = codes & ((1 << man_bits) - 1)
    exp = (codes >> man_bits) & ((1 << exp_bits) - 1)
    sign = np.where(codes >= (1 << (exp_bits + man_bits)), -1.0, 1.0)  # e8m0: no code reaches the sign
    frac = man / float(1 << man_bits)
    if special == "e8m0":
        values = np.ldexp(1.0, exp - bias)
    else:
        values = sign * np.where(exp == 0, np.ldexp(frac, 1 - bias), np.ldexp(1.0 + frac, exp - bias))
    top = (1 << exp_bits) - 1
    if special == "ieee":
        values = np.where(exp == top, np.where(man == 0, sign * np.inf, np.nan), values)
    elif special == "fn":
        values = np.where((exp == top) & (man == (1 << man_bits) - 1), np.nan, values)
    elif special == "fnuz":
        values = np.where(codes == n // 2, np.nan, values)
    elif special == "e8m0":
        values = np.where(exp == top, np.nan, values)
    return values.astype(np.float32)


def _int_table(bits: int, signed: bool) -> np.ndarray:
    codes = np.arange(1 << bits, dtype=np.int64)
    if signed:
        codes = np.where(codes >= 1 << (bits - 1), codes - (1 << bits), codes)
    return codes.astype(np.int8 if signed else np.uint8)


# the narrow ml_dtypes names the JAX codec resolves: one byte an element
# on the wire, the format's code in its low bits; each byte widens by a
# lookup of those bits (float32 for the floats, int8 / uint8 for the ints)
_NARROW_TABLES = {
    "float8_e4m3fn": _float_table(4, 3, 7, "fn"),
    "float8_e5m2": _float_table(5, 2, 15, "ieee"),
    "float8_e4m3fnuz": _float_table(4, 3, 8, "fnuz"),
    "float8_e5m2fnuz": _float_table(5, 2, 16, "fnuz"),
    "float8_e4m3b11fnuz": _float_table(4, 3, 11, "fnuz"),
    "float8_e3m4": _float_table(3, 4, 3, "ieee"),
    "float8_e4m3": _float_table(4, 3, 7, "ieee"),
    "float8_e8m0fnu": _float_table(8, 0, 127, "e8m0"),
    "float6_e2m3fn": _float_table(2, 3, 1, "none"),
    "float6_e3m2fn": _float_table(3, 2, 3, "none"),
    "float4_e2m1fn": _float_table(2, 1, 1, "none"),
    "int4": _int_table(4, True),
    "uint4": _int_table(4, False),
    "int2": _int_table(2, True),
    "uint2": _int_table(2, False),
}


def np_dtype(name: str) -> np.dtype:
    """Resolve a wire dtype name to the numpy dtype its payload decodes
    to: the widened type for ``bfloat16`` and the narrow ``ml_dtypes``
    names, else numpy's own."""
    if name == "bfloat16":
        return np.dtype(np.float32)
    if name in _NARROW_TABLES:
        return _NARROW_TABLES[name].dtype
    try:
        return np.dtype(name)
    except TypeError:
        raise PayloadError(f"unknown dtype: {name!r}") from None


def raw_to_array(data: bytes, name: str, shape: tuple) -> np.ndarray:
    """Raw little-endian bytes of wire dtype ``name`` -> ndarray, checked.
    ``bfloat16`` is widened exactly to float32: its bits are the upper
    half of the float32 of the same value.  A narrow ``ml_dtypes`` name
    widens through its table (the code's bits below the format's width
    index it)."""
    if name == "bfloat16":
        bits = frombuffer_checked(data, np.dtype("<u2"), shape, name)
        return (bits.astype(np.uint32) << 16).view(np.float32)
    table = _NARROW_TABLES.get(name)
    if table is not None:
        codes = frombuffer_checked(data, np.dtype(np.uint8), shape, name)
        return table[codes & (table.size - 1)]
    return frombuffer_checked(data, np_dtype(name), shape)


# ---------------------------------------------------------------------------
# decode: proto -> numpy / bytes / str / json
# ---------------------------------------------------------------------------

def tensor_to_array(tensor: pb.Tensor) -> np.ndarray:
    """Packed float64 Tensor -> ndarray."""
    values = np.asarray(tensor.values, dtype=np.float64)
    shape = tuple(tensor.shape)
    return values.reshape(shape) if shape else values


def raw_tensor_to_array(raw: pb.RawTensor) -> np.ndarray:
    """Zero-copy decode of the RawTensor fast path.

    Malformed payloads raise :class:`PayloadError` naming the byte
    counts precisely, never a bare numpy ValueError."""
    return raw_to_array(raw.data, raw.dtype or "float32", tuple(raw.shape))


def frombuffer_checked(data: bytes, dtype: np.dtype, shape: tuple, name: Optional[str] = None) -> np.ndarray:
    """``name``: the wire dtype the messages name (default ``dtype.name``)."""
    name = name or dtype.name
    nbytes = len(data)
    if nbytes % dtype.itemsize:
        raise PayloadError(
            f"misaligned rawTensor payload: {nbytes} bytes is not a "
            f"multiple of {name} itemsize {dtype.itemsize}"
        )
    arr = np.frombuffer(data, dtype=dtype)
    if shape:
        expect = int(np.prod(shape, dtype=np.int64))
        if expect != arr.size:
            raise PayloadError(
                f"rawTensor shape {shape} needs {expect} {name} "
                f"elements but the payload carries {arr.size}"
            )
        arr = arr.reshape(shape)
    return arr


def ndarray_to_array(ndarray: ListValue) -> np.ndarray:
    """JSON-style nested lists -> ndarray (strings allowed)."""
    return np.asarray(json_format.MessageToDict(ndarray))


def datadef_to_array(datadef: pb.DefaultData) -> np.ndarray:
    kind = datadef.WhichOneof("data_oneof")
    if kind == "tensor":
        return tensor_to_array(datadef.tensor)
    if kind == "rawTensor":
        return raw_tensor_to_array(datadef.rawTensor)
    if kind == "ndarray":
        return ndarray_to_array(datadef.ndarray)
    if kind == "tftensor":
        return tftensor_to_array(datadef.tftensor)
    raise PayloadError(f"DefaultData has no decodable payload (kind={kind})")


def get_data_from_proto(msg: pb.SeldonMessage) -> Any:
    """Extract the user-facing payload from a SeldonMessage."""
    kind = msg.WhichOneof("data_oneof")
    if kind == "data":
        return datadef_to_array(msg.data)
    if kind == "binData":
        return msg.binData
    if kind == "strData":
        return msg.strData
    if kind == "jsonData":
        return json_format.MessageToDict(msg.jsonData)
    raise PayloadError("SeldonMessage carries no payload")


# ---------------------------------------------------------------------------
# encode: numpy / bytes / str / json -> proto
# ---------------------------------------------------------------------------

def array_to_tensor(arr: np.ndarray) -> pb.Tensor:
    arr = np.asarray(arr, dtype=np.float64)
    return pb.Tensor(shape=list(arr.shape), values=arr.ravel().tolist())


def ensure_little_endian(arr: np.ndarray) -> np.ndarray:
    """The wire contract is little-endian regardless of the producing
    array's byte order."""
    if arr.dtype.byteorder == ">" or (arr.dtype.byteorder == "=" and sys.byteorder == "big"):
        return arr.astype(arr.dtype.newbyteorder("<"))
    return arr


def array_to_raw_tensor(arr: np.ndarray) -> pb.RawTensor:
    arr = np.ascontiguousarray(ensure_little_endian(np.asarray(arr)))
    return pb.RawTensor(shape=list(arr.shape), dtype=arr.dtype.name, data=arr.tobytes())


def array_to_ndarray(arr: np.ndarray) -> ListValue:
    lv = ListValue()
    json_format.ParseDict(np.asarray(arr).tolist(), lv)
    return lv


def array_to_datadef(
    arr: np.ndarray,
    names: Optional[Sequence[str]] = None,
    data_type: str = "tensor",
) -> pb.DefaultData:
    """Encode an array with the requested wire encoding
    ("tensor" | "ndarray" | "rawTensor" | "tftensor"); responses echo
    the request's."""
    datadef = pb.DefaultData(names=list(names or []))
    if data_type == "tensor":
        datadef.tensor.CopyFrom(array_to_tensor(arr))
    elif data_type == "rawTensor":
        datadef.rawTensor.CopyFrom(array_to_raw_tensor(arr))
    elif data_type == "ndarray":
        datadef.ndarray.CopyFrom(array_to_ndarray(arr))
    elif data_type == "tftensor":
        array_to_tftensor(arr, out=datadef.tftensor)
    else:
        raise PayloadError(f"unknown data_type {data_type!r}")
    return datadef


def build_message(
    payload: Any,
    names: Optional[Sequence[str]] = None,
    data_type: Optional[str] = None,
    meta: Optional[pb.Meta] = None,
) -> pb.SeldonMessage:
    """Wrap an arbitrary payload into a SeldonMessage.

    numpy arrays / lists use DefaultData (``rawTensor`` for non-float64
    numeric arrays, ``tensor`` for float64 and other kinds, ``ndarray``
    for strings, unless ``data_type`` names one), bytes -> binData, str
    -> strData, dict -> jsonData.
    """
    msg = pb.SeldonMessage()
    if meta is not None:
        msg.meta.CopyFrom(meta)
    if isinstance(payload, bytes):
        msg.binData = payload
        return msg
    if isinstance(payload, str):
        msg.strData = payload
        return msg
    if isinstance(payload, dict):
        json_format.ParseDict(payload, msg.jsonData)
        return msg
    arr = np.asarray(payload)
    if data_type is None:
        data_type = "tensor" if arr.dtype == np.float64 or arr.dtype.kind not in "fiub" else "rawTensor"
        if arr.dtype.kind in "US":  # strings go through ndarray
            data_type = "ndarray"
    msg.data.CopyFrom(array_to_datadef(arr, names, data_type))
    return msg


def message_data_kind(msg: pb.SeldonMessage) -> Optional[str]:
    """The payload kind of a message: "tensor" | "ndarray" | "rawTensor"
    | "tftensor" | "binData" | "strData" | "jsonData" | None."""
    kind = msg.WhichOneof("data_oneof")
    if kind == "data":
        return msg.data.WhichOneof("data_oneof")
    return kind
