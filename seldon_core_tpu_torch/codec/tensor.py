"""Tensor payload codecs: SeldonMessage protos <-> numpy arrays.

Covers the payload kinds of the wire contract that this port serves:

* ``tensor``    — packed float64 `Tensor` (shape + values)
* ``ndarray``   — JSON-style nested lists (`google.protobuf.ListValue`)
* ``rawTensor`` — dtype + shape + raw little-endian bytes; decodes with
                  ``np.frombuffer`` (no copy, no float64 widening), so a
                  uint8 image batch reaches the device as uint8
* ``binData`` / ``strData`` / ``jsonData`` — passed through as
  bytes / str / python objects

Not served yet: ``tftensor`` payloads, and numpy-less dtypes such as
bfloat16 on the wire.  Both are a :class:`PayloadError` (HTTP 400).
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

import numpy as np
from google.protobuf import json_format
from google.protobuf.struct_pb2 import ListValue

from seldon_core_tpu_torch.proto import pb


class PayloadError(ValueError):
    """Raised when a message payload cannot be decoded."""


def np_dtype(name: str) -> np.dtype:
    """Resolve a wire dtype name to a numpy dtype."""
    try:
        return np.dtype(name)
    except TypeError:
        raise PayloadError(f"unknown dtype: {name!r}") from None


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
    dtype = np_dtype(raw.dtype or "float32")
    return frombuffer_checked(raw.data, dtype, tuple(raw.shape))


def frombuffer_checked(data: bytes, dtype: np.dtype, shape: tuple) -> np.ndarray:
    nbytes = len(data)
    if nbytes % dtype.itemsize:
        raise PayloadError(
            f"misaligned rawTensor payload: {nbytes} bytes is not a "
            f"multiple of {dtype.name} itemsize {dtype.itemsize}"
        )
    arr = np.frombuffer(data, dtype=dtype)
    if shape:
        expect = int(np.prod(shape, dtype=np.int64))
        if expect != arr.size:
            raise PayloadError(
                f"rawTensor shape {shape} needs {expect} {dtype.name} "
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
        raise PayloadError("tftensor payloads are not served by the PyTorch port yet")
    raise PayloadError(f"DefaultData has no decodable payload (kind={kind})")


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
    ("tensor" | "ndarray" | "rawTensor"); responses echo the request's."""
    datadef = pb.DefaultData(names=list(names or []))
    if data_type == "tensor":
        datadef.tensor.CopyFrom(array_to_tensor(arr))
    elif data_type == "rawTensor":
        datadef.rawTensor.CopyFrom(array_to_raw_tensor(arr))
    elif data_type == "ndarray":
        datadef.ndarray.CopyFrom(array_to_ndarray(arr))
    else:
        raise PayloadError(f"unknown data_type {data_type!r}")
    return datadef


def message_data_kind(msg: pb.SeldonMessage) -> Optional[str]:
    """The payload kind of a message: "tensor" | "ndarray" | "rawTensor"
    | "tftensor" | "binData" | "strData" | "jsonData" | None."""
    kind = msg.WhichOneof("data_oneof")
    if kind == "data":
        return msg.data.WhichOneof("data_oneof")
    return kind
