"""TensorFlow-free codec for ``tensorflow.TensorProto`` payloads.

The wire format is decoded directly (``TensorProto`` is ~20 scalar and
repeated fields, and numpy views the bit patterns natively), so the
port serves TF clients without linking TensorFlow.  Decode follows TF's
``tensor_util.MakeNdarray``:

* ``tensor_content`` (dense little-endian bytes) wins when present;
* otherwise the dtype's typed ``*_val`` list is used, short lists padded
  by repeating the last element (TF's broadcast-a-scalar idiom);
* fp16 / bfloat16 travel as raw bit patterns in ``half_val``;
* complex values travel interleaved (real, imag, real, ...).

numpy has no bfloat16: ``DT_BFLOAT16`` decodes to float32, each 16-bit
pattern widened exactly (the float32 whose upper half it is), from
``tensor_content`` and from ``half_val`` alike.  Encoding writes the
dense ``tensor_content`` form; a float32 array encodes as ``DT_FLOAT``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from seldon_core_tpu_torch.proto import tf_compat_pb2 as tfpb

_BF16_WORDS = np.dtype("<u2")


class TfTensorError(ValueError):
    """Raised when a TensorProto cannot be decoded/encoded."""


# DataType enum value -> (numpy dtype of the wire values, typed-val field name)
_DT_TABLE = {
    tfpb.DT_FLOAT: (np.dtype(np.float32), "float_val"),
    tfpb.DT_DOUBLE: (np.dtype(np.float64), "double_val"),
    tfpb.DT_INT32: (np.dtype(np.int32), "int_val"),
    tfpb.DT_UINT8: (np.dtype(np.uint8), "int_val"),
    tfpb.DT_INT16: (np.dtype(np.int16), "int_val"),
    tfpb.DT_INT8: (np.dtype(np.int8), "int_val"),
    tfpb.DT_INT64: (np.dtype(np.int64), "int64_val"),
    tfpb.DT_BOOL: (np.dtype(np.bool_), "bool_val"),
    tfpb.DT_UINT16: (np.dtype(np.uint16), "int_val"),
    tfpb.DT_UINT32: (np.dtype(np.uint32), "uint32_val"),
    tfpb.DT_UINT64: (np.dtype(np.uint64), "uint64_val"),
    tfpb.DT_HALF: (np.dtype(np.float16), "half_val"),
    tfpb.DT_BFLOAT16: (_BF16_WORDS, "half_val"),
    tfpb.DT_COMPLEX64: (np.dtype(np.complex64), "scomplex_val"),
    tfpb.DT_COMPLEX128: (np.dtype(np.complex128), "dcomplex_val"),
    tfpb.DT_STRING: (np.dtype(object), "string_val"),
}

_NP_TO_DT = {
    dtype: dt for dt, (dtype, _) in _DT_TABLE.items()
    if dt not in (tfpb.DT_BFLOAT16, tfpb.DT_STRING)
}


def _shape_of(tp: tfpb.TensorProto) -> tuple:
    if tp.tensor_shape.unknown_rank:
        raise TfTensorError("TensorProto has unknown rank")
    return tuple(int(d.size) for d in tp.tensor_shape.dim)


def _from_typed_vals(tp: tfpb.TensorProto, dtype: np.dtype, field: str, size: int) -> np.ndarray:
    vals = list(getattr(tp, field))
    if field == "half_val":
        # fp16 / bfloat16 bit patterns carried as int32
        arr = np.asarray(vals, dtype=np.uint16).view(dtype)
    elif field in ("scomplex_val", "dcomplex_val"):
        flat = np.asarray(vals, dtype=np.float32 if field == "scomplex_val" else np.float64)
        if flat.size % 2:
            raise TfTensorError("odd number of components in complex *_val")
        arr = flat.view(dtype)
    elif field == "string_val":
        arr = np.asarray(vals, dtype=object)
    else:
        arr = np.asarray(vals, dtype=dtype)
    if arr.size == size:
        return arr
    if arr.size == 0:
        return np.zeros(size, dtype=dtype if field != "string_val" else object)
    if arr.size < size:  # TF repeats the final element to fill
        pad = np.full(size - arr.size, arr[-1], dtype=arr.dtype)
        return np.concatenate([arr, pad])
    raise TfTensorError(f"{field} holds {arr.size} values for {size} elements")


def tftensor_to_array(tp: tfpb.TensorProto) -> np.ndarray:
    """Decode a TensorProto to an ndarray (TF's MakeNdarray, sans TF)."""
    entry = _DT_TABLE.get(tp.dtype)
    if entry is None:
        name = tfpb.DataType.Name(tp.dtype) if tp.dtype in tfpb.DataType.values() else tp.dtype
        raise TfTensorError(f"unsupported TensorProto dtype {name}")
    dtype, field = entry
    shape = _shape_of(tp)
    size = int(np.prod(shape)) if shape else 1
    if tp.tensor_content:
        if dtype == np.dtype(object):
            raise TfTensorError("DT_STRING cannot use tensor_content")
        if len(tp.tensor_content) % dtype.itemsize:
            raise TfTensorError(
                f"tensor_content of {len(tp.tensor_content)} bytes is not a whole number of "
                f"{dtype.itemsize}-byte elements"
            )
        arr = np.frombuffer(tp.tensor_content, dtype=dtype)
        if arr.size != size:
            raise TfTensorError(
                f"tensor_content holds {arr.size} elements, shape {shape} wants {size}"
            )
    else:
        arr = _from_typed_vals(tp, dtype, field, size)
    if tp.dtype == tfpb.DT_BFLOAT16:
        arr = (arr.astype(np.uint32) << 16).view(np.float32)
    return arr.reshape(shape)


def array_to_tftensor(arr: np.ndarray, out: Optional[tfpb.TensorProto] = None) -> tfpb.TensorProto:
    """Encode an ndarray as a TensorProto (dense tensor_content form)."""
    tp = out if out is not None else tfpb.TensorProto()
    arr = np.asarray(arr)
    if arr.dtype.kind in "USO":
        tp.dtype = tfpb.DT_STRING
        for d in arr.shape:
            tp.tensor_shape.dim.add(size=int(d))
        for v in arr.ravel():
            tp.string_val.append(v if isinstance(v, bytes) else str(v).encode("utf-8"))
        return tp
    dt = _NP_TO_DT.get(arr.dtype)
    if dt is None:
        raise TfTensorError(f"no TensorProto dtype for numpy {arr.dtype}")
    tp.dtype = dt
    for d in arr.shape:
        tp.tensor_shape.dim.add(size=int(d))
    tp.tensor_content = np.ascontiguousarray(arr).tobytes()
    return tp
