"""Plain-JSON (dict) codec for the REST path.

REST requests are decoded from JSON into plain dicts and kept as dicts
end-to-end — no proto round-trip on the hot path.  The dict schema is
json_format-compatible with ``SeldonMessage``.
"""

from __future__ import annotations

import base64
import binascii
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from seldon_core_tpu_torch.codec.tensor import PayloadError, frombuffer_checked, np_dtype


def _bytes_to_str(x: Any) -> Any:
    """Recursively decode bytes elements for JSON serialization."""
    if isinstance(x, bytes):
        return x.decode("utf-8", errors="replace")
    if isinstance(x, list):
        return [_bytes_to_str(v) for v in x]
    return x


def extract_json_payload(body: Dict[str, Any]) -> Tuple[Any, Optional[Dict], Optional[Dict], str]:
    """Decode a REST request dict.

    Returns (features, meta_dict, datadef_dict, data_kind) where
    data_kind is one of tensor|ndarray|rawTensor|binData|strData|jsonData.
    """
    if not isinstance(body, dict):
        raise PayloadError(f"request body must be a JSON object, got {type(body).__name__}")
    meta = body.get("meta")
    if "data" in body:
        datadef = body["data"]
        if "tensor" in datadef:
            t = datadef["tensor"]
            arr = np.asarray(t.get("values", []), dtype=np.float64)
            shape = t.get("shape")
            if shape:
                try:
                    arr = arr.reshape(shape)
                except ValueError as e:
                    raise PayloadError(f"tensor values do not fill shape {shape}: {e}") from None
            return arr, meta, datadef, "tensor"
        if "rawTensor" in datadef:
            r = datadef["rawTensor"]
            data = r.get("data", b"")
            if isinstance(data, str):
                try:
                    data = base64.b64decode(data, validate=True)
                except (binascii.Error, ValueError) as e:
                    raise PayloadError(f"rawTensor data is not valid base64: {e}") from None
            shape = tuple(int(d) for d in r.get("shape") or ())
            arr = frombuffer_checked(data, np_dtype(r.get("dtype", "float32")), shape)
            return arr, meta, datadef, "rawTensor"
        if "ndarray" in datadef:
            return np.asarray(datadef["ndarray"]), meta, datadef, "ndarray"
        if "tftensor" in datadef:
            raise PayloadError("tftensor payloads are not served by the PyTorch port yet")
        raise PayloadError("request 'data' has no tensor/ndarray/rawTensor")
    if "binData" in body:
        raw = body["binData"]
        return (base64.b64decode(raw) if isinstance(raw, str) else raw), meta, None, "binData"
    if "strData" in body:
        return body["strData"], meta, None, "strData"
    if "jsonData" in body:
        return body["jsonData"], meta, None, "jsonData"
    raise PayloadError("request carries no payload")


def build_json_payload(
    result: Any,
    names: Optional[Sequence[str]] = None,
    data_kind: str = "tensor",
) -> Dict[str, Any]:
    """Encode a node result as a REST response dict, echoing the request's
    encoding."""
    body: Dict[str, Any] = {}
    if isinstance(result, bytes):
        body["binData"] = base64.b64encode(result).decode("ascii")
        return body
    if isinstance(result, str):
        body["strData"] = result
        return body
    if isinstance(result, dict):
        body["jsonData"] = result
        return body
    arr = np.asarray(result)
    datadef: Dict[str, Any] = {}
    if names:
        datadef["names"] = list(names)
    if data_kind == "rawTensor":
        arr = np.ascontiguousarray(arr)
        datadef["rawTensor"] = {
            "shape": list(arr.shape),
            "dtype": arr.dtype.name,
            "data": base64.b64encode(arr.tobytes()).decode("ascii"),
        }
    elif data_kind == "ndarray":
        lst = arr.tolist()
        if arr.dtype.kind in "SO":  # bytes elements are not JSON-serializable
            lst = _bytes_to_str(lst)
        datadef["ndarray"] = lst
    else:  # tensor (default, also used when request was binData/strData/json)
        arr = np.asarray(arr, dtype=np.float64)
        datadef["tensor"] = {"shape": list(arr.shape), "values": arr.ravel().tolist()}
    body["data"] = datadef
    return body
