"""Internal message representation used by the data plane.

The orchestrator and dispatch layer operate on one in-memory form,
``InternalMessage``, whose payload may be a numpy array, a CUDA
``torch.Tensor``, bytes, str, or a JSON object.  Wire codecs (proto /
JSON) run only at transport boundaries.

``kind`` records the wire encoding of the original request so responses
echo it (tensor in -> tensor out), matching reference behaviour
(reference: utils.py:426-498).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
from google.protobuf import json_format

from seldon_core_tpu_torch import codec
from seldon_core_tpu_torch.proto import pb

ARRAY_KINDS = ("tensor", "ndarray", "rawTensor", "tftensor")
# tftensor has no REST/JSON representation (TF clients speak gRPC binary);
# JSON responses for tftensor-kind messages fall back to "tensor".
JSON_ARRAY_KINDS = ("tensor", "ndarray", "rawTensor")


@dataclass
class MsgMeta:
    puid: str = ""
    tags: Dict[str, Any] = field(default_factory=dict)
    routing: Dict[str, int] = field(default_factory=dict)
    request_path: Dict[str, str] = field(default_factory=dict)
    metrics: List[Dict[str, Any]] = field(default_factory=list)

    def copy(self) -> "MsgMeta":
        return MsgMeta(
            puid=self.puid,
            tags=dict(self.tags),
            routing=dict(self.routing),
            request_path=dict(self.request_path),
            metrics=list(self.metrics),
        )

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        if self.puid:
            out["puid"] = self.puid
        if self.tags:
            out["tags"] = self.tags
        if self.routing:
            out["routing"] = self.routing
        if self.request_path:
            out["requestPath"] = self.request_path
        if self.metrics:
            out["metrics"] = self.metrics
        return out

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "MsgMeta":
        d = d or {}
        return cls(
            puid=d.get("puid", ""),
            tags=dict(d.get("tags", {})),
            routing={k: int(v) for k, v in d.get("routing", {}).items()},
            request_path=dict(d.get("requestPath", {})),
            metrics=list(d.get("metrics", [])),
        )


def _metric_to_dict(m: pb.Metric) -> Dict[str, Any]:
    out: Dict[str, Any] = {
        "key": m.key,
        "type": pb.Metric.MetricType.Name(m.type),
        "value": m.value,
    }
    if m.tags:
        out["tags"] = dict(m.tags)
    return out


@dataclass
class InternalMessage:
    """One request/response flowing through the graph."""

    payload: Any = None
    names: List[str] = field(default_factory=list)
    kind: str = "tensor"
    meta: MsgMeta = field(default_factory=MsgMeta)
    status: Optional[Dict[str, Any]] = None

    # ---- constructors -----------------------------------------------------

    @classmethod
    def from_proto(cls, msg: pb.SeldonMessage) -> "InternalMessage":
        meta = MsgMeta(
            puid=msg.meta.puid,
            tags={k: json_format.MessageToDict(v) for k, v in msg.meta.tags.items()},
            routing=dict(msg.meta.routing),
            request_path=dict(msg.meta.requestPath),
            metrics=[_metric_to_dict(m) for m in msg.meta.metrics],
        )
        kind = codec.message_data_kind(msg)
        payload: Any = None
        names: List[str] = []
        if kind in ARRAY_KINDS:
            payload = codec.datadef_to_array(msg.data)
            names = list(msg.data.names)
        elif kind == "binData":
            payload = msg.binData
        elif kind == "strData":
            payload = msg.strData
        elif kind == "jsonData":
            payload = json_format.MessageToDict(msg.jsonData)
        status = None
        if msg.HasField("status"):
            s = msg.status
            status = {"status": pb.Status.StatusFlag.Name(s.status)}
            if s.code:
                status["code"] = s.code
            if s.info:
                status["info"] = s.info
            if s.reason:
                status["reason"] = s.reason
        return cls(payload=payload, names=names, kind=kind or "tensor", meta=meta, status=status)

    @classmethod
    def from_json(cls, body: Dict[str, Any]) -> "InternalMessage":
        payload, meta_dict, datadef, kind = codec.extract_json_payload(body)
        names = list(datadef.get("names", [])) if datadef else []
        return cls(
            payload=payload,
            names=names,
            kind=kind,
            meta=MsgMeta.from_dict(meta_dict),
            status=body.get("status"),
        )

    # ---- exporters --------------------------------------------------------

    def host_payload(self) -> Any:
        """Payload with any device tensor fetched back to host."""
        if codec.is_device_array(self.payload):
            return codec.from_device(self.payload)
        return self.payload

    def to_proto(self) -> pb.SeldonMessage:
        msg = pb.SeldonMessage()
        m = self.meta
        msg.meta.puid = m.puid
        for k, v in m.tags.items():
            json_format.ParseDict(v, msg.meta.tags[k])
        msg.meta.routing.update(m.routing)
        msg.meta.requestPath.update(m.request_path)
        for md in m.metrics:
            metric = msg.meta.metrics.add()
            metric.key = md.get("key", "")
            metric.type = pb.Metric.MetricType.Value(md.get("type", "COUNTER"))
            metric.value = float(md.get("value", 0.0))
            for tk, tv in (md.get("tags") or {}).items():
                metric.tags[tk] = str(tv)
        if self.status:
            s = self.status
            msg.status.code = int(s.get("code", 0))
            msg.status.info = str(s.get("info", ""))
            msg.status.reason = str(s.get("reason", ""))
            if s.get("status") in ("SUCCESS", "FAILURE"):
                msg.status.status = pb.Status.StatusFlag.Value(s["status"])
        payload = self.host_payload()
        if payload is None:
            return msg
        if isinstance(payload, bytes):
            msg.binData = payload
        elif isinstance(payload, str):
            msg.strData = payload
        elif self.kind == "jsonData" or isinstance(payload, dict):
            json_format.ParseDict(payload, msg.jsonData)
        else:
            arr = np.asarray(payload)
            kind = self.kind if self.kind in JSON_ARRAY_KINDS else "tensor"
            if arr.dtype.kind in "US":
                kind = "ndarray"
            msg.data.CopyFrom(codec.array_to_datadef(arr, self.names, kind))
        return msg

    def to_json(self) -> Dict[str, Any]:
        body: Dict[str, Any] = {}
        if self.status:
            body["status"] = self.status
        meta = self.meta.to_dict()
        if meta:
            body["meta"] = meta
        payload = self.host_payload()
        if payload is None:
            return body
        kind = self.kind if self.kind in JSON_ARRAY_KINDS else "tensor"
        if isinstance(payload, np.ndarray) and payload.dtype.kind in "USO":
            # strings can only travel as ndarray in the JSON dialect
            kind = "ndarray"
        body.update(codec.build_json_payload(payload, names=self.names, data_kind=kind))
        return body

    def with_payload(self, payload: Any, names: Optional[List[str]] = None) -> "InternalMessage":
        """New message carrying `payload`, inheriting meta/kind."""
        return dataclasses.replace(
            self,
            payload=payload,
            names=list(names) if names is not None else list(self.names),
            meta=self.meta.copy(),
        )
