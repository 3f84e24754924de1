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
    # W3C trace-context carrier ({"traceparent": ..., "tracestate": ...})
    # for hops with no header or metadata channel (the local transport,
    # the REST JSON body as a header fallback).  Consumed at dispatch
    # (runtime/dispatch.py pops it), so responses never echo the
    # caller's context back downstream.
    trace_context: Dict[str, str] = field(default_factory=dict)

    def copy(self) -> "MsgMeta":
        return MsgMeta(
            puid=self.puid,
            tags=dict(self.tags),
            routing=dict(self.routing),
            request_path=dict(self.request_path),
            metrics=list(self.metrics),
            trace_context=dict(self.trace_context),
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
        if self.trace_context:
            out["traceContext"] = self.trace_context
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
            trace_context={str(k): str(v) for k, v in (d.get("traceContext") or {}).items()},
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
        """Payload with any device tensor fetched back to host.  A
        buffer-view payload materialises as its ndarray view (no copy),
        so the proto / JSON exporters serve a zero-copy message through
        the ordinary wire encodings."""
        if codec.is_device_array(self.payload):
            return codec.from_device(self.payload)
        if isinstance(self.payload, codec.BufferView):
            return self.payload.array()
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
            kind = self.kind if self.kind in ARRAY_KINDS else "tensor"
            if arr.dtype.kind in "US" and kind != "tftensor":
                kind = "ndarray"  # tftensor carries strings natively (string_val)
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
            # strings (DT_STRING tftensor decodes too: object arrays of
            # bytes) can only travel as ndarray in the JSON dialect
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

    def copy(self) -> "InternalMessage":
        """Isolated copy for concurrent execution paths (shadow traffic):
        meta is deep-copied — every path mutates it (puid assignment,
        requestPath, metrics) — while the payload is shared, since the
        data plane treats payloads as immutable."""
        return InternalMessage(
            payload=self.payload,
            names=list(self.names),
            kind=self.kind,
            meta=self.meta.copy(),
            status=dict(self.status) if self.status else None,
        )


@dataclass
class InternalFeedback:
    request: Optional[InternalMessage] = None
    response: Optional[InternalMessage] = None
    reward: float = 0.0
    truth: Optional[InternalMessage] = None

    @classmethod
    def from_proto(cls, fb: pb.Feedback) -> "InternalFeedback":
        return cls(
            request=InternalMessage.from_proto(fb.request) if fb.HasField("request") else None,
            response=InternalMessage.from_proto(fb.response) if fb.HasField("response") else None,
            reward=fb.reward,
            truth=InternalMessage.from_proto(fb.truth) if fb.HasField("truth") else None,
        )

    @staticmethod
    def _message_from_json(body: Dict[str, Any]) -> InternalMessage:
        """Feedback members may omit the payload entirely (a meta-only
        response carrying just the routing and puid is a legal Feedback,
        reference: proto/prediction.proto:77-82), which the strict
        predict-path parser rejects.  Only the absent case is lenient: a
        malformed payload still raises, so the client sees 400."""
        if not any(k in body for k in ("data", "binData", "strData", "jsonData")):
            return InternalMessage(
                payload=None,
                kind="jsonData",
                meta=MsgMeta.from_dict(body.get("meta", {})),
                status=body.get("status"),
            )
        return InternalMessage.from_json(body)

    @classmethod
    def from_json(cls, body: Dict[str, Any]) -> "InternalFeedback":
        return cls(
            request=cls._message_from_json(body["request"]) if "request" in body else None,
            response=cls._message_from_json(body["response"]) if "response" in body else None,
            reward=float(body.get("reward", 0.0)),
            truth=cls._message_from_json(body["truth"]) if "truth" in body else None,
        )

    def to_proto(self) -> pb.Feedback:
        fb = pb.Feedback(reward=self.reward)
        if self.request is not None:
            fb.request.CopyFrom(self.request.to_proto())
        if self.response is not None:
            fb.response.CopyFrom(self.response.to_proto())
        if self.truth is not None:
            fb.truth.CopyFrom(self.truth.to_proto())
        return fb

    def to_json(self) -> Dict[str, Any]:
        body: Dict[str, Any] = {"reward": self.reward}
        if self.request is not None:
            body["request"] = self.request.to_json()
        if self.response is not None:
            body["response"] = self.response.to_json()
        if self.truth is not None:
            body["truth"] = self.truth.to_json()
        return body
