"""Proxies to external inference servers.

Parity for the reference's integration proxies — TFServing
(reference: integrations/tfserving/TfServingProxy.py:20-126), the
pre-Triton NVIDIA inference server
(reference: integrations/nvidia-inference-server/TRTProxy.py:50-81) and
SageMaker (reference: integrations/sagemaker/SagemakerProxy.py): a
graph node that translates the SeldonMessage payload to an external
server's HTTP API and back, so existing model servers join an
inference graph without rewrapping.  The port's copy of the JAX
package's proxies, HTTP over ``urllib`` (no client package).

* ``RestProxyServer`` — generic JSON-over-HTTP proxy with configurable
  request/response field names; the defaults speak the TFServing /
  KServe v1 dialect (``{"instances": [...]}`` -> ``{"predictions":
  [...]}``).
* ``TFServingGrpcProxy`` — gRPC proxy speaking
  ``/tensorflow.serving.PredictionService/Predict`` without a
  TensorFlow dependency (tf_compat protos).  A ``tftensor``-bearing
  SeldonMessage is passed through at the proto level — no decode — the
  reference's fast path (reference:
  integrations/tfserving/TfServingProxy.py:72-78); any other payload
  kind is converted to a TensorProto first.
* ``OpenAIChatProxy`` shape intentionally omitted — out of the
  reference's scope.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Any, Dict, Optional

import numpy as np

from seldon_core_tpu_torch.runtime.component import MicroserviceError, TPUComponent


class _Response:
    """An upstream answer: status, body text and its JSON."""

    def __init__(self, status_code: int, body: bytes):
        self.status_code = status_code
        self.text = body.decode("utf-8", errors="replace")

    def json(self) -> Any:
        return json.loads(self.text)


class RestProxyServer(TPUComponent):
    def __init__(
        self,
        url: str = "",
        request_field: str = "instances",
        response_field: str = "predictions",
        timeout_s: float = 10.0,
        retries: int = 2,
        headers_json: str = "{}",
        **kwargs: Any,
    ):
        super().__init__(**kwargs)
        if not url:
            raise MicroserviceError("RestProxyServer needs a url", status_code=400, reason="MISSING_URL")
        self.url = url
        self.request_field = request_field
        self.response_field = response_field
        self.timeout_s = float(timeout_s)
        self.retries = int(retries)
        self.headers = json.loads(headers_json) if isinstance(headers_json, str) else dict(headers_json)

    def _post_once(self, data: bytes, headers: Dict[str, str]) -> _Response:
        req = urllib.request.Request(self.url, data=data, headers=headers, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                return _Response(resp.status, resp.read())
        except urllib.error.HTTPError as e:  # a 4xx / 5xx answer is an answer
            return _Response(e.code, e.read())

    def _send(self, json_body: Any = None, data: Optional[bytes] = None) -> _Response:
        """POST with retries (shared by the JSON dialect and the raw-body
        SageMaker dialect)."""
        headers = dict(self.headers)
        if json_body is not None:
            data = json.dumps(json_body).encode()
            headers.setdefault("Content-Type", "application/json")
        last: Optional[Exception] = None
        for _ in range(self.retries + 1):
            try:
                resp = self._post_once(data, headers)
                if resp.status_code >= 400:
                    raise MicroserviceError(
                        f"upstream {self.url} returned {resp.status_code}: {resp.text[:200]}",
                        status_code=502,
                        reason="UPSTREAM_ERROR",
                    )
                return resp
            except MicroserviceError:
                raise
            except Exception as e:  # noqa: BLE001 — retried; exhaustion
                # converts to 502 UPSTREAM_UNREACHABLE below
                last = e
        raise MicroserviceError(
            f"upstream {self.url} unreachable: {last}", status_code=502, reason="UPSTREAM_UNREACHABLE"
        )

    def _parse_json(self, resp) -> Any:
        """2xx with a non-JSON body (misconfigured LB serving HTML) must
        surface as an upstream fault, not an internal 500."""
        try:
            return resp.json()
        except ValueError as e:
            raise MicroserviceError(
                f"upstream {self.url} returned non-JSON body: {resp.text[:200]!r}",
                status_code=502, reason="BAD_UPSTREAM_RESPONSE",
            ) from e

    def _post(self, body: Dict[str, Any]) -> Dict[str, Any]:
        return self._parse_json(self._send(json_body=body))

    def predict(self, X, names, meta=None):
        payload = np.asarray(X).tolist() if not isinstance(X, (str, bytes, dict)) else X
        out = self._post({self.request_field: payload})
        if self.response_field not in out:
            raise MicroserviceError(
                f"upstream response missing {self.response_field!r}", status_code=502, reason="BAD_UPSTREAM_RESPONSE"
            )
        return np.asarray(out[self.response_field])

    def health_status(self):
        return {"proxy": self.url}


class SageMakerProxy(RestProxyServer):
    """Proxy to a SageMaker-style ``/invocations`` endpoint.

    Reference analogue: integrations/sagemaker/SagemakerProxy.py:1-33 —
    the reference shells out to boto3's ``invoke_endpoint`` with a CSV
    body and parses a CSV reply; here the same runtime contract is
    spoken as plain HTTP (``POST {base}/endpoints/{name}/invocations``
    or any explicit ``url``), with ``content_type`` selecting the
    ``text/csv`` or ``application/json`` body encoding.  SigV4 signing
    is out of scope by design (zero-egress stance): front the endpoint
    with a signing gateway or inject pre-signed headers via
    ``headers_json``.
    """

    def __init__(
        self,
        url: str = "",
        base_url: str = "",
        endpoint_name: str = "",
        content_type: str = "text/csv",
        timeout_s: float = 10.0,
        retries: int = 2,
        headers_json: str = "{}",
        **kwargs: Any,
    ):
        if not url:
            if not (base_url and endpoint_name):
                raise MicroserviceError(
                    "SageMakerProxy needs url, or base_url + endpoint_name",
                    status_code=400, reason="MISSING_URL",
                )
            url = f"{base_url.rstrip('/')}/endpoints/{endpoint_name}/invocations"
        if content_type not in ("text/csv", "application/json"):
            raise MicroserviceError(
                f"unsupported content_type {content_type!r}",
                status_code=400, reason="BAD_CONTENT_TYPE",
            )
        super().__init__(
            url=url, timeout_s=timeout_s, retries=retries,
            headers_json=headers_json, **kwargs,
        )
        self.content_type = content_type
        self.headers.setdefault("Content-Type", content_type)
        self.headers.setdefault("Accept", content_type)

    def predict(self, X, names, meta=None):
        arr = np.atleast_2d(np.asarray(X))
        if self.content_type == "text/csv":
            body = "\n".join(",".join(repr(v) for v in row) for row in arr.tolist())
            resp = self._send(data=body.encode())
            try:
                rows = [
                    [float(cell) for cell in line.split(",")]
                    for line in resp.text.strip().splitlines() if line.strip()
                ]
            except ValueError as e:
                raise MicroserviceError(
                    f"upstream {self.url} returned non-CSV body: {resp.text[:200]!r}",
                    status_code=502, reason="BAD_UPSTREAM_RESPONSE",
                ) from e
            return np.asarray(rows)
        resp = self._send(data=json.dumps(arr.tolist()).encode())
        return np.asarray(self._parse_json(resp))


TFSERVING_PREDICT_METHOD = "/tensorflow.serving.PredictionService/Predict"


class TFServingGrpcProxy(TPUComponent):
    """Graph node proxying to a TFServing gRPC endpoint.

    Implements the reference's gRPC lane (reference:
    integrations/tfserving/TfServingProxy.py:54-90) TensorFlow-free: the
    PredictRequest/PredictResponse wire messages are the re-declared
    tf_compat protos and the stub is a bare ``channel.unary_unary`` on
    the TFServing method path.
    """

    def __init__(
        self,
        grpc_endpoint: str = "",
        model_name: str = "",
        signature_name: str = "serving_default",
        model_input: str = "inputs",
        model_output: str = "",
        timeout_s: float = 10.0,
        max_message_mb: int = 512,
        **kwargs: Any,
    ):
        super().__init__(**kwargs)
        if not grpc_endpoint or not model_name:
            raise MicroserviceError(
                "TFServingGrpcProxy needs grpc_endpoint and model_name",
                status_code=400,
                reason="MISSING_ENDPOINT",
            )
        self.grpc_endpoint = grpc_endpoint
        self.model_name = model_name
        self.signature_name = signature_name
        self.model_input = model_input
        self.model_output = model_output
        self.timeout_s = float(timeout_s)
        self.max_message_bytes = int(max_message_mb) * 1024 * 1024
        self._predict_rpc = None

    def _rpc(self):
        if self._predict_rpc is None:
            import grpc

            from seldon_core_tpu_torch.proto import tfserving_compat_pb2 as tfs

            options = [
                ("grpc.max_send_message_length", self.max_message_bytes),
                ("grpc.max_receive_message_length", self.max_message_bytes),
            ]
            channel = grpc.insecure_channel(self.grpc_endpoint, options)
            self._predict_rpc = channel.unary_unary(
                TFSERVING_PREDICT_METHOD,
                request_serializer=tfs.PredictRequest.SerializeToString,
                response_deserializer=tfs.PredictResponse.FromString,
            )
        return self._predict_rpc

    def predict_raw(self, msg):
        """Proto-level predict: tftensor passthrough, else convert."""
        from seldon_core_tpu_torch.codec import tensor as tensor_codec
        from seldon_core_tpu_torch.codec.tftensor import array_to_tftensor
        from seldon_core_tpu_torch.proto import pb
        from seldon_core_tpu_torch.proto import tfserving_compat_pb2 as tfs

        req = tfs.PredictRequest()
        req.model_spec.name = self.model_name
        req.model_spec.signature_name = self.signature_name
        kind = msg.WhichOneof("data_oneof")
        if kind != "data":
            raise MicroserviceError(
                "TFServingGrpcProxy supports DefaultData payloads only",
                status_code=400,
                reason="UNSUPPORTED_PAYLOAD",
            )
        if msg.data.WhichOneof("data_oneof") == "tftensor":
            req.inputs[self.model_input].CopyFrom(msg.data.tftensor)
        else:
            array_to_tftensor(
                tensor_codec.datadef_to_array(msg.data), out=req.inputs[self.model_input]
            )
        try:
            result = self._rpc()(req, timeout=self.timeout_s)
        except Exception as e:  # noqa: BLE001 — grpc.RpcError and channel setup
            raise MicroserviceError(
                f"TFServing upstream {self.grpc_endpoint} failed: {e}",
                status_code=502,
                reason="UPSTREAM_ERROR",
            )
        if self.model_output:
            if self.model_output not in result.outputs:
                raise MicroserviceError(
                    f"TFServing response missing output {self.model_output!r}",
                    status_code=502,
                    reason="BAD_UPSTREAM_RESPONSE",
                )
            out_tensor = result.outputs[self.model_output]
        elif len(result.outputs) == 1:
            out_tensor = next(iter(result.outputs.values()))
        else:
            raise MicroserviceError(
                f"TFServing returned {len(result.outputs)} outputs; set model_output",
                status_code=502,
                reason="BAD_UPSTREAM_RESPONSE",
            )
        reply = pb.SeldonMessage()
        reply.meta.CopyFrom(msg.meta)
        reply.data.tftensor.CopyFrom(out_tensor)
        return reply

    def health_status(self):
        return {"proxy": self.grpc_endpoint, "model": self.model_name}
