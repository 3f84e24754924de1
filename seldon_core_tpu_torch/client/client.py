"""Client SDK.

Equivalent of the reference's ``SeldonClient``
(reference: python/seldon_core/seldon_client.py:147-795): one object
that can talk to a deployment's gateway or directly to a node
microservice, over REST or gRPC, with payload construction helpers and
random-payload generation by shape for smoke tests.

The REST lane speaks HTTP/1.1 through ``http.client`` (one keep-alive
connection a client; a fresh one a token stream), so the port needs no
``requests``.
"""

from __future__ import annotations

import base64
import dataclasses
import http.client
import json
import socket
import urllib.parse
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from seldon_core_tpu_torch.native.frontserver import (
    StaleConnection,
    pack_raw_frame,
    read_http_response,
    unpack_raw_frame,
)
from seldon_core_tpu_torch.runtime.message import InternalFeedback, InternalMessage


@dataclasses.dataclass
class ClientResponse:
    success: bool
    response: Optional[InternalMessage]
    raw: Any = None  # dict (REST) or proto (gRPC)

    @property
    def data(self):
        return self.response.payload if self.response is not None else None

    @property
    def meta(self):
        return self.response.meta if self.response is not None else None


class _RestResponse:
    """The parts of an HTTP response the client reads: status, body as
    JSON or text, and a line iterator for Server-Sent Events."""

    def __init__(self, resp: http.client.HTTPResponse, conn: Optional[http.client.HTTPConnection] = None,
                 body: Optional[bytes] = None):
        self.status_code = resp.status
        self._resp = resp
        self._conn = conn  # owned (closed with the response) on the stream lane
        self._body = body

    @property
    def content(self) -> bytes:
        if self._body is None:
            self._body = self._resp.read()
        return self._body

    @property
    def text(self) -> str:
        return self.content.decode("utf-8", "replace")

    def json(self) -> Any:
        return json.loads(self.content)  # JSONDecodeError is a ValueError

    def iter_lines(self):
        for raw in self._resp:
            yield raw.decode("utf-8").rstrip("\r\n")

    def close(self) -> None:
        self._resp.close()
        if self._conn is not None:
            self._conn.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def random_payload(shape: Sequence[int] = (1, 4), dtype: str = "float64") -> np.ndarray:
    """Random request payload by shape (reference: seldon_client.py
    random ndarray generation)."""
    rng = np.random.default_rng()
    if np.dtype(dtype).kind == "u" or np.dtype(dtype).kind == "i":
        return rng.integers(0, 255, size=tuple(shape)).astype(dtype)
    return rng.normal(size=tuple(shape)).astype(dtype)


class SeldonTpuClient:
    """Talk to a gateway (external API) or a node microservice."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        http_port: int = 8000,
        grpc_port: int = 5001,
        transport: str = "rest",  # rest | grpc
        timeout_s: float = 30.0,
        channel_credentials=None,  # utils.tls.ChannelCredentials -> TLS
        call_credentials=None,  # utils.tls.CallCredentials -> auth token
        oauth_key: str = "",  # gateway client-credentials grant
        oauth_secret: str = "",  # (reference: seldon_client.py:1186-1227)
    ):
        if transport not in ("rest", "grpc"):
            raise ValueError("transport must be 'rest' or 'grpc'")
        self.host = host
        self.http_port = http_port
        self.grpc_port = grpc_port
        self.transport = transport
        self.timeout_s = timeout_s
        self.channel_credentials = channel_credentials
        self.call_credentials = call_credentials
        self.oauth_key = oauth_key
        self.oauth_secret = oauth_secret
        self._bearer_token: str = ""
        self._channel = None
        self._session = None

    # ------------------------------------------------------------- internals

    def _ensure_channel(self):
        import grpc

        if self._channel is None:
            addr = f"{self.host}:{self.grpc_port}"
            if self.channel_credentials is not None:
                from seldon_core_tpu_torch.utils.tls import grpc_channel_credentials

                self._channel = grpc.secure_channel(
                    addr, grpc_channel_credentials(self.channel_credentials)
                )
            else:
                self._channel = grpc.insecure_channel(addr)
        return self._channel

    def get_token(self, refresh: bool = False) -> str:
        """Fetch (and cache) a bearer token from the gateway's
        ``/oauth/token`` with the client-credentials grant (HTTP Basic,
        reference: seldon_client.py get_token)."""
        if self._bearer_token and not refresh:
            return self._bearer_token
        basic = base64.b64encode(f"{self.oauth_key}:{self.oauth_secret}".encode()).decode()
        conn = self._connection(self.timeout_s)
        try:
            conn.request("POST", "/oauth/token",
                         body=urllib.parse.urlencode({"grant_type": "client_credentials"}),
                         headers={"Authorization": f"Basic {basic}",
                                  "Content-Type": "application/x-www-form-urlencoded"})
            resp = _RestResponse(conn.getresponse())
            if resp.status_code != 200:
                raise ConnectionError(f"token request failed: {resp.status_code} {resp.text[:200]}")
            self._bearer_token = resp.json()["access_token"]
        finally:
            conn.close()
        return self._bearer_token

    def _call_metadata(self, refresh_token: bool = False):
        md = []
        if self.oauth_key:
            md.append(("authorization", f"Bearer {self.get_token(refresh=refresh_token)}"))
        if self.call_credentials is not None and self.call_credentials.token:
            md.append(("x-auth-token", self.call_credentials.token))
        return md or None

    def _grpc_call(self, service: str, method: str, request_proto):
        import grpc

        from seldon_core_tpu_torch.proto import services

        call = services.unary_callable(self._ensure_channel(), service, method)
        try:
            return call(request_proto, timeout=self.timeout_s, metadata=self._call_metadata())
        except grpc.RpcError as e:
            # expired token: one transparent refresh, like the REST lane
            if self.oauth_key and e.code() == grpc.StatusCode.UNAUTHENTICATED:
                return call(
                    request_proto, timeout=self.timeout_s,
                    metadata=self._call_metadata(refresh_token=True),
                )
            raise

    def _connection(self, timeout_s: Optional[float]) -> http.client.HTTPConnection:
        if self.channel_credentials is not None:
            from seldon_core_tpu_torch.utils.tls import client_ssl_context

            return http.client.HTTPSConnection(self.host, self.http_port, timeout=timeout_s,
                                               context=client_ssl_context(self.channel_credentials))
        return http.client.HTTPConnection(self.host, self.http_port, timeout=timeout_s)

    def _post_once(self, path: str, data: bytes, headers: Dict[str, str], stream: bool,
                   timeout: Optional[float]) -> _RestResponse:
        if stream:  # a token stream owns its connection until it ends
            conn = self._connection(timeout)
            try:
                conn.request("POST", path, body=data, headers=headers)
                return _RestResponse(conn.getresponse(), conn=conn)
            except BaseException:
                conn.close()
                raise
        for attempt in (0, 1):
            fresh = self._session is None
            if fresh:
                self._session = self._connection(self.timeout_s)
            try:
                self._session.request("POST", path, body=data, headers=headers)
                resp = self._session.getresponse()
                return _RestResponse(resp, body=resp.read())
            except (http.client.RemoteDisconnected, BrokenPipeError, ConnectionResetError):
                # a keep-alive connection the server closed while idle:
                # one resend on a fresh connection
                self._session.close()
                self._session = None
                if attempt or fresh:
                    raise
            except BaseException:
                self._session.close()
                self._session = None
                raise
        raise AssertionError("unreachable")

    def _rest_request(self, path: str, body: Dict[str, Any], stream: bool = False,
                      timeout: Any = None) -> _RestResponse:
        """One REST POST with the client's full connection setup (TLS
        scheme, bearer + X-Auth-Token headers, one transparent 401
        token refresh) — shared by the unary and SSE lanes so auth/TLS
        behavior cannot drift between them."""
        headers = {"Content-Type": "application/json"}
        if self.oauth_key:
            headers["Authorization"] = f"Bearer {self.get_token()}"
        if self.call_credentials is not None and self.call_credentials.token:
            headers["X-Auth-Token"] = self.call_credentials.token
        data = json.dumps(body).encode()
        send_timeout = timeout if timeout is not None else self.timeout_s
        resp = self._post_once(path, data, headers, stream, send_timeout)
        if resp.status_code == 401 and self.oauth_key:
            # expired token: one transparent refresh
            resp.close()
            headers["Authorization"] = f"Bearer {self.get_token(refresh=True)}"
            resp = self._post_once(path, data, headers, stream, send_timeout)
        return resp

    def _rest_post(self, path: str, body: Dict[str, Any]) -> Tuple[int, Dict[str, Any]]:
        resp = self._rest_request(path, body)
        try:
            return resp.status_code, resp.json()
        except ValueError:
            return resp.status_code, {"status": {"status": "FAILURE", "info": resp.text}}

    @staticmethod
    def _build_message(
        data: Any = None,
        names: Optional[List[str]] = None,
        payload_kind: Optional[str] = None,
        meta: Optional[Dict[str, Any]] = None,
    ) -> InternalMessage:
        if isinstance(data, InternalMessage):
            return data
        if isinstance(data, bytes):
            kind = "binData"
        elif isinstance(data, str):
            kind = "strData"
        elif isinstance(data, dict):
            kind = "jsonData"
        else:
            data = np.asarray(data if data is not None else random_payload())
            kind = payload_kind or ("tensor" if data.dtype == np.float64 else "rawTensor")
        msg = InternalMessage(payload=data, names=list(names or []), kind=kind)
        if meta:
            from seldon_core_tpu_torch.runtime.message import MsgMeta

            msg.meta = MsgMeta.from_dict(meta)
        return msg

    @staticmethod
    def _success(resp_msg: InternalMessage) -> bool:
        status = resp_msg.status or {}
        return status.get("status", "SUCCESS") != "FAILURE"

    # --------------------------------------------------------------- predict

    def predict(
        self,
        data: Any = None,
        names: Optional[List[str]] = None,
        payload_kind: Optional[str] = None,
        meta: Optional[Dict[str, Any]] = None,
        predictor: Optional[str] = None,
    ) -> ClientResponse:
        msg = self._build_message(data, names, payload_kind, meta)
        if self.transport == "grpc":
            proto = self._grpc_call("Seldon", "Predict", msg.to_proto())
            out = InternalMessage.from_proto(proto)
            return ClientResponse(self._success(out), out, proto)
        path = "/api/v0.1/predictions"
        if predictor:
            path += f"?predictor={predictor}"
        code, body = self._rest_post(path, msg.to_json())
        out = InternalMessage.from_json(body) if ("data" in body or "binData" in body or
                                                  "strData" in body or "jsonData" in body) else \
            InternalMessage(kind="jsonData", status=body.get("status"))
        return ClientResponse(code < 400 and self._success(out), out, body)

    def predict_stream(
        self,
        data: Any = None,
        names: Optional[List[str]] = None,
        payload_kind: Optional[str] = None,
        meta: Optional[Dict[str, Any]] = None,
        chunk_bytes: Optional[int] = None,
    ) -> ClientResponse:
        """Chunked predict over gRPC streaming — for payloads beyond the
        unary message limits (additive to the reference contract)."""
        from seldon_core_tpu_torch.proto import pb, services

        if self.transport != "grpc":
            raise ValueError("predict_stream requires transport='grpc'")
        msg = self._build_message(data, names, payload_kind, meta)
        call = services.stream_callable(self._ensure_channel(), "Seldon", "PredictStream")
        chunks = services.chunk_message(
            msg.to_proto(), chunk_bytes or services.STREAM_CHUNK_BYTES
        )
        reply_chunks = call(chunks, timeout=self.timeout_s, metadata=self._call_metadata())
        proto = services.assemble_chunks(reply_chunks, pb.SeldonMessage)
        out = InternalMessage.from_proto(proto)
        return ClientResponse(self._success(out), out, proto)

    def generate_stream(
        self,
        prompt: Any,
        meta: Optional[Dict[str, Any]] = None,
        timeout_s: Optional[float] = None,
    ):
        """Token streaming: yields int32 arrays of newly decoded tokens
        for ONE prompt as the server's generation engine emits them.
        Per-request overrides (max_new_tokens / temperature / top_k /
        seed) travel in ``meta={"tags": {...}}``.

        Transports: gRPC uses ``Seldon/GenerateStream`` (``timeout_s``
        is the whole-stream deadline; None = no deadline); REST uses
        Server-Sent Events from ``/api/v0.1/generate/stream``
        (``timeout_s`` is the connect/per-chunk read timeout — a slow
        but steadily-emitting stream never times out).  Either way the
        server frees the stream's slot if the consumer disconnects."""
        msg = self._build_message(np.atleast_2d(np.asarray(prompt, np.int32)),
                                  None, None, meta)
        if self.transport == "grpc":
            from seldon_core_tpu_torch.proto import services

            call = services.unary_stream_callable(
                self._ensure_channel(), "Seldon", "GenerateStream"
            )
            for proto in call(msg.to_proto(), timeout=timeout_s,
                              metadata=self._call_metadata()):
                out = InternalMessage.from_proto(proto)
                yield np.asarray(out.host_payload()).astype(np.int32).reshape(-1)
            return
        yield from self._generate_stream_rest(msg, timeout_s)

    def _generate_stream_rest(self, msg: InternalMessage, timeout_s):
        """SSE lane: parse `data:` events into token arrays.  An
        `event: error` surfaces as ConnectionError — and so does a
        stream that closes WITHOUT an `end` event (a server crash or
        dropped connection must not read as a complete generation;
        the gRPC lane raises RpcError for the same cases)."""
        with self._rest_request(
            "/api/v0.1/generate/stream", msg.to_json(), stream=True,
            timeout=timeout_s,
        ) as resp:
            if resp.status_code >= 400:
                raise ConnectionError(
                    f"generate stream rejected: {resp.status_code} {resp.text[:200]}"
                )
            event = ""
            ended = False
            for line in resp.iter_lines():
                if not line:
                    event = ""
                    continue
                if line.startswith("event:"):
                    event = line.split(":", 1)[1].strip()
                elif line.startswith("data:"):
                    payload = json.loads(line.split(":", 1)[1].strip())
                    if event == "error":
                        raise ConnectionError(f"stream error: {payload}")
                    if event == "end":
                        ended = True
                        break
                    yield np.asarray(payload["tokens"], np.int32)
            if not ended:
                raise ConnectionError(
                    "token stream closed without an end event (truncated)"
                )

    def feedback(
        self,
        request: Optional[Union[InternalMessage, Any]] = None,
        response: Optional[Union[InternalMessage, Any]] = None,
        reward: float = 0.0,
        truth: Any = None,
    ) -> ClientResponse:
        fb = InternalFeedback(
            request=self._build_message(request) if request is not None else None,
            response=response if isinstance(response, InternalMessage) else (
                self._build_message(response) if response is not None else None
            ),
            reward=float(reward),
            truth=self._build_message(truth) if truth is not None else None,
        )
        if self.transport == "grpc":
            proto = self._grpc_call("Seldon", "SendFeedback", fb.to_proto())
            out = InternalMessage.from_proto(proto)
            return ClientResponse(self._success(out), out, proto)
        code, body = self._rest_post("/api/v0.1/feedback", fb.to_json())
        out = InternalMessage(kind="jsonData", status=body.get("status"))
        return ClientResponse(code < 400, out, body)

    # ------------------------------------------- direct node microservice API

    def microservice(
        self,
        method: str = "predict",
        data: Any = None,
        names: Optional[List[str]] = None,
        payload_kind: Optional[str] = None,
    ) -> ClientResponse:
        """Call a node microservice endpoint directly (the reference's
        'microservice' gateway mode)."""
        msg = self._build_message(data, names, payload_kind)
        if self.transport == "grpc":
            service, rpc = {
                "predict": ("Model", "Predict"),
                "transform-input": ("Transformer", "TransformInput"),
                "transform-output": ("OutputTransformer", "TransformOutput"),
                "route": ("Router", "Route"),
            }[method]
            proto = self._grpc_call(service, rpc, msg.to_proto())
            out = InternalMessage.from_proto(proto)
            return ClientResponse(self._success(out), out, proto)
        code, body = self._rest_post(f"/{method}", msg.to_json())
        out = InternalMessage.from_json(body) if code < 400 else InternalMessage(
            kind="jsonData", status=body.get("status")
        )
        return ClientResponse(code < 400, out, body)

    def explain(self, data: Any = None, names: Optional[List[str]] = None,
                predictor: Optional[str] = None) -> ClientResponse:
        msg = self._build_message(data, names)
        path = "/api/v0.1/explanations"
        if predictor:
            path += f"?predictor={predictor}"
        code, body = self._rest_post(path, msg.to_json())
        out = InternalMessage(payload=body, kind="jsonData") if code < 400 else InternalMessage(
            kind="jsonData", status=body.get("status")
        )
        return ClientResponse(code < 400, out, body)

    def close(self) -> None:
        if self._channel is not None:
            self._channel.close()
            self._channel = None
        if self._session is not None:
            self._session.close()
            self._session = None


class RawFrameClient:
    """Keep-alive client for the C++ front server's binary fast lane.

    Speaks the SRT1 raw-tensor frame protocol over plain HTTP/1.1
    keep-alive sockets (the C++ lane with no per-request Python on the
    server).  One instance = one persistent
    connection; it is NOT thread-safe (create one per thread, like a
    socket).  For full SeldonMessage semantics (meta, status, graphs
    beyond the single-model fast path) use SeldonTpuClient; this client
    trades generality for the lowest possible per-request overhead.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 8000,
                 path: str = "/api/v0.1/predictions", timeout_s: float = 30.0):
        self.host = host
        self.port = port
        self.path = path
        self.timeout_s = timeout_s
        self._sock = None
        self._buf = b""

    def _connect(self):
        sock = socket.create_connection((self.host, self.port), timeout=self.timeout_s)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    def predict(self, arr: np.ndarray) -> np.ndarray:
        """One round-trip: array in, array out (raises on FAILURE).

        Retry policy: the ONE transparently-retried case is a reused
        keep-alive socket the server closed while idle (send fails, or
        the peer closes before any response byte).  Timeouts and
        failures on fresh connections surface immediately — resending
        after a timeout would duplicate in-flight work on an already
        slow server.
        """
        frame = pack_raw_frame(np.asarray(arr))
        head = (
            f"POST {self.path} HTTP/1.1\r\nHost: {self.host}\r\n"
            "Content-Type: application/x-seldon-raw\r\n"
            f"Content-Length: {len(frame)}\r\n\r\n"
        ).encode()
        for attempt in (0, 1):
            fresh = self._sock is None
            if fresh:
                self._sock = self._connect()
                self._buf = b""
            try:
                self._sock.sendall(head + frame)
            except (ConnectionError, OSError) as e:
                # send failed: the server never received the full request,
                # so a resend cannot duplicate work — retry once when the
                # reused socket turned out to be idle-closed
                self.close()
                if attempt or fresh or not isinstance(
                    e, (BrokenPipeError, ConnectionResetError)
                ):
                    raise
                continue
            try:
                status, body, self._buf = read_http_response(
                    self._sock, self._buf, timeout_s=self.timeout_s
                )
                break
            except StaleConnection:
                # clean close before ANY response byte on a reused socket
                self.close()
                if attempt or fresh:
                    raise
            except (ConnectionError, OSError):
                # timeout / reset / mid-response close AFTER the server had
                # the request: it may have been processed — never resend
                self.close()
                raise
        if status >= 400:
            raise RuntimeError(f"front server returned {status}: {body[:200]!r}")
        return unpack_raw_frame(body)

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None
                self._buf = b""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
