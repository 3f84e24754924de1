"""ctypes bindings for the native C++ front server.

The C++ ingress (``native/frontserver.cc``) owns the HTTP/1.1 and h2c
gRPC hot path (accept, parse, payload decode, dynamic batching, response
serialisation) and calls back into Python once per coalesced *batch*
(the model call), or once per request on the fallback lane (full engine
semantics for what the fast lane cannot express).

Callback surfaces:

* ``model_fn(batch[rows, cols] f32|u8) -> [rows, out_dim]``: the fast
  lane, for ``CudaServer`` its ``raw_batch_call``.  The GIL is taken once
  per batch and released while the call waits on the batcher.  The
  server runs ``batch_threads`` workers, so ``model_fn`` must be
  thread-safe; concurrent calls keep several batches in flight.
* ``raw_handler(method, path, body) -> (status, content_type, body)``:
  the HTTP fallback lane, typically :class:`GatewayRawHandler`.
* ``grpc_handler(path, message) -> (grpc_status, grpc_message, reply)``:
  the unary gRPC fallback lane (``SendFeedback``, ``Predict`` with
  payloads the fast lane does not take, ``PredictRaw``).
* ``grpc_stream_handler(path, message, handle) -> int``: the
  server-streaming lane (``Seldon/GenerateStream``).  It accepts the
  stream and returns at once; a producer thread then sends each message
  with :meth:`NativeFrontServer.stream_push` and ends the stream with
  :meth:`NativeFrontServer.stream_close`, which it must always call.
"""

from __future__ import annotations

import ctypes
import json
import logging
import threading
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from seldon_core_tpu_torch.native import get_lib

logger = logging.getLogger(__name__)

_BATCH_CB = ctypes.CFUNCTYPE(
    ctypes.c_int32,
    ctypes.c_void_p,                  # ctx
    ctypes.c_void_p,                  # in ([rows*cols] of dtype)
    ctypes.c_int64,                   # rows
    ctypes.c_int64,                   # cols
    ctypes.c_int32,                   # dtype: 0=f32 1=u8
    ctypes.POINTER(ctypes.c_float),   # out
    ctypes.c_int64,                   # out_cols
)

_RAW_CB = ctypes.CFUNCTYPE(
    ctypes.c_int32,
    ctypes.c_void_p,                          # ctx
    ctypes.c_char_p,                          # method
    ctypes.c_char_p,                          # path
    ctypes.POINTER(ctypes.c_uint8),           # body
    ctypes.c_int64,                           # body_len
    ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),  # out_buf
    ctypes.POINTER(ctypes.c_int64),           # out_len
    ctypes.POINTER(ctypes.c_int32),           # http_status
    ctypes.POINTER(ctypes.c_char),            # content_type[64]: a writable
    # pointer (c_char_p would hand the callback an immutable copy)
)

_GRPC_CB = ctypes.CFUNCTYPE(
    ctypes.c_int32,
    ctypes.c_void_p,                          # ctx
    ctypes.c_char_p,                          # path
    ctypes.POINTER(ctypes.c_uint8),           # msg
    ctypes.c_int64,                           # msg_len
    ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),  # out_buf
    ctypes.POINTER(ctypes.c_int64),           # out_len
    ctypes.POINTER(ctypes.c_int32),           # grpc_status
    ctypes.POINTER(ctypes.c_char),            # grpc_msg[256] (writable)
)

_GRPC_STREAM_CB = ctypes.CFUNCTYPE(
    ctypes.c_int32,
    ctypes.c_void_p,                          # ctx
    ctypes.c_char_p,                          # path
    ctypes.POINTER(ctypes.c_uint8),           # msg
    ctypes.c_int64,                           # msg_len
    ctypes.c_uint64,                          # stream handle
)


class _FsConfig(ctypes.Structure):
    _fields_ = [
        ("port", ctypes.c_int32),
        ("max_batch", ctypes.c_int32),
        ("max_wait_us", ctypes.c_int32),
        ("feature_dim", ctypes.c_int32),
        ("out_dim", ctypes.c_int32),
        ("stub_mode", ctypes.c_int32),
        ("raw_workers", ctypes.c_int32),
        ("backlog", ctypes.c_int32),
        ("eager_when_idle", ctypes.c_int32),
        ("batch_threads", ctypes.c_int32),
        ("model_name", ctypes.c_char_p),
        ("names_csv", ctypes.c_char_p),
        ("buckets_csv", ctypes.c_char_p),
        ("bind_host", ctypes.c_char_p),
    ]


class _FsStats(ctypes.Structure):
    _fields_ = [
        ("requests", ctypes.c_int64),
        ("fast_requests", ctypes.c_int64),
        ("raw_requests", ctypes.c_int64),
        ("batches", ctypes.c_int64),
        ("rows", ctypes.c_int64),
        ("padded_rows", ctypes.c_int64),
        ("failures", ctypes.c_int64),
        ("connections", ctypes.c_int64),
        ("dropped_orphans", ctypes.c_int64),
    ]


def _bind(lib) -> None:
    """Declare the front server's symbols (idempotent)."""
    lib.fs_create.restype = ctypes.c_void_p
    lib.fs_create.argtypes = [ctypes.POINTER(_FsConfig)]
    lib.fs_destroy.argtypes = [ctypes.c_void_p]
    lib.fs_set_batch_handler.argtypes = [ctypes.c_void_p, _BATCH_CB, ctypes.c_void_p]
    lib.fs_set_raw_handler.argtypes = [ctypes.c_void_p, _RAW_CB, ctypes.c_void_p]
    lib.fs_set_grpc_handler.argtypes = [ctypes.c_void_p, _GRPC_CB, ctypes.c_void_p]
    lib.fs_set_grpc_stream_handler.argtypes = [ctypes.c_void_p, _GRPC_STREAM_CB, ctypes.c_void_p]
    lib.fs_stream_push.restype = ctypes.c_int64
    lib.fs_stream_push.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
    lib.fs_stream_close.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int32, ctypes.c_char_p]
    lib.fs_start.restype = ctypes.c_int32
    lib.fs_start.argtypes = [ctypes.c_void_p]
    lib.fs_stop.argtypes = [ctypes.c_void_p]
    lib.fs_port.restype = ctypes.c_int32
    lib.fs_port.argtypes = [ctypes.c_void_p]
    lib.fs_set_ready.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.fs_get_stats.argtypes = [ctypes.c_void_p, ctypes.POINTER(_FsStats)]
    lib.fs_alloc.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.fs_alloc.argtypes = [ctypes.c_int64]


def available() -> bool:
    lib = get_lib()
    return lib is not None and hasattr(lib, "fs_create")


RawHandler = Callable[[str, str, bytes], Tuple[int, str, bytes]]
# (path, request message bytes) -> (grpc_status, grpc_message, reply bytes)
GrpcHandler = Callable[[str, bytes], Tuple[int, str, bytes]]
# (path, request message bytes, stream handle) -> 0 once accepted
GrpcStreamHandler = Callable[[str, bytes, int], int]


class NativeFrontServer:
    """The C++ data-plane ingress, driven from Python.

    Stub mode (``model_fn=None, stub=True``) serves a fixed-output model
    entirely in C++, to measure the serving plane alone."""

    def __init__(
        self,
        port: int = 0,
        model_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
        feature_dim: int = 0,
        out_dim: int = 3,
        stub: bool = False,
        max_batch: int = 64,
        max_wait_ms: float = 1.0,
        model_name: str = "model",
        names: Optional[Sequence[str]] = None,
        raw_handler: Optional[RawHandler] = None,
        grpc_handler: Optional[GrpcHandler] = None,
        grpc_stream_handler: Optional[GrpcStreamHandler] = None,
        raw_workers: int = 2,
        buckets: Optional[Sequence[int]] = None,
        host: str = "0.0.0.0",
        batch_threads: int = 4,
    ):
        lib = get_lib()
        if lib is None or not hasattr(lib, "fs_create"):
            raise RuntimeError(
                "native front server library unavailable: it is built from native/*.cc with g++ "
                "(see the log for the build error)"
            )
        _bind(lib)
        self._lib = lib
        self.model_fn = model_fn
        self.raw_handler = raw_handler
        self.grpc_handler = grpc_handler
        self.grpc_stream_handler = grpc_stream_handler
        cfg = _FsConfig(
            port=port,
            max_batch=max_batch,
            max_wait_us=int(max_wait_ms * 1000),
            feature_dim=feature_dim,
            out_dim=out_dim,
            stub_mode=1 if (stub and model_fn is None) else 0,
            raw_workers=raw_workers,
            backlog=512,
            # an idle server dispatches a request at once: the model call in
            # flight is the coalescing window, max_wait only bounds a queue
            eager_when_idle=1,
            batch_threads=batch_threads,
            model_name=model_name.encode(),
            names_csv=",".join(names).encode() if names else b"",
            buckets_csv=",".join(str(int(b)) for b in buckets).encode() if buckets else b"",
            bind_host=host.encode(),
        )
        self._cfg = cfg  # keeps the char pointers alive
        self._handle = lib.fs_create(ctypes.byref(cfg))
        # the CFUNCTYPE objects must outlive the server: C++ holds their pointers
        self._batch_cb = self._raw_cb = self._grpc_cb = self._grpc_stream_cb = None
        if model_fn is not None:
            self._batch_cb = _BATCH_CB(self._on_batch)
            lib.fs_set_batch_handler(self._handle, self._batch_cb, None)
        if raw_handler is not None:
            self._raw_cb = _RAW_CB(self._on_raw)
            lib.fs_set_raw_handler(self._handle, self._raw_cb, None)
        if grpc_handler is not None:
            self._grpc_cb = _GRPC_CB(self._on_grpc)
            lib.fs_set_grpc_handler(self._handle, self._grpc_cb, None)
        if grpc_stream_handler is not None:
            self._grpc_stream_cb = _GRPC_STREAM_CB(self._on_grpc_stream)
            lib.fs_set_grpc_stream_handler(self._handle, self._grpc_stream_cb, None)
        self.port = 0
        # serialises stop() against set_ready() / stats(): the C++ object
        # must not be destroyed while another thread is inside a call
        self._handle_lock = threading.Lock()

    # ------------------------------------------------------------ callbacks

    def _on_batch(self, _ctx, in_ptr, rows, cols, dtype, out_ptr, out_cols) -> int:
        try:
            # a dtype-keeping VIEW of the C++ batch buffer: uint8 images
            # reach the model as uint8.  C++ frees it when this returns;
            # model_fn returns only after the batcher has copied it
            ctype = ctypes.c_uint8 if dtype == 1 else ctypes.c_float
            typed = ctypes.cast(in_ptr, ctypes.POINTER(ctype))
            batch = np.ctypeslib.as_array(typed, shape=(rows, cols))
            result = np.asarray(self.model_fn(batch), dtype=np.float32)
            if result.ndim == 1:
                result = result[:, None]
            out = np.ctypeslib.as_array(out_ptr, shape=(rows, out_cols))
            out[:] = result.reshape(rows, out_cols)
            return 0
        except Exception:  # noqa: BLE001 — a raised callback would abort the C++ worker
            logger.exception("native front server batch callback failed")
            return 1

    def _reply(self, payload: bytes, out_buf, out_len) -> None:
        """Hand ``payload`` to C++ in an ``fs_alloc`` buffer it frees."""
        buf = self._lib.fs_alloc(len(payload))
        if payload:
            ctypes.memmove(buf, payload, len(payload))
        out_buf[0] = buf
        out_len[0] = len(payload)

    def _on_raw(self, _ctx, method, path, body_ptr, body_len, out_buf, out_len,
                status_ptr, ctype_buf) -> int:
        try:
            body = ctypes.string_at(body_ptr, body_len) if body_len else b""
            status, content_type, payload = self.raw_handler(method.decode(), path.decode(), body)
            self._reply(payload, out_buf, out_len)
            status_ptr[0] = int(status)
            ct = content_type.encode()[:63]
            ctypes.memmove(ctype_buf, ct + b"\x00", len(ct) + 1)
            return 0
        except Exception:  # noqa: BLE001 — a raised callback would abort the C++ worker
            logger.exception("native front server raw callback failed")
            return 1

    def _on_grpc(self, _ctx, path, msg_ptr, msg_len, out_buf, out_len, status_ptr, msg_buf) -> int:
        try:
            body = ctypes.string_at(msg_ptr, msg_len) if msg_len else b""
            status, message, payload = self.grpc_handler(path.decode(), body)
            self._reply(payload, out_buf, out_len)
            status_ptr[0] = int(status)
            m = message.encode()[:255]
            ctypes.memmove(msg_buf, m + b"\x00", len(m) + 1)
            return 0
        except Exception:  # noqa: BLE001 — a raised callback would abort the C++ worker
            logger.exception("native front server grpc callback failed")
            return 1

    def _on_grpc_stream(self, _ctx, path, msg_ptr, msg_len, handle) -> int:
        try:
            body = ctypes.string_at(msg_ptr, msg_len) if msg_len else b""
            return int(self.grpc_stream_handler(path.decode(), body, int(handle)))
        except Exception:  # noqa: BLE001 — a raised callback would abort the C++ worker
            logger.exception("native front server grpc stream callback failed")
            return 1

    # ------------------------------------------------------------ streams

    def stream_push(self, handle: int, payload: bytes) -> int:
        """Queue one gRPC message on an open server stream: 0, or -1 once
        the stream is dead (the client went away): the producer stops."""
        with self._handle_lock:
            if not self._handle:
                return -1
            buf = (ctypes.c_uint8 * len(payload)).from_buffer_copy(payload)
            return int(self._lib.fs_stream_push(self._handle, ctypes.c_uint64(handle), buf, len(payload)))

    def stream_close(self, handle: int, grpc_status: int = 0, grpc_message: str = "") -> None:
        """End a server stream with its grpc-status.  Always called, dead
        stream or not: the close releases the C++ handle and the
        connection's in-flight count."""
        with self._handle_lock:
            if self._handle:
                self._lib.fs_stream_close(self._handle, ctypes.c_uint64(handle), ctypes.c_int32(grpc_status),
                                          grpc_message.encode()[:255])

    # ------------------------------------------------------------ lifecycle

    def start(self) -> int:
        rc = self._lib.fs_start(self._handle)
        if rc < 0:
            raise OSError(-rc, "front server failed to start")
        self.port = rc
        return self.port

    def stop(self) -> None:
        with self._handle_lock:
            handle, self._handle = self._handle, None
            if handle:
                self._lib.fs_stop(handle)
                self._lib.fs_destroy(handle)

    def set_ready(self, ready: bool) -> None:
        with self._handle_lock:
            if self._handle:
                self._lib.fs_set_ready(self._handle, 1 if ready else 0)

    def stats(self) -> dict:
        s = _FsStats()
        with self._handle_lock:
            if self._handle:
                self._lib.fs_get_stats(self._handle, ctypes.byref(s))
        return {name: getattr(s, name) for name, _ in _FsStats._fields_}

    def __enter__(self) -> "NativeFrontServer":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


def _failure(code: int, info: str, reason: str) -> Tuple[int, str, bytes]:
    return code, "application/json", json.dumps(
        {"status": {"status": "FAILURE", "code": code, "info": info, "reason": reason}}
    ).encode()


class GatewayRawHandler:
    """The HTTP fallback lane with full engine semantics: bridges the C++
    server's raw lane into a running Gateway's asyncio loop (JSON
    predictions, feedback, explanations, pause / unpause, SRT1 frames
    the fast lane does not take)."""

    # request targets of the buffer-view (SRT1) lane
    _PREDICT_PATHS = ("/api/v0.1/predictions", "/api/v1.0/predictions", "/predict")

    def __init__(self, gateway, loop):
        self.gateway = gateway
        self.loop = loop

    @staticmethod
    def _payload(body: bytes, query: dict) -> dict:
        """JSON body, else a ``?json=`` query field (the gateway REST app's
        ``runtime/rest._request_body``); ValueError answers 400."""
        if body:
            return json.loads(body)
        if "json" in query:
            return json.loads(query["json"][0])
        raise ValueError("empty request body")

    def _bridge(self, coro):
        import asyncio

        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout=60)

    def _frame_lane_service(self, predictor):
        """The predictor eligible for the loop-free frame paths, or None
        (shadows, traffic splits and named-predictor routing keep full
        gateway semantics)."""
        if predictor is None and len(self.gateway.entries) == 1 and not self.gateway.shadows:
            return self.gateway.entries[0][0]
        return None

    def _predict_raw_frame(self, body: bytes, predictor) -> Tuple[int, str, bytes]:
        """The zero-copy lane: an SRT1 frame decodes to a
        :class:`~seldon_core_tpu_torch.codec.BufferView` over the ingress
        bytes (no JSON or proto parse), rides the engine as a
        by-reference payload, and the answer leaves as an SRT1 frame.
        Errors keep the JSON status shape.

        A MULTI-frame container (``pack_frames``) is the batched
        submission: the whole container goes through ``raw_batch_views``
        as ONE micro-batch, bypassing per-request engine bookkeeping as
        the C++ fast lane does, so it is served only for a single
        in-process MODEL; the reply is the answer container."""
        from seldon_core_tpu_torch import codec
        from seldon_core_tpu_torch.engine.server import _http_status
        from seldon_core_tpu_torch.runtime.message import InternalMessage

        views = codec.unpack_frames(body)
        svc = self._frame_lane_service(predictor)
        fast = svc.single_local_model() if svc is not None else None
        if len(views) > 1:
            raw_views = getattr(fast[1], "raw_batch_views", None) if fast else None
            if raw_views is None:
                return _failure(400, "multi-frame containers need a single-local-MODEL predictor with "
                                     "raw_batch_views; send one frame per request", "BAD_REQUEST")
            return 200, "application/x-seldon-raw", codec.pack_frames(raw_views(views))
        msg = InternalMessage(payload=views[0], kind="rawTensor")
        if fast is not None:
            # one in-process MODEL: run it on this C++ worker thread
            # (predict_sync), so the frame never crosses the event loop
            out = self.gateway.finalize_response(svc.predict_sync(msg), msg, svc)
        else:
            out = self._bridge(self.gateway.predict(msg, predictor=predictor))
        status = _http_status(out)
        payload = out.host_payload()
        if status < 400 and payload is not None and not isinstance(payload, (bytes, str, dict)):
            try:
                return status, "application/x-seldon-raw", codec.pack_frame(np.asarray(payload))
            except codec.PayloadError:
                pass  # a healthy answer with no SRT1 code (strings): the JSON reply below
        return status, "application/json", json.dumps(out.to_json()).encode()

    def __call__(self, method: str, path: str, body: bytes) -> Tuple[int, str, bytes]:
        from urllib.parse import parse_qs, urlsplit

        from seldon_core_tpu_torch.codec import zero_copy_enabled
        from seldon_core_tpu_torch.engine.server import _http_status
        from seldon_core_tpu_torch.runtime.message import InternalFeedback, InternalMessage

        try:
            # C++ forwards the full target; '?predictor=NAME' routes
            split = urlsplit(path)
            path = split.path
            query = parse_qs(split.query)
            predictor = (query.get("predictor") or [None])[0]
            if method == "POST" and path in self._PREDICT_PATHS and body[:4] == b"SRT1":
                if zero_copy_enabled():
                    return self._predict_raw_frame(body, predictor)
                # lane off: refuse the frame as the JSON parser would, naming the remedy
                return _failure(400, "SRT1 frame received but SELDON_TPU_ZERO_COPY=0 — send a JSON "
                                     "SeldonMessage", "BAD_REQUEST")
            if path in ("/pause", "/unpause") and method in ("POST", "PUT"):
                (self.gateway.pause if path == "/pause" else self.gateway.unpause)()
                return 200, "text/plain", (path[1:] + "d").encode()
            if path in self._PREDICT_PATHS:
                msg = InternalMessage.from_json(self._payload(body, query))
                out = self._bridge(self.gateway.predict(msg, predictor=predictor))
            elif path == "/api/v0.1/feedback":
                fb = InternalFeedback.from_json(self._payload(body, query))
                out = self._bridge(self.gateway.send_feedback(fb))
            elif path == "/api/v0.1/explanations":
                msg = InternalMessage.from_json(self._payload(body, query))
                svc = (self.gateway.by_name(predictor) if predictor else None) or self.gateway.pick()
                out = self._bridge(svc.explain(msg))
            else:
                return _failure(404, f"no route {path}", "NOT_FOUND")
            return _http_status(out), "application/json", json.dumps(out.to_json()).encode()
        except (ValueError, KeyError, TypeError) as e:  # PayloadError is a ValueError
            return _failure(400, str(e), "BAD_REQUEST")  # bad payloads are the client's fault
        except Exception as e:  # noqa: BLE001 — wire errors as seldon status
            logger.exception("gateway raw handler failed")
            return _failure(500, str(e), "ENGINE_ERROR")


def build_http_blob(path: str, body: bytes, content_type: str = "application/json") -> bytes:
    """A complete keep-alive HTTP/1.1 POST of ``body`` (for :func:`native_load`)."""
    head = (f"POST {path} HTTP/1.1\r\nHost: localhost\r\nContent-Type: {content_type}\r\n"
            f"Content-Length: {len(body)}\r\n\r\n")
    return head.encode() + body


def _load_result(ok: int, non2xx: ctypes.c_int64, errors: ctypes.c_int64, seconds: float) -> dict:
    return {"qps": ok / seconds, "ok": int(ok), "non2xx": int(non2xx.value), "errors": int(errors.value)}


def native_load(port: int, payload: bytes, seconds: float = 5.0, connections: int = 8,
                depth: int = 8) -> Optional[dict]:
    """Closed-loop HTTP/1.1 load from the C++ epoll client
    (``native/loadgen.cc``): ``payload`` is a complete request blob sent
    over ``connections`` keep-alive loopback sockets with ``depth``
    requests in flight each.  Returns ``{qps, ok, non2xx, errors}`` (2xx
    answers count as ok; their bodies are not read), or None without the
    library."""
    if seconds <= 0:
        raise ValueError(f"seconds must be positive, got {seconds}")
    lib = get_lib()
    if lib is None:
        return None
    lib.lg_run.restype = ctypes.c_int64
    lib.lg_run.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_double,
        ctypes.c_int32, ctypes.c_int32, ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
    ]
    non2xx, errors = ctypes.c_int64(0), ctypes.c_int64(0)
    ok = lib.lg_run(payload, len(payload), int(port), float(seconds), int(connections), int(depth),
                    ctypes.byref(non2xx), ctypes.byref(errors))
    return _load_result(ok, non2xx, errors, seconds)


def build_grpc_request_parts(path: str, proto_bytes: bytes, authority: str = "localhost") -> Tuple[bytes, bytes]:
    """(HPACK header block, gRPC-framed DATA payload) for the h2c load
    client: static indexes for ``:method POST`` / ``:scheme http``, the
    rest as never-indexed literals (the subset the C++ decoder takes
    without state)."""

    def lit(name: bytes, value: bytes) -> bytes:
        def ln(n: int) -> bytes:
            if n < 127:
                return bytes([n])
            out = bytearray([127])
            v = n - 127
            while v >= 128:
                out.append(0x80 | (v & 0x7F))
                v >>= 7
            out.append(v)
            return bytes(out)

        return b"\x10" + ln(len(name)) + name + ln(len(value)) + value

    block = (
        b"\x83"  # :method POST (static 3)
        + b"\x86"  # :scheme http (static 6)
        + lit(b":path", path.encode())
        + lit(b":authority", authority.encode())
        + lit(b"content-type", b"application/grpc")
        + lit(b"te", b"trailers")
    )
    data = b"\x00" + len(proto_bytes).to_bytes(4, "big") + proto_bytes
    return block, data


def native_load_grpc(port: int, path: str, proto_bytes: bytes, seconds: float = 5.0, connections: int = 8,
                     depth: int = 8) -> Optional[dict]:
    """Closed-loop h2c gRPC load from the C++ client: the counterpart of
    :func:`native_load` (answers with grpc-status 0 count as ok)."""
    if seconds <= 0:
        raise ValueError(f"seconds must be positive, got {seconds}")
    lib = get_lib()
    if lib is None:
        return None
    lib.lg_run_h2.restype = ctypes.c_int64
    lib.lg_run_h2.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_double, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
    ]
    block, data = build_grpc_request_parts(path, proto_bytes)
    non2xx, errors = ctypes.c_int64(0), ctypes.c_int64(0)
    ok = lib.lg_run_h2(block, len(block), data, len(data), int(port), float(seconds), int(connections),
                       int(depth), ctypes.byref(non2xx), ctypes.byref(errors))
    return _load_result(ok, non2xx, errors, seconds)


class StaleConnection(ConnectionError):
    """A reused keep-alive socket was closed by the peer before any
    response byte: the one case a client may retry."""


def read_http_response(sock, buf: bytes, timeout_s: Optional[float] = None):
    """Blocking HTTP/1.1 response read on a keep-alive socket.

    Returns (status_code, body, remaining_buffer).  Raises
    :class:`StaleConnection` when the peer closed (FIN or RST) before
    any byte arrived, ``ConnectionError`` on a close mid-response."""
    if timeout_s is not None:
        sock.settimeout(timeout_s)
    got_any = bool(buf)

    def _recv():
        nonlocal got_any
        try:
            chunk = sock.recv(65536)
        except ConnectionResetError as e:
            if not got_any:
                raise StaleConnection("peer reset an idle keep-alive socket") from e
            raise ConnectionError("server reset mid-response") from e
        if chunk:
            got_any = True
        return chunk

    while b"\r\n\r\n" not in buf:
        chunk = _recv()
        if not chunk:
            if not got_any:
                raise StaleConnection("peer closed an idle keep-alive socket")
            raise ConnectionError("server closed mid-response")
        buf += chunk
    headers, _, rest = buf.partition(b"\r\n\r\n")
    status = int(headers.split(b" ", 2)[1])
    length = None
    for line in headers.split(b"\r\n"):
        if line.lower().startswith(b"content-length"):
            length = int(line.split(b":")[1])
            break
    if length is None:
        raise ConnectionError("response carries no Content-Length")
    while len(rest) < length:
        chunk = _recv()
        if not chunk:
            raise ConnectionError("server closed mid-body")
        rest += chunk
    return status, rest[:length], rest[length:]
