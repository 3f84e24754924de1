"""Node transports: how the orchestrator invokes one graph node.

Three client kinds behind one async interface:

* ``LocalClient`` — the node's component lives in this process; methods
  are direct dispatch calls (run on a worker thread so model compute
  never blocks the event loop; CUDA calls release the GIL).  A graph
  edge between co-located nodes costs a function call, with no codec.
* ``GrpcClient`` — remote node over gRPC with per-endpoint cached
  channels and per-call deadlines
  (reference: GrpcChannelHandler.java:21-39,
  InternalPredictionService.java:294-340).
* ``RestClient`` — remote node over REST/JSON with connect/read timeouts
  (reference: InternalPredictionService.java:80-98, 439-467).

Both remote clients retry transient faults within a bounded attempt
budget with full-jitter backoff (:func:`backoff_s`), never retry
``send_feedback`` (not idempotent), and report every attempt on the
raised error.

Every hop carries the request's contract: it fast-fails with 504
``DEADLINE_EXCEEDED`` when the end-to-end budget is spent (before the
first attempt and before each retry), re-injects the remaining budget
per attempt (``X-Seldon-Deadline-Ms`` / ``x-seldon-deadline-ms``, and
the native gRPC deadline clamped to it), and propagates the active span
as W3C ``traceparent`` / ``tracestate`` (headers, metadata, or
``meta.traceContext`` on the local lane).  Each call is metered as one
hop (``_Hop``): the ``seldon_tpu_transport_*`` series and tags on the
node span.  Not ported (``ROADMAP.md`` §A item 2.2): circuit breakers,
hedging, replica balancing.
"""

from __future__ import annotations

import asyncio
import json
import logging
import random
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional

from seldon_core_tpu_torch.engine.graph import MODEL, UnitSpec
from seldon_core_tpu_torch.runtime import dispatch
from seldon_core_tpu_torch.runtime.component import MicroserviceError
from seldon_core_tpu_torch.runtime.executor_pool import run_dispatch
from seldon_core_tpu_torch.runtime.message import InternalFeedback, InternalMessage
from seldon_core_tpu_torch.utils import deadlines as _deadlines
from seldon_core_tpu_torch.utils import metrics as _metrics
from seldon_core_tpu_torch.utils import tracing as _tracing

logger = logging.getLogger(__name__)


class _Hop:
    """Meters one NodeClient call: in-flight gauge around the await,
    codec-vs-network wall split, byte counts, retry count.  ``finish``
    folds it into the ``seldon_tpu_transport_*`` series and tags the
    enclosing (node) span.  Cheap to construct when telemetry is off."""

    __slots__ = ("unit", "method", "transport", "t0", "serialize_s", "request_bytes", "response_bytes",
                 "zero_copy_bytes", "retries", "_gauge")

    def __init__(self, unit: str, method: str, transport: str):
        self.unit, self.method, self.transport = unit, method, transport
        self.serialize_s = 0.0
        self.request_bytes = 0
        self.response_bytes = 0
        # bytes passed BY REFERENCE (buffer views, device tensors on the
        # local lane) against request/response_bytes, which a wire codec
        # copied: the zero-copy-vs-copied split
        self.zero_copy_bytes = 0
        self.retries = 0
        self._gauge = _metrics.transport_inflight(unit, method, transport)
        if self._gauge is not None:
            self._gauge.inc()
        self.t0 = time.perf_counter()

    @contextmanager
    def codec(self):
        """Time one encode / decode section (the serialisation share)."""
        t = time.perf_counter()
        try:
            yield
        finally:
            self.serialize_s += time.perf_counter() - t

    def finish(self, error: bool = False) -> None:
        total = time.perf_counter() - self.t0
        if self._gauge is not None:
            self._gauge.dec()
        network_s = max(0.0, total - self.serialize_s)
        _metrics.record_transport_hop(
            self.unit, self.method, self.transport,
            request_bytes=self.request_bytes, response_bytes=self.response_bytes,
            zero_copy_bytes=self.zero_copy_bytes, serialize_seconds=self.serialize_s,
            network_seconds=network_s, retries=self.retries, error=error,
        )
        span = _tracing.current_span()
        if span is not None and not span.remote:
            span.tags["transport"] = self.transport
            if self.transport != "local":
                span.tags["request_bytes"] = self.request_bytes
                span.tags["response_bytes"] = self.response_bytes
                span.tags["serialize_ms"] = round(self.serialize_s * 1000.0, 3)
                span.tags["network_ms"] = round(network_s * 1000.0, 3)
            if self.zero_copy_bytes:
                span.tags["zero_copy_bytes"] = self.zero_copy_bytes
            if self.retries:
                span.tags["retries"] = self.retries
            if error:
                span.tags["error"] = True


def backoff_s(attempt: int, base_s: float = 0.05, cap_s: float = 2.0) -> float:
    """Full-jitter exponential backoff for attempt ``attempt`` (0-based
    retry index): uniform over [0, min(cap, base * 2^attempt)].
    Deterministic backoff synchronises callers: every client that saw
    the same failure retries at the same instant."""
    return random.uniform(0.0, min(cap_s, base_s * (2 ** max(0, attempt))))


class NodeClient:
    """Async invocation surface for one graph node."""

    async def transform_input(self, msg: InternalMessage) -> InternalMessage:
        raise NotImplementedError

    async def transform_output(self, msg: InternalMessage) -> InternalMessage:
        raise NotImplementedError

    async def route(self, msg: InternalMessage) -> InternalMessage:
        raise NotImplementedError

    async def aggregate(self, msgs: List[InternalMessage]) -> InternalMessage:
        raise NotImplementedError

    async def send_feedback(self, feedback: InternalFeedback) -> InternalMessage:
        raise NotImplementedError

    async def ready(self) -> bool:
        return True

    async def close(self) -> None:
        pass


class LocalClient(NodeClient):
    """In-process node: direct dispatch, device tensors pass by handle.

    The tracing hop still exists: the caller's span context reaches the
    dispatch both through contextvars (``run_dispatch`` copies them onto
    the pool thread) and in ``meta.trace_context``, the in-memory lane of
    the contract the remote clients put on the wire."""

    def __init__(self, unit: UnitSpec, component: Any):
        self.unit = unit
        self.component = component

    @staticmethod
    def _inject_meta(msg: Any) -> None:
        first = msg[0] if isinstance(msg, list) and msg else msg
        meta = getattr(first, "meta", None) or getattr(getattr(first, "request", None), "meta", None)
        if meta is not None:
            _tracing.inject(meta.trace_context)

    @staticmethod
    def _ref_bytes(msg: Any) -> int:
        """Payload bytes this hop passes BY REFERENCE: buffer views and
        device tensors cross the local lane as handles, never through a
        codec."""
        from seldon_core_tpu_torch.codec import BufferView, is_device_array

        total = 0
        for m in (msg if isinstance(msg, list) else [msg]):
            payload = getattr(m, "payload", None)
            if isinstance(payload, BufferView) or is_device_array(payload):
                total += int(getattr(payload, "nbytes", 0) or 0)
        return total

    async def _invoke(self, method: str, call: Callable[[], Any], msg: Any) -> InternalMessage:
        # a spent budget fails before dispatch: the model must never see
        # a request its caller has already abandoned
        _deadlines.check(f"node {self.unit.name!r} {method} (local)")
        self._inject_meta(msg)
        hop = _Hop(self.unit.name, method, "local")
        if hop._gauge is not None and not isinstance(msg, InternalFeedback):
            # the walk runs only with telemetry on (the gauge exists)
            hop.zero_copy_bytes = self._ref_bytes(msg)
        ok = False
        try:
            out = await call()
            ok = True
            return out
        finally:
            hop.finish(error=not ok)

    async def transform_input(self, msg: InternalMessage) -> InternalMessage:
        # A MODEL node's input transform IS its predict
        # (reference: InternalPredictionService.java transformInput routing).
        if self.unit.type == MODEL:
            return await self._invoke("predict", lambda: dispatch.predict_async(self.component, msg), msg)
        return await self._invoke(
            "transform_input", lambda: run_dispatch(dispatch.transform_input, self.component, msg), msg)

    async def transform_output(self, msg: InternalMessage) -> InternalMessage:
        return await self._invoke(
            "transform_output", lambda: run_dispatch(dispatch.transform_output, self.component, msg), msg)

    async def route(self, msg: InternalMessage) -> InternalMessage:
        return await self._invoke("route", lambda: run_dispatch(dispatch.route, self.component, msg), msg)

    async def aggregate(self, msgs: List[InternalMessage]) -> InternalMessage:
        return await self._invoke("aggregate", lambda: run_dispatch(dispatch.aggregate, self.component, msgs), msgs)

    async def send_feedback(self, feedback: InternalFeedback) -> InternalMessage:
        return await self._invoke(
            "send_feedback",
            lambda: run_dispatch(dispatch.send_feedback, self.component, feedback, self.unit.name), feedback)


_METHOD_TO_SERVICE = {
    # method -> (service, rpc)
    "predict": ("Model", "Predict"),
    "transform_input": ("Transformer", "TransformInput"),
    "transform_output": ("OutputTransformer", "TransformOutput"),
    "route": ("Router", "Route"),
    "aggregate": ("Combiner", "Aggregate"),
    "send_feedback": ("Model", "SendFeedback"),
}


def _grpc_status_name(e: Exception) -> Optional[str]:
    """The status-code name of a grpc error, or None for non-grpc."""
    code = getattr(e, "code", None)
    try:
        got = code() if callable(code) else code
        return got.name if got is not None else None
    except Exception:  # noqa: BLE001 — anything weird is "not grpc"
        return None


def _grpc_retryable(e: Exception) -> bool:
    """Transient statuses worth another attempt within the call budget
    (the reference's RestTemplate retries the analogous REST faults)."""
    return _grpc_status_name(e) in ("UNAVAILABLE", "DEADLINE_EXCEEDED", "RESOURCE_EXHAUSTED")


def _attempt(attempt: int, status: str, t_attempt: float) -> Dict[str, Any]:
    return {"attempt": attempt + 1, "status": status,
            "elapsed_ms": round((time.perf_counter() - t_attempt) * 1000.0, 3)}


class GrpcClient(NodeClient):
    """Remote node over gRPC (channel cached per endpoint), with
    bounded retries on transient statuses.  An exhausted call raises a
    ``MicroserviceError`` carrying the full per-attempt history (status
    code + elapsed per attempt) on ``.attempts`` and in the message."""

    _channels: Dict[str, Any] = {}
    # strong refs to the deferred channel-close tasks: the event loop
    # holds tasks only weakly
    _closers: set = set()

    def __init__(self, unit: UnitSpec, deadline_s: float = 5.0, retries: int = 3):
        if unit.endpoint is None:
            raise ValueError(f"GrpcClient for {unit.name!r} needs an endpoint")
        self.unit = unit
        self.addr = f"{unit.endpoint.host}:{unit.endpoint.port}"
        self.deadline_s = deadline_s
        self.retries = max(1, int(retries))

    def _channel(self):
        import grpc

        from seldon_core_tpu_torch.runtime.grpc_server import message_size_options

        chan = GrpcClient._channels.get(self.addr)
        if chan is None:
            # local subchannel pool: without it grpc-core shares
            # subchannels globally per target, so the fresh channel
            # _reset_channel creates would inherit the old, backed-off
            # subchannel and keep failing fast
            chan = grpc.aio.insecure_channel(
                self.addr, options=[("grpc.use_local_subchannel_pool", 1), *message_size_options()]
            )
            GrpcClient._channels[self.addr] = chan
        return chan

    async def _reset_channel(self) -> None:
        """Drop the cached channel after UNAVAILABLE: a channel whose
        subchannel is in reconnect backoff fails new RPCs fast without
        attempting a connection, so a retry on it would keep failing for
        the whole backoff window.  The old channel is closed one deadline
        later: closing it at once would cancel every sibling RPC still
        in flight on it."""
        chan = GrpcClient._channels.pop(self.addr, None)
        if chan is None:
            return

        async def close_later(delay: float) -> None:
            await asyncio.sleep(delay)
            try:
                await chan.close()
            except Exception as e:  # noqa: BLE001 — best-effort channel cleanup
                logger.debug("closing backed-off channel failed: %s", e)

        task = asyncio.ensure_future(close_later(self.deadline_s + 1.0))
        GrpcClient._closers.add(task)
        task.add_done_callback(GrpcClient._closers.discard)

    async def _call(self, method: str, build: Callable[[], Any], service_override: Optional[str] = None,
                    idempotent: bool = True) -> InternalMessage:
        from seldon_core_tpu_torch.proto import services

        service, rpc = _METHOD_TO_SERVICE[method]
        if service_override:
            service = service_override
        _deadlines.check(f"node {self.unit.name!r} {method} (grpc {self.addr})")
        hop = _Hop(self.unit.name, method, "grpc")
        ok = False
        try:
            with hop.codec():
                request_proto = build()
                hop.request_bytes = request_proto.ByteSize()
            base_metadata = _tracing.inject_metadata()
            attempts: List[Dict[str, Any]] = []
            last: Optional[Exception] = None
            budget = self.retries if idempotent else 1
            for attempt in range(budget):
                if attempt:
                    hop.retries += 1
                    # retries respect the end-to-end budget too
                    _deadlines.check(f"node {self.unit.name!r} {method} retry {attempt + 1} (grpc {self.addr})")
                # re-inject per attempt: the remaining budget shrank by
                # what the failed attempt burned
                metadata = _deadlines.inject_metadata(list(base_metadata))
                # the native gRPC deadline, clamped to the remaining budget
                timeout_s = self.deadline_s
                ambient = _deadlines.current_deadline()
                if ambient is not None:
                    timeout_s = max(0.001, min(timeout_s, ambient.remaining_s()))
                callable_ = services.unary_callable(self._channel(), service, rpc)
                t_attempt = time.perf_counter()
                try:
                    resp = await callable_(request_proto, timeout=timeout_s, metadata=metadata)
                    hop.response_bytes = resp.ByteSize()
                    with hop.codec():
                        out = InternalMessage.from_proto(resp)
                    ok = True
                    return out
                except Exception as e:  # noqa: BLE001 — grpc.aio.AioRpcError and friends
                    last = e
                    attempts.append(_attempt(attempt, _grpc_status_name(e) or type(e).__name__, t_attempt))
                    if _grpc_status_name(e) == "UNAVAILABLE":
                        # fresh channel for the next attempt (or the next call)
                        await self._reset_channel()
                    if not _grpc_retryable(e) or attempt + 1 >= budget:
                        break
                    logger.warning("gRPC %s to %s attempt %d/%d failed: %s", method, self.addr, attempt + 1,
                                   budget, e)
                    await asyncio.sleep(backoff_s(attempt))
            err = MicroserviceError(
                f"gRPC call {method} to {self.addr} failed: {last} (attempts: {json.dumps(attempts)})",
                status_code=502,
                reason="UPSTREAM_GRPC_ERROR",
            )
            err.attempts = attempts  # machine-readable per-attempt history
            raise err from last
        finally:
            hop.finish(error=not ok)

    async def transform_input(self, msg: InternalMessage) -> InternalMessage:
        method = "predict" if self.unit.type == MODEL else "transform_input"
        return await self._call(method, msg.to_proto)

    async def transform_output(self, msg: InternalMessage) -> InternalMessage:
        return await self._call("transform_output", msg.to_proto)

    async def route(self, msg: InternalMessage) -> InternalMessage:
        return await self._call("route", msg.to_proto)

    async def aggregate(self, msgs: List[InternalMessage]) -> InternalMessage:
        def build():
            from seldon_core_tpu_torch.proto import pb

            return pb.SeldonMessageList(seldonMessages=[m.to_proto() for m in msgs])

        return await self._call("aggregate", build)

    async def send_feedback(self, feedback: InternalFeedback) -> InternalMessage:
        # not idempotent: a deadline after the reward was applied must
        # not replay it
        service = "Router" if self.unit.type == "ROUTER" else "Model"
        return await self._call("send_feedback", feedback.to_proto, service_override=service, idempotent=False)

    async def ready(self) -> bool:
        try:
            await asyncio.wait_for(self._channel().channel_ready(), timeout=self.deadline_s)
            return True
        except Exception:  # noqa: BLE001 — any dial failure reads as not-ready
            return False

    async def close(self) -> None:
        chan = GrpcClient._channels.pop(self.addr, None)
        if chan is not None:
            await chan.close()


# HTTP statuses worth another attempt within the call budget: the
# upstream is overloaded or mid-restart, not wrong.  Everything else —
# 4xx, plain 500 — would fail identically on every attempt.
_REST_RETRYABLE_STATUSES = (502, 503, 504)


class RestClient(NodeClient):
    """Remote node over REST/JSON with bounded retries on transient
    faults, matching ``GrpcClient``'s semantics: full-jitter backoff,
    the full per-attempt history on ``MicroserviceError.attempts`` and
    in the message, and ``send_feedback`` never retried."""

    def __init__(self, unit: UnitSpec, connect_timeout_s: float = 2.0, read_timeout_s: float = 5.0,
                 retries: int = 3):
        if unit.endpoint is None:
            raise ValueError(f"RestClient for {unit.name!r} needs an endpoint")
        self.unit = unit
        self.base = f"http://{unit.endpoint.host}:{unit.endpoint.port}"
        self.connect_timeout_s = connect_timeout_s
        self.read_timeout_s = read_timeout_s
        self.retries = max(1, int(retries))
        self._session = None

    def _get_session(self):
        import aiohttp

        if self._session is None or self._session.closed:
            timeout = aiohttp.ClientTimeout(connect=self.connect_timeout_s, total=self.read_timeout_s)
            self._session = aiohttp.ClientSession(timeout=timeout)
        return self._session

    async def _post(self, path: str, method: str, encode: Callable[[], Dict[str, Any]],
                    idempotent: bool = True) -> InternalMessage:
        _deadlines.check(f"node {self.unit.name!r} {method} (rest {self.base})")
        hop = _Hop(self.unit.name, method, "rest")
        ok = False
        try:
            with hop.codec():
                data = json.dumps(encode()).encode()
                hop.request_bytes = len(data)
            base_headers = _tracing.inject({"Content-Type": "application/json"})
            attempts: List[Dict[str, Any]] = []
            last_err: Optional[Exception] = None
            budget = self.retries if idempotent else 1
            for attempt in range(budget):
                if attempt:
                    hop.retries += 1
                    _deadlines.check(f"node {self.unit.name!r} {method} retry {attempt + 1} (rest {self.base})")
                # re-inject per attempt: the remaining budget shrank by
                # what the failed attempt burned
                headers = _deadlines.inject(dict(base_headers))
                t_attempt = time.perf_counter()
                try:
                    async with self._get_session().post(self.base + path, data=data, headers=headers) as resp:
                        raw = await resp.read()
                        hop.response_bytes = len(raw)
                        with hop.codec():
                            payload = json.loads(raw)
                        if resp.status < 400:
                            with hop.codec():
                                out = InternalMessage.from_json(payload)
                            ok = True
                            return out
                        attempts.append(_attempt(attempt, str(resp.status), t_attempt))
                        err = MicroserviceError(
                            f"REST call {path} to {self.base} returned {resp.status}: {payload} "
                            f"(attempts: {json.dumps(attempts)})",
                            status_code=502,
                            reason="UPSTREAM_REST_ERROR",
                        )
                        if resp.status in _REST_RETRYABLE_STATUSES and attempt + 1 < budget:
                            last_err = err
                            logger.warning("REST %s to %s attempt %d/%d got %d, retrying",
                                           path, self.base, attempt + 1, budget, resp.status)
                            await asyncio.sleep(backoff_s(attempt))
                            continue
                        err.attempts = attempts
                        raise err
                except MicroserviceError:
                    raise
                except Exception as e:  # noqa: BLE001 — connection faults: transient by class
                    last_err = e
                    attempts.append(_attempt(attempt, type(e).__name__, t_attempt))
                    if attempt + 1 >= budget:
                        break
                    logger.warning("REST %s to %s attempt %d/%d failed: %s", path, self.base, attempt + 1,
                                   budget, e)
                    await asyncio.sleep(backoff_s(attempt))
            err = MicroserviceError(
                f"REST call {path} to {self.base} failed: {last_err} (attempts: {json.dumps(attempts)})",
                status_code=502,
                reason="UPSTREAM_REST_ERROR",
            )
            err.attempts = attempts  # machine-readable per-attempt history
            raise err from last_err
        finally:
            hop.finish(error=not ok)

    async def transform_input(self, msg: InternalMessage) -> InternalMessage:
        if self.unit.type == MODEL:
            return await self._post("/predict", "predict", msg.to_json)
        return await self._post("/transform-input", "transform_input", msg.to_json)

    async def transform_output(self, msg: InternalMessage) -> InternalMessage:
        return await self._post("/transform-output", "transform_output", msg.to_json)

    async def route(self, msg: InternalMessage) -> InternalMessage:
        return await self._post("/route", "route", msg.to_json)

    async def aggregate(self, msgs: List[InternalMessage]) -> InternalMessage:
        return await self._post("/aggregate", "aggregate", lambda: {"seldonMessages": [m.to_json() for m in msgs]})

    async def send_feedback(self, feedback: InternalFeedback) -> InternalMessage:
        # not idempotent: a timeout after the reward was applied must
        # not replay it
        return await self._post("/send-feedback", "send_feedback", feedback.to_json, idempotent=False)

    async def ready(self) -> bool:
        try:
            async with self._get_session().get(self.base + "/health/ping") as resp:
                return resp.status < 400
        except Exception:  # noqa: BLE001 — any probe failure reads as not-ready
            return False

    async def close(self) -> None:
        if self._session is not None and not self._session.closed:
            await self._session.close()
