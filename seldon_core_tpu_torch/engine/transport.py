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
raised error.  Not ported (``ROADMAP.md`` §A item 2.2): circuit
breakers, hedging, replica balancing; nor the per-hop telemetry, the
deadline budget and the trace context (§A item 4).
"""

from __future__ import annotations

import asyncio
import json
import logging
import random
import time
from typing import Any, Callable, Dict, List, Optional

from seldon_core_tpu_torch.engine.graph import MODEL, UnitSpec
from seldon_core_tpu_torch.runtime import dispatch
from seldon_core_tpu_torch.runtime.component import MicroserviceError
from seldon_core_tpu_torch.runtime.executor_pool import run_dispatch
from seldon_core_tpu_torch.runtime.message import InternalFeedback, InternalMessage

logger = logging.getLogger(__name__)


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
    """In-process node: direct dispatch, device tensors pass by handle."""

    def __init__(self, unit: UnitSpec, component: Any):
        self.unit = unit
        self.component = component

    async def transform_input(self, msg: InternalMessage) -> InternalMessage:
        # A MODEL node's input transform IS its predict
        # (reference: InternalPredictionService.java transformInput routing).
        if self.unit.type == MODEL:
            return await dispatch.predict_async(self.component, msg)
        return await run_dispatch(dispatch.transform_input, self.component, msg)

    async def transform_output(self, msg: InternalMessage) -> InternalMessage:
        return await run_dispatch(dispatch.transform_output, self.component, msg)

    async def route(self, msg: InternalMessage) -> InternalMessage:
        return await run_dispatch(dispatch.route, self.component, msg)

    async def aggregate(self, msgs: List[InternalMessage]) -> InternalMessage:
        return await run_dispatch(dispatch.aggregate, self.component, msgs)

    async def send_feedback(self, feedback: InternalFeedback) -> InternalMessage:
        return await run_dispatch(dispatch.send_feedback, self.component, feedback, self.unit.name)


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
        request_proto = build()
        attempts: List[Dict[str, Any]] = []
        last: Optional[Exception] = None
        budget = self.retries if idempotent else 1
        for attempt in range(budget):
            callable_ = services.unary_callable(self._channel(), service, rpc)
            t_attempt = time.perf_counter()
            try:
                resp = await callable_(request_proto, timeout=self.deadline_s)
                return InternalMessage.from_proto(resp)
            except Exception as e:  # noqa: BLE001 — grpc.aio.AioRpcError and friends
                last = e
                attempts.append(_attempt(attempt, _grpc_status_name(e) or type(e).__name__, t_attempt))
                if _grpc_status_name(e) == "UNAVAILABLE":
                    # fresh channel for the next attempt (or the next call)
                    await self._reset_channel()
                if not _grpc_retryable(e) or attempt + 1 >= budget:
                    break
                logger.warning("gRPC %s to %s attempt %d/%d failed: %s", method, self.addr, attempt + 1, budget, e)
                await asyncio.sleep(backoff_s(attempt))
        err = MicroserviceError(
            f"gRPC call {method} to {self.addr} failed: {last} (attempts: {json.dumps(attempts)})",
            status_code=502,
            reason="UPSTREAM_GRPC_ERROR",
        )
        err.attempts = attempts  # machine-readable per-attempt history
        raise err from last

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
        data = json.dumps(encode()).encode()
        headers = {"Content-Type": "application/json"}
        attempts: List[Dict[str, Any]] = []
        last_err: Optional[Exception] = None
        budget = self.retries if idempotent else 1
        for attempt in range(budget):
            t_attempt = time.perf_counter()
            try:
                async with self._get_session().post(self.base + path, data=data, headers=headers) as resp:
                    payload = json.loads(await resp.read())
                    if resp.status < 400:
                        return InternalMessage.from_json(payload)
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
                logger.warning("REST %s to %s attempt %d/%d failed: %s", path, self.base, attempt + 1, budget, e)
                await asyncio.sleep(backoff_s(attempt))
        err = MicroserviceError(
            f"REST call {path} to {self.base} failed: {last_err} (attempts: {json.dumps(attempts)})",
            status_code=502,
            reason="UPSTREAM_REST_ERROR",
        )
        err.attempts = attempts  # machine-readable per-attempt history
        raise err from last_err

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
