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
node span.

Every client is a failure-containment hop: a per-ENDPOINT
:class:`CircuitBreaker`, shared by every caller that dials the endpoint
across all three lanes, fast-fails calls with a 503 ``CIRCUIT_OPEN``
*before* any dial or retry work while the endpoint is tripped (closed →
open on consecutive transient failures → half-open probe trickle after
the cooldown → closed on a probe success), so a flapping child costs its
callers one cheap rejection instead of a full retry and backoff ladder
per request.  Idempotent unary calls can opt into **hedging**
(``seldon.io/hedge-ms``): a duplicate fired to the same endpoint after
the delay races the original, first wins and the loser is cancelled;
suppressed while the breaker is not closed and when the remaining
deadline budget cannot cover a second attempt.  :class:`BalancedClient`
balances round-robin over the replica clients of one node and fails over
between them.  ``SELDON_TPU_BREAKER=0`` disables breaking globally; with
breakers off, hedging unset and no fallback routes the transport behaves
as it did without them.  Every REST and gRPC attempt passes the chaos
points ``transport.delay`` / ``.slow`` / ``.drop`` (``utils/faults.py``,
armed by ``SELDON_TPU_FAULT``; one flag read when disarmed).
"""

from __future__ import annotations

import asyncio
import json
import logging
import random
import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional, Tuple

from seldon_core_tpu_torch.engine.graph import MODEL, UnitSpec
from seldon_core_tpu_torch.runtime import dispatch
from seldon_core_tpu_torch.runtime.component import MicroserviceError
from seldon_core_tpu_torch.runtime.executor_pool import run_dispatch
from seldon_core_tpu_torch.runtime.message import InternalFeedback, InternalMessage
from seldon_core_tpu_torch.utils import deadlines as _deadlines
from seldon_core_tpu_torch.utils import faults as _faults
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


@contextmanager
def _metered_hop(unit: str, method: str, transport: str):
    if not _metrics.transport_telemetry_enabled():
        yield None
        return
    hop = _Hop(unit, method, transport)
    try:
        yield hop
    except BaseException:
        hop.finish(error=True)
        raise
    hop.finish()


def kv_handoff_hop(unit: str, transport: str = "local"):
    """Meter one KV-page handoff (prefill worker -> decode pool) on the
    ``seldon_tpu_transport_*`` series under ``method="kv_handoff"``.  The
    caller sets the byte counts on the yielded hop: ``zero_copy_bytes``
    for the in-process lane (the payload passes by reference),
    ``request_bytes`` for a container shipped over the network.  Yields
    None when transport telemetry is off."""
    return _metered_hop(unit, "kv_handoff", transport)


def migration_hop(unit: str, transport: str = "local"):
    """Meter one live-stream migration (evacuating engine -> peer) under
    ``method="migrate"``, with the byte counts as
    :func:`kv_handoff_hop`'s.  Yields None when transport telemetry is
    off."""
    return _metered_hop(unit, "migrate", transport)


def backoff_s(attempt: int, base_s: float = 0.05, cap_s: float = 2.0) -> float:
    """Full-jitter exponential backoff for attempt ``attempt`` (0-based
    retry index): uniform over [0, min(cap, base * 2^attempt)].
    Deterministic backoff synchronises callers: every client that saw
    the same failure retries at the same instant."""
    return random.uniform(0.0, min(cap_s, base_s * (2 ** max(0, attempt))))


# ---------------------------------------------------------------------------
# per-endpoint circuit breakers
# ---------------------------------------------------------------------------

BREAKER_CLOSED = "closed"
BREAKER_OPEN = "open"
BREAKER_HALF_OPEN = "half_open"


def breakers_enabled() -> bool:
    """``SELDON_TPU_BREAKER=0`` disables circuit breaking globally."""
    from seldon_core_tpu_torch.runtime import knobs

    return knobs.flag("SELDON_TPU_BREAKER")


class CircuitBreaker:
    """One endpoint's failure-containment state machine, SHARED by every
    client that dials the endpoint (keyed by endpoint, not caller: a
    flapping child must fail fast for all of its callers at once).

    closed --[``failures`` consecutive transient failures]--> open
    open   --[``reset_s`` cooldown elapsed]-->                half-open
    half-open --[a probe succeeds]-->                         closed
    half-open --[a probe fails transiently]-->                open

    While open, :meth:`acquire` raises a 503 ``CIRCUIT_OPEN`` *before*
    any dial or retry.  While half-open, at most ``probes`` concurrent
    calls pass as probes; the rest keep fast-failing so a recovering
    upstream is not re-stampeded.  Only *transient* outcomes (UNAVAILABLE
    / DEADLINE_EXCEEDED / RESOURCE_EXHAUSTED, REST 502/503/504, connection
    faults, a local crash) count toward a trip; a deterministic reply
    (4xx, plain 500) proves the endpoint alive and resets the streak.

    State changes hold ``_lock``: the same breaker is reached from the
    gateway's event loop, the sync gRPC handler threads and the native
    ingress's workers.
    """

    _registry: Dict[str, "CircuitBreaker"] = {}
    _registry_lock = threading.Lock()

    def __init__(self, key: str, failures: int = 5, reset_s: float = 1.0, probes: int = 2):
        self.key = key
        self.failures = max(1, int(failures))
        self.reset_s = float(reset_s)
        self.probes = max(1, int(probes))
        self._lock = threading.Lock()
        self._state = BREAKER_CLOSED
        self._streak = 0  # consecutive transient failures while closed
        self._open_until = 0.0
        self._probes_inflight = 0
        # incident counters (the smoke and the tests read these; the
        # registry gets transitions and fast-fails through utils.metrics)
        self.counters = {"trips": 0, "reopens": 0, "closes": 0, "fastfails": 0, "probes": 0,
                         "transient_failures": 0}

    # ---- registry ---------------------------------------------------------

    @classmethod
    def for_endpoint(cls, key: str, failures: int = 5, reset_s: float = 1.0, probes: int = 2) -> "CircuitBreaker":
        """The shared breaker for ``key``, created on first use (the first
        creator's configuration wins)."""
        with cls._registry_lock:
            b = cls._registry.get(key)
            if b is None:
                b = cls(key, failures=failures, reset_s=reset_s, probes=probes)
                cls._registry[key] = b
            return b

    @classmethod
    def discard(cls, key: str) -> None:
        """Evict one endpoint's breaker (replica retirement: a retired
        address is never dialled again, so its entry would leak)."""
        with cls._registry_lock:
            cls._registry.pop(key, None)

    @classmethod
    def reset_all(cls) -> None:
        """Drop every registered breaker (test isolation; a fresh
        deployment starts every endpoint closed)."""
        with cls._registry_lock:
            cls._registry.clear()

    # ---- state machine ----------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            return self._effective_state_locked()

    def _effective_state_locked(self) -> str:
        """OPEN decays to HALF_OPEN when the cooldown elapsed, computed
        on read, so no timer thread is needed."""
        if self._state == BREAKER_OPEN and time.monotonic() >= self._open_until:
            self._state = BREAKER_HALF_OPEN
            self._probes_inflight = 0
            _metrics.record_breaker_state(self.key, BREAKER_HALF_OPEN)
        return self._state

    def _open_locked(self) -> None:
        self._state = BREAKER_OPEN
        self._open_until = time.monotonic() + self.reset_s
        self._streak = 0
        _metrics.record_breaker_state(self.key, BREAKER_OPEN)

    def acquire(self, unit: str, method: str, transport: str) -> bool:
        """Admission for one call: True when the call is a half-open
        PROBE (the caller must settle it), False on the closed path, or
        the 503 ``CIRCUIT_OPEN`` fast-fail before any dispatch work."""
        with self._lock:
            state = self._effective_state_locked()
            if state == BREAKER_CLOSED:
                return False
            if state == BREAKER_HALF_OPEN and self._probes_inflight < self.probes:
                self._probes_inflight += 1
                self.counters["probes"] += 1
                return True
            self.counters["fastfails"] += 1
            remaining = max(0.0, self._open_until - time.monotonic())
        _metrics.record_breaker_fastfail(unit, method, transport)
        raise MicroserviceError(
            f"circuit open for {self.key}: {self.failures} consecutive "
            f"transient failures tripped the breaker (node {unit!r} "
            f"{method}; next probe in {remaining:.2f}s)",
            status_code=503, reason="CIRCUIT_OPEN",
        )

    def on_transient(self) -> None:
        """One transient failure ATTEMPT: counts toward the trip; any
        while half-open reopens at once.  Releasing a probe slot is
        :meth:`release`, so a multi-attempt call reports each attempt but
        settles once."""
        with self._lock:
            self.counters["transient_failures"] += 1
            state = self._effective_state_locked()
            if state == BREAKER_HALF_OPEN:
                self.counters["reopens"] += 1
                self._open_locked()
            elif state == BREAKER_CLOSED:
                self._streak += 1
                if self._streak >= self.failures:
                    self.counters["trips"] += 1
                    self._open_locked()

    def release(self, probe: bool, healthy: Optional[bool]) -> None:
        """Settle one admitted call.  ``healthy=True`` (a reply came back,
        success or a deterministic error) resets the streak and closes a
        half-open breaker; ``False`` (transient exhaustion, the attempts
        already counted) and ``None`` (cancelled: no evidence) only free
        the probe slot."""
        with self._lock:
            if probe:
                self._probes_inflight = max(0, self._probes_inflight - 1)
            if healthy:
                self._streak = 0
                if self._state == BREAKER_HALF_OPEN:
                    self._state = BREAKER_CLOSED
                    self.counters["closes"] += 1
                    _metrics.record_breaker_state(self.key, BREAKER_CLOSED)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"state": self._effective_state_locked(), "streak": self._streak, **self.counters}


class _BreakerCall:
    """One breaker acquire paired with exactly one settle: the clients
    settle it in their ``finally`` so every exit (success, transient
    exhaustion, a deterministic error, a cancelled hedge loser) frees a
    probe slot once, while each transient attempt feeds the trip count
    as it happens."""

    __slots__ = ("breaker", "probe", "_settled")

    def __init__(self, breaker: Optional[CircuitBreaker], unit: str, method: str, transport: str):
        self.breaker = breaker
        self.probe = breaker.acquire(unit, method, transport) if breaker is not None else False
        self._settled = breaker is None

    def attempt_transient(self) -> None:
        if self.breaker is not None:
            self.breaker.on_transient()

    def settle(self, healthy: Optional[bool]) -> None:
        if not self._settled:
            self._settled = True
            self.breaker.release(self.probe, healthy)

    def open_now(self) -> bool:
        """True when the breaker is no longer closed: the retry ladder
        stops instead of burning the rest of its backoff budget."""
        return self.breaker is not None and self.breaker.state != BREAKER_CLOSED


def _resolve_breaker(key: str, breaker) -> Optional[CircuitBreaker]:
    """The clients' ``breaker=`` convention: ``None`` = the endpoint's
    shared default (unless disabled globally), ``False`` = off for this
    client, an instance = use it (``build_client`` passes annotation-
    configured ones)."""
    if breaker is False:
        return None
    if isinstance(breaker, CircuitBreaker):
        return breaker
    return CircuitBreaker.for_endpoint(key) if breakers_enabled() else None


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

    def __init__(self, unit: UnitSpec, component: Any, breaker=None):
        self.unit = unit
        self.component = component
        # keyed by unit (there is no endpoint) and tripped only by
        # crash-shaped errors: a MicroserviceError (a 4xx, SHED) is the
        # component speaking, and counting it would turn load shedding
        # into an outage
        self.breaker = _resolve_breaker(f"local:{unit.name}", breaker)

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
        # an open breaker fails before dispatch too (acquire raises)
        breaker_call = _BreakerCall(self.breaker, self.unit.name, method, "local")
        self._inject_meta(msg)
        hop = _Hop(self.unit.name, method, "local")
        if hop._gauge is not None and not isinstance(msg, InternalFeedback):
            # the walk runs only with telemetry on (the gauge exists)
            hop.zero_copy_bytes = self._ref_bytes(msg)
        ok = False
        healthy: Optional[bool] = False
        try:
            out = await call()
            ok = healthy = True
            return out
        except MicroserviceError:
            healthy = True  # a well-formed error is the component speaking
            raise
        except asyncio.CancelledError:
            healthy = None
            raise
        except Exception:
            breaker_call.attempt_transient()  # crash-shaped: counts toward the trip
            raise
        finally:
            breaker_call.settle(healthy)
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


async def _hedged_call(client, method: str, transport: str, factory):
    """First-wins hedging for one idempotent unary call (the per-node
    ``seldon.io/hedge-ms`` annotation): when the primary has not answered
    within ``hedge_ms``, fire ONE duplicate of the same call to the same
    endpoint and return whichever finishes first, cancelling the loser.

    A plain single call when hedging is off (``hedge_ms <= 0``), when the
    endpoint's breaker is not closed (a half-open upstream is probed at a
    trickle; doubling its traffic is how recovering services get killed
    again), or when the remaining end-to-end budget cannot cover a
    second attempt (``remaining <= hedge_ms``).

    The first success wins; when both lanes fail, the primary's error
    surfaces (it carries the fuller attempt history).  The loser's RPC is
    cancelled on the client side; the server may still run it.
    """
    if client.hedge_ms <= 0:
        return await factory()
    breaker = client.breaker
    if breaker is not None and breaker.state != BREAKER_CLOSED:
        return await factory()
    ambient = _deadlines.current_deadline()
    if ambient is not None and ambient.remaining_ms() <= client.hedge_ms:
        return await factory()
    primary = asyncio.ensure_future(factory())
    await asyncio.wait({primary}, timeout=client.hedge_ms / 1000.0)
    if primary.done():
        return primary.result()  # raises the primary's error unchanged
    client.hedges_fired += 1
    _metrics.record_transport_hedge(client.unit.name, method, transport)
    hedge = asyncio.ensure_future(factory())
    pending = {primary, hedge}
    errors: List[Tuple[Any, BaseException]] = []
    try:
        while pending:
            done, pending = await asyncio.wait(pending, return_when=asyncio.FIRST_COMPLETED)
            for task in done:
                if task.cancelled():
                    continue
                exc = task.exception()
                if exc is not None:
                    errors.append((task, exc))
                    continue
                if task is hedge:
                    client.hedge_wins += 1
                    _metrics.record_transport_hedge(client.unit.name, method, transport, won=True)
                return task.result()
    finally:
        # cancel the loser, and on any exit leave no task behind
        for task in (primary, hedge):
            if not task.done():
                task.cancel()
        await asyncio.gather(primary, hedge, return_exceptions=True)
    for task, exc in errors:
        if task is primary:
            raise exc
    raise errors[0][1]


_METHOD_TO_SERVICE = {
    # method -> (service, rpc)
    "predict": ("Model", "Predict"),
    "transform_input": ("Transformer", "TransformInput"),
    "transform_output": ("OutputTransformer", "TransformOutput"),
    "route": ("Router", "Route"),
    "aggregate": ("Combiner", "Aggregate"),
    "send_feedback": ("Model", "SendFeedback"),
}


async def _inject_attempt_faults() -> None:
    """The transport chaos points, on every REST and gRPC attempt:
    ``transport.delay`` / ``transport.slow`` sleep first, then
    ``transport.drop`` raises a transient connection error that reads as
    UNAVAILABLE (``utils/faults.py``; one flag read when disarmed)."""
    if not _faults.enabled():
        return
    delay = _faults.delay_s("transport.delay") + _faults.delay_s("transport.slow")
    if delay:
        await asyncio.sleep(delay)
    _faults.raise_if("transport.drop")


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

    def __init__(self, unit: UnitSpec, deadline_s: float = 5.0, retries: int = 3, breaker=None,
                 hedge_ms: float = 0.0):
        if unit.endpoint is None:
            raise ValueError(f"GrpcClient for {unit.name!r} needs an endpoint")
        self.unit = unit
        self.addr = f"{unit.endpoint.host}:{unit.endpoint.port}"
        self.deadline_s = deadline_s
        self.retries = max(1, int(retries))
        # the endpoint's breaker, shared with every client dialling it
        self.breaker = _resolve_breaker(self.addr, breaker)
        # seldon.io/hedge-ms: after hedge_ms without a reply, a duplicate
        # of the same idempotent call races the original
        self.hedge_ms = float(hedge_ms)
        self.hedges_fired = 0
        self.hedge_wins = 0

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
        # an open breaker fails before the codec and dial work
        breaker_call = _BreakerCall(self.breaker, self.unit.name, method, "grpc")
        hop = _Hop(self.unit.name, method, "grpc")
        ok = False
        healthy: Optional[bool] = False
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
                    if breaker_call.open_now():
                        break  # the circuit opened mid-ladder: the accumulated error surfaces below
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
                    await _inject_attempt_faults()
                    resp = await callable_(request_proto, timeout=timeout_s, metadata=metadata)
                    hop.response_bytes = resp.ByteSize()
                    with hop.codec():
                        out = InternalMessage.from_proto(resp)
                    ok = healthy = True
                    return out
                except Exception as e:  # noqa: BLE001 — grpc.aio.AioRpcError and friends
                    last = e
                    attempts.append(_attempt(attempt, _grpc_status_name(e) or type(e).__name__, t_attempt))
                    retryable = _grpc_retryable(e)
                    if retryable:
                        breaker_call.attempt_transient()
                    else:
                        healthy = True  # a deterministic reply: the endpoint is alive
                    if _grpc_status_name(e) == "UNAVAILABLE":
                        # fresh channel for the next attempt (or the next call)
                        await self._reset_channel()
                    if not retryable or attempt + 1 >= budget:
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
            # for the fallback layer: a deterministic upstream reply would
            # fail the same way on a fallback route
            err.transient = last is None or _grpc_retryable(last)
            raise err from last
        except asyncio.CancelledError:
            healthy = None  # a hedge loser, or the caller is gone: no evidence
            raise
        finally:
            breaker_call.settle(healthy)
            hop.finish(error=not ok)

    async def transform_input(self, msg: InternalMessage) -> InternalMessage:
        method = "predict" if self.unit.type == MODEL else "transform_input"
        return await _hedged_call(self, method, "grpc", lambda: self._call(method, msg.to_proto))

    async def transform_output(self, msg: InternalMessage) -> InternalMessage:
        return await _hedged_call(self, "transform_output", "grpc",
                                  lambda: self._call("transform_output", msg.to_proto))

    async def route(self, msg: InternalMessage) -> InternalMessage:
        return await _hedged_call(self, "route", "grpc", lambda: self._call("route", msg.to_proto))

    async def aggregate(self, msgs: List[InternalMessage]) -> InternalMessage:
        def build():
            from seldon_core_tpu_torch.proto import pb

            return pb.SeldonMessageList(seldonMessages=[m.to_proto() for m in msgs])

        return await _hedged_call(self, "aggregate", "grpc", lambda: self._call("aggregate", build))

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
        """Close and evict this endpoint's cached channel and its
        registry breaker (replica retirement)."""
        chan = GrpcClient._channels.pop(self.addr, None)
        if chan is not None:
            await chan.close()
        CircuitBreaker.discard(self.addr)


# HTTP statuses worth another attempt within the call budget: the
# upstream is overloaded or mid-restart, not wrong.  Everything else —
# 4xx, plain 500 — would fail identically on every attempt.
_REST_RETRYABLE_STATUSES = (502, 503, 504)


class RestClient(NodeClient):
    """Remote node over REST/JSON with bounded retries on transient
    faults, matching ``GrpcClient``'s semantics: full-jitter backoff,
    the full per-attempt history on ``MicroserviceError.attempts`` and
    in the message, the endpoint's shared breaker, opt-in hedging, and
    ``send_feedback`` never retried nor hedged."""

    def __init__(self, unit: UnitSpec, connect_timeout_s: float = 2.0, read_timeout_s: float = 5.0,
                 retries: int = 3, breaker=None, hedge_ms: float = 0.0):
        if unit.endpoint is None:
            raise ValueError(f"RestClient for {unit.name!r} needs an endpoint")
        self.unit = unit
        self.base = f"http://{unit.endpoint.host}:{unit.endpoint.port}"
        self.connect_timeout_s = connect_timeout_s
        self.read_timeout_s = read_timeout_s
        self.retries = max(1, int(retries))
        self.breaker = _resolve_breaker(f"{unit.endpoint.host}:{unit.endpoint.port}", breaker)
        self.hedge_ms = float(hedge_ms)
        self.hedges_fired = 0
        self.hedge_wins = 0
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
        # an open breaker fails before the codec and dial work
        breaker_call = _BreakerCall(self.breaker, self.unit.name, method, "rest")
        hop = _Hop(self.unit.name, method, "rest")
        ok = False
        healthy: Optional[bool] = False
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
                    if breaker_call.open_now():
                        break  # the circuit opened mid-ladder: the accumulated error surfaces below
                # re-inject per attempt: the remaining budget shrank by
                # what the failed attempt burned
                headers = _deadlines.inject(dict(base_headers))
                t_attempt = time.perf_counter()
                try:
                    await _inject_attempt_faults()
                    async with self._get_session().post(self.base + path, data=data, headers=headers) as resp:
                        raw = await resp.read()
                        hop.response_bytes = len(raw)
                        with hop.codec():
                            payload = json.loads(raw)
                        if resp.status < 400:
                            with hop.codec():
                                out = InternalMessage.from_json(payload)
                            ok = healthy = True
                            return out
                        attempts.append(_attempt(attempt, str(resp.status), t_attempt))
                        err = MicroserviceError(
                            f"REST call {path} to {self.base} returned {resp.status}: {payload} "
                            f"(attempts: {json.dumps(attempts)})",
                            status_code=502,
                            reason="UPSTREAM_REST_ERROR",
                        )
                        # a deterministic reply (4xx, plain 500) is neither
                        # retried here nor absorbed by a fallback route
                        err.transient = resp.status in _REST_RETRYABLE_STATUSES
                        if err.transient:
                            breaker_call.attempt_transient()  # overloaded or mid-restart
                            if attempt + 1 < budget:
                                last_err = err
                                logger.warning("REST %s to %s attempt %d/%d got %d, retrying",
                                               path, self.base, attempt + 1, budget, resp.status)
                                await asyncio.sleep(backoff_s(attempt))
                                continue
                        else:
                            healthy = True  # the endpoint answered: never counts toward a trip
                        err.attempts = attempts
                        raise err
                except (MicroserviceError, asyncio.CancelledError):
                    raise
                except Exception as e:  # noqa: BLE001 — connection faults: transient by class
                    last_err = e
                    attempts.append(_attempt(attempt, type(e).__name__, t_attempt))
                    breaker_call.attempt_transient()
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
            err.transient = True  # connection faults: transient by class
            raise err from last_err
        except asyncio.CancelledError:
            healthy = None  # a hedge loser, or the caller is gone: no evidence
            raise
        finally:
            breaker_call.settle(healthy)
            hop.finish(error=not ok)

    async def transform_input(self, msg: InternalMessage) -> InternalMessage:
        if self.unit.type == MODEL:
            return await _hedged_call(self, "predict", "rest", lambda: self._post("/predict", "predict", msg.to_json))
        return await _hedged_call(self, "transform_input", "rest",
                                  lambda: self._post("/transform-input", "transform_input", msg.to_json))

    async def transform_output(self, msg: InternalMessage) -> InternalMessage:
        return await _hedged_call(self, "transform_output", "rest",
                                  lambda: self._post("/transform-output", "transform_output", msg.to_json))

    async def route(self, msg: InternalMessage) -> InternalMessage:
        return await _hedged_call(self, "route", "rest", lambda: self._post("/route", "route", msg.to_json))

    async def aggregate(self, msgs: List[InternalMessage]) -> InternalMessage:
        return await _hedged_call(self, "aggregate", "rest", lambda: self._post(
            "/aggregate", "aggregate", lambda: {"seldonMessages": [m.to_json() for m in msgs]}))

    async def send_feedback(self, feedback: InternalFeedback) -> InternalMessage:
        # not idempotent: a timeout after the reward was applied must
        # not replay it (nor may a hedge duplicate it)
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
        CircuitBreaker.discard(f"{self.unit.endpoint.host}:{self.unit.endpoint.port}")


class BalancedClient(NodeClient):
    """Round-robin balancer over the replica clients of one node, the
    role a k8s Service plays in front of an HPA-scaled Deployment in the
    reference (reference: seldondeployment_controller.go:894-930): the
    graph edge holds one client while the replica set behind it changes.
    ``set_clients`` swaps the replica list atomically; each call starts
    at the next rotation slot and fails over to the other replicas before
    surfacing the last error.  Put it into a graph with
    ``GraphExecutor(root, clients={node name: BalancedClient([...])})``.
    """

    def __init__(self, clients: Optional[List[NodeClient]] = None):
        self._clients: List[NodeClient] = list(clients or [])
        self._retired: List[NodeClient] = []
        self._rr = 0
        self._lock = threading.Lock()

    def set_clients(self, clients: List[NodeClient]) -> None:
        """Swap the replica list.  Replaced clients are closed on the
        serving loop at the next call (their ``grpc.aio`` channels are
        bound to it, and this may run on another thread)."""
        fresh = list(clients)
        with self._lock:
            keep = set(map(id, fresh))
            self._retired.extend(c for c in self._clients if id(c) not in keep)
            self._clients = fresh

    async def _drain_retired(self) -> None:
        with self._lock:
            retired, self._retired = self._retired, []
        for client in retired:
            try:
                await client.close()
            except Exception as e:  # noqa: BLE001 — best-effort client cleanup
                logger.debug("closing retired replica client failed: %s", e)

    @property
    def replica_count(self) -> int:
        with self._lock:
            return len(self._clients)

    def _rotation(self) -> List[NodeClient]:
        with self._lock:
            if not self._clients:
                return []
            start = self._rr % len(self._clients)
            self._rr += 1
            return self._clients[start:] + self._clients[:start]

    async def _call(self, method: str, *args, failover: bool = True):
        await self._drain_retired()
        rotation = self._rotation()
        if not rotation:
            raise MicroserviceError("no replicas available", status_code=503, reason="NO_REPLICAS")
        last: Optional[Exception] = None
        for client in rotation:
            try:
                return await getattr(client, method)(*args)
            except Exception as e:  # noqa: BLE001 — fail over to the next replica
                # a 4xx would fail the same way on every replica
                if isinstance(e, MicroserviceError) and e.status_code is not None and 400 <= e.status_code < 500:
                    raise
                last = e
                if not failover:
                    raise
                unit = getattr(getattr(client, "unit", None), "name", "") or "balanced"
                _metrics.record_transport_failover(unit, method)
                logger.warning("replica call %s failed, failing over: %s", method, e)
        raise last  # type: ignore[misc]

    async def transform_input(self, msg: InternalMessage) -> InternalMessage:
        return await self._call("transform_input", msg)

    async def transform_output(self, msg: InternalMessage) -> InternalMessage:
        return await self._call("transform_output", msg)

    async def route(self, msg: InternalMessage) -> InternalMessage:
        return await self._call("route", msg)

    async def aggregate(self, msgs: List[InternalMessage]) -> InternalMessage:
        return await self._call("aggregate", msgs)

    async def send_feedback(self, feedback: InternalFeedback) -> InternalMessage:
        # not idempotent: a timeout after the reward was applied must not
        # replay the feedback on another replica
        return await self._call("send_feedback", feedback, failover=False)

    async def ready(self) -> bool:
        for client in self._rotation():
            if await client.ready():
                return True
        return False

    async def close(self) -> None:
        await self._drain_retired()
        for client in self._rotation():
            await client.close()
