"""Distributed tracing: spans, W3C trace context, JSONL and OTLP export.

The port's counterpart of ``seldon_core_tpu/utils/tracing.py``, same
span model and wire contract, stdlib only: an in-memory ring of spans
(``Tracer.find``), a JSON-lines file sink (one span per line; the
``SELDON_TPU_TRACE_EXPORT`` knob of the microservice CLI), and
``OtlpHttpExporter`` (OTLP/HTTP JSON, enabled by
``OTEL_EXPORTER_OTLP_ENDPOINT``).

Spans cover the reference's cut points: one per external request
(``predictor.predict``), one per graph-node method call
(``node.<unit>.<method>``), one per microservice method
(``microservice.<method>``).  Cross-process propagation is W3C trace
context: ``inject`` / ``extract`` carry a ``SpanContext`` over HTTP
headers, gRPC metadata or ``meta.traceContext``, so a span made in the
gateway is the real parent of the microservice's span in another
process.  The logical trace id (the puid) rides in ``tracestate`` under
the ``seldon-tpu`` vendor key; ``traceparent`` carries its 32-hex
derivation (``w3c_trace_id``), the same one ``OtlpHttpExporter`` ships,
so both packages put the same ids on the wire and in the collector.
"""

from __future__ import annotations

import contextvars
import json
import os
import random
import re
import threading
import time
import uuid
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Tuple

_tracer: Optional["Tracer"] = None
# the active span of the current task/thread; contextvars propagate
# through asyncio tasks, so nested spans self-link without plumbing
_current_span: "contextvars.ContextVar[Optional[Span]]" = contextvars.ContextVar(
    "seldon_tpu_current_span", default=None
)

# span/trace id generator: a urandom-seeded PRNG, not uuid4 — an id is
# minted per SPAN, and the per-call urandom syscall was the top line of
# the traced serving profile (same reasoning as runtime/puid.py).  The
# pid guard reseeds after fork so two processes never share a stream.
_ids_lock = threading.Lock()
_ids_pid: Optional[int] = None
_ids_rng = random.Random()


def _new_id(nbytes: int) -> str:
    global _ids_pid
    with _ids_lock:
        if _ids_pid != os.getpid():
            _ids_rng.seed(uuid.uuid4().int)
            _ids_pid = os.getpid()
        return f"{_ids_rng.getrandbits(nbytes * 8):0{nbytes * 2}x}"


def w3c_trace_id(trace_id: str) -> str:
    """The 32-hex W3C trace id of a logical trace id (usually a puid).

    A value that already IS a 32-hex id passes through; anything else
    hashes — the SAME derivation ``OtlpHttpExporter`` uses, so the id
    on the wire matches the id in the collector."""
    if len(trace_id) == 32 and all(c in "0123456789abcdef" for c in trace_id):
        return trace_id
    import hashlib

    return hashlib.sha256(trace_id.encode()).hexdigest()[:32]


@dataclass
class Span:
    trace_id: str  # the request puid
    name: str  # e.g. "predictor.predict", "node.transform_input"
    start_s: float
    duration_s: float = 0.0
    tags: Dict[str, Any] = field(default_factory=dict)
    parent: Optional[str] = None  # parent span NAME (informational)
    span_id: str = field(default_factory=lambda: _new_id(8))
    parent_span_id: Optional[str] = None
    # True for the placeholder a remote SpanContext activates: it is
    # never recorded, and its trace id overrides a child's explicit
    # trace_id arg — the caller process owns the trace identity
    remote: bool = False
    # propagation state inherited down the tree and re-injected on the
    # next hop: an upstream's do-not-sample decision and any foreign
    # vendors' tracestate members survive verbatim (not serialized in
    # to_dict — they are hop state, not span data)
    sampled: bool = True
    tracestate: str = ""

    def to_dict(self) -> Dict[str, Any]:
        # spanId/parentSpanId ride along so the JSONL file exporter
        # keeps the same parent linkage the OTLP exporter ships — a
        # trace reassembled from the file must not lose its tree shape
        # (parentSpanId is None for roots, mirroring OTLP's omission)
        return {
            "traceId": self.trace_id,
            "spanId": self.span_id,
            "parentSpanId": self.parent_span_id,
            "name": self.name,
            "startTimeUnixNano": int(self.start_s * 1e9),
            "durationNano": int(self.duration_s * 1e9),
            "tags": self.tags,
            "parent": self.parent,
        }


# ---------------------------------------------------------------------------
# W3C trace-context propagation
# ---------------------------------------------------------------------------

TRACEPARENT_HEADER = "traceparent"
OTLP_SCOPE = "seldon_core_tpu.utils.tracing"
TRACESTATE_HEADER = "tracestate"
_TRACESTATE_VENDOR = "seldon-tpu"  # carries the logical trace id (puid)
_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$"
)


@dataclass(frozen=True)
class SpanContext:
    """The cross-process identity of a span: what survives
    serialization over any transport hop.

    ``trace_id`` is the LOGICAL id (the puid for requests born at our
    gateway); ``hex_trace_id`` its 32-hex wire form.  A context parsed
    from a foreign caller (no ``seldon-tpu`` tracestate member) uses
    the wire id as the logical id."""

    trace_id: str
    span_id: str  # 16-hex id of the (remote) parent span
    sampled: bool = True
    tracestate: str = ""

    @property
    def hex_trace_id(self) -> str:
        return w3c_trace_id(self.trace_id)

    def to_traceparent(self) -> str:
        return (
            f"00-{self.hex_trace_id}-{self.span_id}-"
            f"{'01' if self.sampled else '00'}"
        )

    def to_tracestate(self) -> str:
        """tracestate with our vendor member prepended (W3C §3.3.1:
        mutating vendors re-list themselves first)."""
        members = [
            m for m in (self.tracestate or "").split(",")
            if m.strip() and not m.strip().startswith(f"{_TRACESTATE_VENDOR}=")
        ]
        own = f"{_TRACESTATE_VENDOR}={self.trace_id}"
        return ",".join([own] + members[:31])  # W3C caps at 32 members


def span_context(span: Optional[Span] = None) -> Optional[SpanContext]:
    """The propagatable context of ``span`` (default: the active span)."""
    s = span if span is not None else _current_span.get()
    if s is None:
        return None
    # pad/trim to the 16-hex W3C span id (ours are 16-hex already)
    sid = (s.span_id + "0" * 16)[:16]
    return SpanContext(
        trace_id=s.trace_id, span_id=sid,
        sampled=s.sampled, tracestate=s.tracestate,
    )


def _carrier_get(carrier: Any, key: str) -> Optional[str]:
    """Case-insensitive lookup over dicts, header multidicts, and
    (key, value) tuple lists (gRPC invocation metadata)."""
    if carrier is None:
        return None
    getter = getattr(carrier, "get", None)
    if getter is not None:
        val = getter(key)
        if val is None:
            val = getter(key.title())  # plain dicts with Traceparent
        if val is not None:
            return str(val)
    try:
        items = carrier.items() if hasattr(carrier, "items") else carrier
        for k, v in items:
            if str(k).lower() == key:
                return str(v)
    except (TypeError, ValueError):
        return None
    return None


def extract(carrier: Any) -> Optional[SpanContext]:
    """Parse a ``SpanContext`` out of any carrier — HTTP headers, gRPC
    metadata tuples, or a plain dict (``InternalMessage.meta``'s
    traceContext).  Returns None (never raises) on absent or malformed
    context — a bad header must not fail the request."""
    try:
        header = _carrier_get(carrier, TRACEPARENT_HEADER)
        if not header:
            return None
        m = _TRACEPARENT_RE.match(header.strip().lower())
        if m is None:
            return None
        version, hex_tid, span_id, flags = m.groups()
        if version == "ff" or hex_tid == "0" * 32 or span_id == "0" * 16:
            return None  # forbidden version / all-zero ids (W3C §3.2.2)
        state = _carrier_get(carrier, TRACESTATE_HEADER) or ""
        trace_id = hex_tid
        for member in state.split(","):
            k, _, v = member.strip().partition("=")
            if k == _TRACESTATE_VENDOR and v:
                trace_id = v
                break
        return SpanContext(
            trace_id=trace_id,
            span_id=span_id,
            sampled=bool(int(flags, 16) & 1),
            tracestate=state,
        )
    except Exception:  # noqa: BLE001 — malformed context is not an error
        return None


def inject(carrier: Dict[str, str], span: Optional[Span] = None) -> Dict[str, str]:
    """Write the active (or given) span's context into a mutable
    mapping — HTTP headers dict, ``meta.trace_context`` dict.  No-op
    when nothing is being traced; always returns the carrier."""
    ctx = span_context(span)
    if ctx is not None:
        carrier[TRACEPARENT_HEADER] = ctx.to_traceparent()
        carrier[TRACESTATE_HEADER] = ctx.to_tracestate()
    return carrier


def inject_metadata(
    metadata: Optional[List[Tuple[str, str]]] = None, span: Optional[Span] = None
) -> List[Tuple[str, str]]:
    """gRPC flavour of ``inject``: (key, value) tuples."""
    md = list(metadata or [])
    ctx = span_context(span)
    if ctx is not None:
        md.append((TRACEPARENT_HEADER, ctx.to_traceparent()))
        md.append((TRACESTATE_HEADER, ctx.to_tracestate()))
    return md


@contextmanager
def activate_context(ctx: Optional[SpanContext]):
    """Make a remote ``SpanContext`` the ambient parent: spans created
    inside become its children and ADOPT its trace id (the caller owns
    trace identity — that is what makes the microservice's ``_traced``
    spans children of the gateway's span instead of fresh roots).
    ``None`` is a no-op, so call sites don't branch."""
    if ctx is None:
        yield None
        return
    placeholder = Span(
        trace_id=ctx.trace_id, name="<remote>", start_s=time.time(),
        span_id=ctx.span_id, remote=True,
        sampled=ctx.sampled, tracestate=ctx.tracestate,
    )
    token = _current_span.set(placeholder)
    try:
        yield placeholder
    finally:
        _current_span.reset(token)


class OtlpHttpExporter:
    """Ships spans as OTLP/HTTP JSON resourceSpans batches.

    Buffered: spans accumulate and flush when ``batch_size`` is reached
    or on ``flush()``/``close()``.  Export failures are counted, never
    raised — tracing must not take the data plane down.
    """

    def __init__(
        self,
        endpoint: str = "http://127.0.0.1:4318/v1/traces",
        service_name: str = "seldon-tpu",
        batch_size: int = 64,
        timeout_s: float = 5.0,
        max_queue_batches: int = 64,
    ):
        import queue

        self.endpoint = endpoint
        self.service_name = service_name
        self.batch_size = int(batch_size)
        self.timeout_s = float(timeout_s)
        self.exported = 0
        self.failures = 0
        self.dropped = 0  # spans shed because the export queue was full
        self._buffer: List[Span] = []
        self._lock = threading.Lock()
        # exports happen on a worker thread: record() is called from the
        # serving event loop, and a slow/blackholed collector must not
        # stall requests (same pattern as reqlogger's HTTP worker).
        # BOUNDED: a blackholed collector makes every export pay its
        # timeout while spans keep arriving, so an unbounded queue grows
        # without limit; at the cap the OLDEST batch is shed (the newest
        # spans are the ones an operator debugging the outage needs) and
        # the loss is counted in `dropped`, never silent.
        self._queue: "queue.Queue[Optional[List[Span]]]" = queue.Queue(
            maxsize=max(1, int(max_queue_batches))
        )
        self._worker = threading.Thread(target=self._drain, daemon=True, name="otlp-export")
        self._worker.start()

    def _drain(self) -> None:
        while True:
            batch = self._queue.get()
            if batch is None:
                self._queue.task_done()
                return
            self.export(batch)
            self._queue.task_done()

    @staticmethod
    def _hex_id(seed: str, nbytes: int) -> str:
        if nbytes == 16:
            return w3c_trace_id(seed)  # the shared wire-id derivation
        import hashlib

        return hashlib.sha256(seed.encode()).hexdigest()[: nbytes * 2]

    def _otlp_span(self, s: Span) -> Dict[str, Any]:
        start = int(s.start_s * 1e9)
        # trace id derives from the puid via w3c_trace_id — the same
        # derivation inject() puts on the wire, so spans shipped from
        # different processes of one request join one OTLP trace; span
        # ids are real per-span uuids assigned at creation
        return {
            "traceId": self._hex_id(s.trace_id, 16) if s.trace_id else _new_id(16),  # fallback for hand-built spans
            "spanId": s.span_id,
            **({"parentSpanId": s.parent_span_id} if s.parent_span_id else {}),
            "name": s.name,
            "kind": 2,  # SPAN_KIND_SERVER
            "startTimeUnixNano": str(start),
            "endTimeUnixNano": str(start + int(s.duration_s * 1e9)),
            "attributes": [
                {"key": k, "value": {"stringValue": str(v)}} for k, v in s.tags.items()
            ],
        }

    def payload(self, spans: List[Span]) -> Dict[str, Any]:
        return {
            "resourceSpans": [
                {
                    "resource": {
                        "attributes": [
                            {
                                "key": "service.name",
                                "value": {"stringValue": self.service_name},
                            }
                        ]
                    },
                    "scopeSpans": [
                        {
                            # the instrumentation scope is the system's,
                            # one name for both packages: a collector
                            # query sees the JAX and the PyTorch servers
                            "scope": {"name": OTLP_SCOPE},
                            "spans": [self._otlp_span(s) for s in spans],
                        }
                    ],
                }
            ]
        }

    def export(self, spans: List[Span]) -> bool:
        import urllib.request

        if not spans:
            return True
        req = urllib.request.Request(
            self.endpoint,
            data=json.dumps(self.payload(spans)).encode(),
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                ok = resp.status < 400
        except Exception:  # noqa: BLE001 — collector down must not hurt serving
            ok = False
        if ok:
            self.exported += len(spans)
        else:
            self.failures += 1
        return ok

    def _offer(self, batch: List[Span]) -> None:
        """Non-blocking enqueue with drop-oldest overflow: the caller is
        the serving path and must never wait on a wedged exporter."""
        import queue

        while True:
            try:
                self._queue.put_nowait(batch)
                return
            except queue.Full:
                try:
                    old = self._queue.get_nowait()
                except queue.Empty:
                    continue  # raced the worker; retry the put
                self._queue.task_done()
                if old is None:
                    # shutdown sentinel: keep it (the worker must still
                    # exit) and shed the NEW batch instead
                    try:
                        self._queue.put_nowait(None)
                    except queue.Full:
                        pass  # worker is wedged; close() joins with timeout
                    self.dropped += len(batch)
                    return
                self.dropped += len(old)

    def __call__(self, span: Span) -> None:
        with self._lock:
            self._buffer.append(span)
            if len(self._buffer) < self.batch_size:
                return
            batch, self._buffer = self._buffer, []
        self._offer(batch)  # non-blocking hand-off to the worker

    def flush(self) -> None:
        """Hand any partial batch to the worker and wait for it."""
        with self._lock:
            batch, self._buffer = self._buffer, []
        if batch:
            self._offer(batch)
        self._queue.join()

    def close(self) -> None:
        import queue

        self.flush()
        try:  # queue is empty post-flush; bounded put only for safety
            self._queue.put(None, timeout=self.timeout_s)
        except queue.Full:
            pass
        self._worker.join(timeout=self.timeout_s)


class Tracer:
    def __init__(
        self,
        service_name: str = "seldon-tpu",
        capacity: int = 4096,
        export_path: Optional[str] = None,
        exporter: Optional[Any] = None,  # callable(Span), e.g. OtlpHttpExporter
    ):
        self.service_name = service_name
        self.spans: Deque[Span] = deque(maxlen=capacity)
        self.export_path = export_path
        self.exporter = exporter
        self._lock = threading.Lock()
        self._file = open(export_path, "a") if export_path else None

    @contextmanager
    def span(self, name: str, trace_id: str = "", parent: Optional[str] = None, **tags: Any):
        s = Span(trace_id=trace_id, name=name, start_s=time.time(), tags=dict(tags), parent=parent)
        enclosing = _current_span.get()
        if enclosing is not None:
            s.parent_span_id = enclosing.span_id
            if s.parent is None and not enclosing.remote:
                s.parent = enclosing.name
            # trace identity flows DOWN from the root: a child always
            # joins its parent's trace, whatever trace_id it was called
            # with — otherwise a root that adopted an external caller's
            # traceparent would split the tree the moment a node span
            # passed the local puid.  The two are equal except in that
            # adoption case; the puid survives as a tag when they differ
            # so Tracer.find(<puid>) stays answerable.
            if s.trace_id and s.trace_id != enclosing.trace_id:
                s.tags.setdefault("puid", s.trace_id)
            s.trace_id = enclosing.trace_id
            # propagation state rides the tree too, so the NEXT hop's
            # inject() re-emits the upstream's sampling decision and
            # foreign tracestate members verbatim
            s.sampled = enclosing.sampled
            s.tracestate = enclosing.tracestate
        if not s.trace_id:
            # root span without a puid: mint the trace id here, once,
            # so children (and the exporter) all see the same trace
            s.trace_id = _new_id(16)
        token = _current_span.set(s)
        t0 = time.perf_counter()
        try:
            yield s
        finally:
            _current_span.reset(token)
            s.duration_s = time.perf_counter() - t0
            self.record(s)

    def record(self, s: Span) -> None:
        with self._lock:
            self.spans.append(s)
            if self._file is not None and not self._file.closed:
                self._file.write(json.dumps(s.to_dict()) + "\n")
                self._file.flush()
        if self.exporter is not None:
            try:
                self.exporter(s)
            except Exception:  # noqa: BLE001 — exporters never break serving
                pass

    def find(self, trace_id: str) -> List[Span]:
        """Spans of one trace, matched by trace id OR by the ``puid``
        tag (a trace that adopted an external caller's id keeps its
        puid there, so puid lookups keep working)."""
        with self._lock:
            return [
                s for s in self.spans
                if s.trace_id == trace_id or s.tags.get("puid") == trace_id
            ]

    def close(self) -> None:
        with self._lock:  # record() writes under this lock — no close race
            if self._file is not None:
                self._file.close()
                self._file = None
        if self.exporter is not None and hasattr(self.exporter, "close"):
            self.exporter.close()


def setup_tracing(
    service_name: str = "seldon-tpu",
    export_path: Optional[str] = None,
    otlp_endpoint: Optional[str] = None,
    capacity: int = 4096,
) -> Tracer:
    """Install the global tracer (reference: setup_tracing env-driven
    init, microservice.py:124-155).  ``OTEL_EXPORTER_OTLP_ENDPOINT``
    (or the argument) turns on the OTLP/HTTP exporter."""
    import os

    global _tracer
    if _tracer is not None:  # flush + release the previous tracer's sinks
        _tracer.close()
    endpoint = otlp_endpoint or os.environ.get("OTEL_EXPORTER_OTLP_ENDPOINT", "")
    exporter = None
    if endpoint:
        if not endpoint.rstrip("/").endswith("/v1/traces"):
            endpoint = endpoint.rstrip("/") + "/v1/traces"
        exporter = OtlpHttpExporter(endpoint=endpoint, service_name=service_name)
    _tracer = Tracer(
        service_name=service_name, capacity=capacity,
        export_path=export_path, exporter=exporter,
    )
    return _tracer


def get_tracer() -> Optional[Tracer]:
    return _tracer


def current_span() -> Optional[Span]:
    """The active span of the calling thread/task, if any.  Components
    whose work continues on ANOTHER thread (e.g. the paged engine's
    decode loop) capture this at submit time and link their spans by
    explicit (trace_id, parent_span_id) — the contextvar itself does
    not cross threads."""
    return _current_span.get()


def record_span(
    name: str,
    trace_id: str,
    start_s: float,
    duration_s: float,
    parent_span_id: Optional[str] = None,
    **tags: Any,
) -> Optional[Span]:
    """Record a completed span with EXPLICIT timing and linkage — the
    lane for work measured outside a ``with tracer.span(...)`` scope
    (the engine's decode loop times phases itself and emits spans after
    the fact).  One global read when tracing is off."""
    tracer = get_tracer()
    if tracer is None:
        return None
    s = Span(
        trace_id=trace_id, name=name, start_s=start_s,
        duration_s=duration_s, tags=dict(tags),
        parent_span_id=parent_span_id,
    )
    tracer.record(s)
    return s


@contextmanager
def maybe_span(name: str, trace_id: str = "", **tags: Any):
    """A span if tracing is enabled, else a no-op."""
    tracer = get_tracer()
    if tracer is None:
        yield None
    else:
        with tracer.span(name, trace_id=trace_id, **tags) as s:
            yield s
