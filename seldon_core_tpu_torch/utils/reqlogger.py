"""Request/response pair logging.

The reference engine optionally POSTs each request/response pair with
CloudEvents-style headers to a logging service which indexes them into
Elasticsearch (reference: PredictionService.java:169-202
sendMessagePairAsJson, seldon-request-logger/app/app.py:15-60).  The
port's copy of the JAX package's pair sinks, pluggable:

* ``JsonlPairLogger`` — append one JSON object per pair to a local
  file (rotatable, ship-anywhere);
* ``HttpPairLogger`` — POST pairs with the same CloudEvents headers
  (``CE-Type: seldon.message.pair``) to any collector over ``urllib``,
  buffered and fire-and-forget so the data plane never blocks on
  logging;
* ``KafkaPairLogger`` — produce pairs to a Kafka topic through
  :class:`~seldon_core_tpu_torch.utils.kafka.MiniKafkaProducer`.

Every pair is built by :func:`build_pair`: the request and response
JSON, the puid, the time, a W3C ``traceparent`` and the response's cost
totals, so an indexer can go from a pair to its trace, its capture and
its bill.
"""

from __future__ import annotations

import hashlib
import json
import logging
import queue
import threading
import time
import urllib.request
from typing import Any, Dict, Optional

from seldon_core_tpu_torch.runtime.message import InternalMessage
from seldon_core_tpu_torch.utils import tracing as _tracing

logger = logging.getLogger(__name__)

CE_HEADERS = {
    "CE-SpecVersion": "0.2",
    "CE-Source": "seldon-core-tpu",
    "CE-Type": "seldon.message.pair",
}


def build_pair(request: InternalMessage, response: InternalMessage) -> Dict[str, Any]:
    """One pair record: request, response, puid, time, ``traceparent``
    (the live span's context when one is active on this thread, else the
    puid-derived ids the OTLP exporter mints) and the response's
    ``cost`` tag when it has one."""
    puid = response.meta.puid or request.meta.puid
    pair = {
        "request": request.to_json(),
        "response": response.to_json(),
        "puid": puid,
        "time": time.time(),
    }
    span = _tracing.current_span()
    if span is not None and not span.remote:
        trace_hex, span_hex = _tracing.w3c_trace_id(span.trace_id), span.span_id
    else:
        trace_hex = _tracing.w3c_trace_id(puid or "")
        span_hex = hashlib.sha256((puid or "").encode()).hexdigest()[32:48]
    pair["traceparent"] = f"00-{trace_hex}-{span_hex}-01"
    cost = response.meta.tags.get("cost")
    if cost:
        pair["cost"] = cost
    return pair


class JsonlPairLogger:
    """Append pairs to a JSON-lines file (thread-safe)."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()

    def __call__(self, request: InternalMessage, response: InternalMessage) -> None:
        pair = build_pair(request, response)
        with self._lock:
            with open(self.path, "a") as f:
                f.write(json.dumps(pair) + "\n")


class HttpPairLogger:
    """Buffered background POST of pairs (CloudEvents headers).

    A full buffer drops (counted in ``dropped``); :meth:`close` is bounded
    as :meth:`KafkaPairLogger.close` is, so a dead endpoint never holds a
    gateway's shutdown: what is still queued at the deadline is dropped
    and counted."""

    def __init__(self, url: str, capacity: int = 1024, timeout_s: float = 2.0):
        self.url = url
        self.timeout_s = timeout_s
        self._queue: "queue.Queue[Optional[Dict]]" = queue.Queue(maxsize=capacity)
        self._stopping = False  # close() sets it; the drain loop checks it
        self._stop_deadline = float("inf")
        self._thread = threading.Thread(target=self._drain, daemon=True, name="seldon-tpu-reqlog")
        self._thread.start()
        self.dropped = 0

    def __call__(self, request: InternalMessage, response: InternalMessage) -> None:
        try:
            self._queue.put_nowait(build_pair(request, response))
        except queue.Full:  # never block the data plane on the logger
            self.dropped += 1

    def _post(self, pair: Dict[str, Any]) -> None:
        headers = dict(CE_HEADERS, **{"CE-Time": str(pair["time"]), "Content-Type": "application/json"})
        req = urllib.request.Request(self.url, data=json.dumps(pair).encode(), headers=headers, method="POST")
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            resp.read()

    def _drain(self) -> None:
        while True:
            try:
                # bounded get: the stop flag is seen even when the None
                # sentinel could not be queued (a full queue at close)
                pair = self._queue.get(timeout=0.25)
            except queue.Empty:
                if self._stopping:
                    return
                continue
            if pair is None:
                return
            if self._stopping and time.monotonic() > self._stop_deadline:
                self.dropped += 1 + _discard(self._queue)  # the pair in hand and the rest
                return
            try:
                self._post(pair)
            except Exception as e:  # noqa: BLE001 — logging loses a pair, never a request
                logger.warning("request logger POST failed: %s", e)

    def close(self, timeout_s: float = 5.0) -> None:
        """Bounded shutdown: pending pairs are posted while the deadline
        allows; never blocks on a full queue or an endpoint that hangs."""
        self._stopping = True
        self._stop_deadline = time.monotonic() + timeout_s
        try:
            self._queue.put_nowait(None)
        except queue.Full:
            pass  # the drain loop's bounded get sees _stopping
        self._thread.join(timeout=timeout_s)


def _discard(q: "queue.Queue[Optional[Dict]]") -> int:
    """Empty ``q`` without blocking; the number of pairs (not sentinels) taken."""
    n = 0
    while True:
        try:
            item = q.get_nowait()
        except queue.Empty:
            return n
        if item is not None:
            n += 1


class KafkaPairLogger:
    """Stream pairs to a Kafka topic (reference analogue: the kafka/
    integration for streaming request logging, reference: kafka/
    kafka.json:1-30 + zookeeper-k8s/).

    Pairs are keyed by puid (one partition a request id) and drained on a
    background thread so the data plane never blocks on the broker; a
    full buffer drops (counted), as :class:`HttpPairLogger` does, and a
    produce the broker loses is counted in ``failed``.
    """

    def __init__(self, bootstrap_servers: str, topic: str = "seldon-request-pairs",
                 capacity: int = 1024, timeout_s: float = 5.0):
        from seldon_core_tpu_torch.utils.kafka import MiniKafkaProducer

        self.topic = topic
        self._producer = MiniKafkaProducer(bootstrap_servers, timeout_s=timeout_s)
        self._queue: "queue.Queue[Optional[Dict]]" = queue.Queue(maxsize=capacity)
        self._stopping = False  # close() sets it; the drain loop checks it
        self._stop_deadline = float("inf")
        self._thread = threading.Thread(target=self._drain, daemon=True, name="seldon-tpu-kafkalog")
        self._thread.start()
        self.dropped = 0  # queue-full drops (the data plane never blocks)
        self.failed = 0  # produce attempts the broker lost (outages)
        self.sent = 0

    def __call__(self, request: InternalMessage, response: InternalMessage) -> None:
        try:
            self._queue.put_nowait(build_pair(request, response))
        except queue.Full:  # never block the data plane on the broker
            self.dropped += 1

    def _drain(self) -> None:
        while True:
            try:
                # bounded get: the stop flag is seen even when the None
                # sentinel could not be queued (a full queue at close)
                pair = self._queue.get(timeout=0.25)
            except queue.Empty:
                if self._stopping:
                    return
                continue
            if pair is None:
                return
            if self._stopping and time.monotonic() > self._stop_deadline:
                # past the close deadline the rest are dropped (counted, the
                # sentinel excluded): shutdown never waits out a stuck broker
                self.dropped += 1 + _discard(self._queue)  # the pair in hand and the rest
                return
            try:
                key = (pair.get("puid") or "").encode() or None
                self._producer.send(self.topic, json.dumps(pair).encode("utf-8"), key=key)
                self.sent += 1
            except Exception as e:  # noqa: BLE001 — counted data loss
                self.failed += 1
                logger.warning("kafka pair logger produce failed: %s", e)

    def close(self, timeout_s: float = 5.0) -> None:
        """Bounded shutdown: pending pairs flush while the deadline
        allows; never blocks on a full queue or a stuck broker."""
        self._stopping = True
        self._stop_deadline = time.monotonic() + timeout_s
        try:
            self._queue.put_nowait(None)
        except queue.Full:
            pass  # the drain loop's bounded get sees _stopping
        self._thread.join(timeout=timeout_s)
        self._producer.close()
